"""Hand-written CUDA kernels (counterpart of ``boostmvsnerfs_tpu/ops/pallas``).

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
launches its kernel (or raises) for tensors on a CUDA device.
"""

from boostmvsnerfs_torch.ops.cuda._build import (  # noqa: F401
    KERNELS,
    build,
    launch_counts,
    reset_launch_counts,
)
