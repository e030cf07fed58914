"""PyTorch/CUDA build of BoostMVSNeRFs.

BoostENeRF and BoostMVSNeRF (ENeRF / MVSNeRF backbones, K fused cost
volumes) in PyTorch, with hand-written CUDA kernels for their hot loops
(``ops/cuda``), the view selection, the datasets and the eval entry
(``python -m boostmvsnerfs_torch.run``). Public functions keep the JAX
package's layouts (NHWC / NDHWC) and batch keys, so one numpy batch feeds
both builds.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "boostmvsnerfs_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def set_numerics() -> None:
    """The numerics of the port's entry points: strict float32 for cuDNN
    convolutions and CUDA matmuls (TF32 off; PyTorch leaves it on for
    convolutions). ``chip_smoke.py`` checks the card against the CPU under
    this setting, and ``run.py`` runs under it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
