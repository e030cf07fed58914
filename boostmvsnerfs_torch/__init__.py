"""PyTorch/CUDA build of BoostMVSNeRFs.

The eval render of BoostENeRF (ENeRF backbone, K fused cost volumes) in
PyTorch, with hand-written CUDA kernels for its three hot loops
(``ops/cuda``). Public functions keep the JAX package's layouts (NHWC /
NDHWC) and batch keys, so one numpy batch feeds both builds.
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
