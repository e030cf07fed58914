"""The weight gradient of a float32 convolution (CUDA source
``csrc/conv_wgrad.cu``).

No TPU kernel: the JAX package left the convolutions' backward to XLA.
``models/blocks.conv_at`` sends the weight gradient of every float32 network
convolution in training here; the forward and the input's gradient stay
PyTorch's. Convolutions are 2D or 3D, of any kernel size, stride and
symmetric zero padding, with no groups or dilation; a transposed one's
weight gradient is its adjoint's, the strided convolution of the output's
gradient against the input (``transposed``).
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from boostmvsnerfs_torch.ops.cuda import _build

NAME = "conv_wgrad"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 24 + [ctypes.c_void_p]


def _roles(x, g, transposed):
    """(input, output's gradient) of the strided convolution whose weight
    gradient this is: a transposed convolution's swap."""
    return (g, x) if transposed else (x, g)


def conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor, weight_shape, stride, padding,
                     transposed: bool = False) -> torch.Tensor:
    """The plain PyTorch version: per tap, the input's zero-padded window at
    the output's positions against the output's gradient, summed over the
    samples and positions."""
    x, g = _roles(x, g, transposed)
    xp = F.pad(x, [p for p in reversed(padding) for _ in (0, 1)])
    out = g.new_empty(weight_shape)
    for tap in itertools.product(*(range(k) for k in weight_shape[2:])):
        window = xp[(slice(None), slice(None),
                     *(slice(t, t + s * (o - 1) + 1, s)
                       for t, s, o in zip(tap, stride, g.shape[2:])))]
        out[(slice(None), slice(None), *tap)] = torch.einsum(
            "nm...,nc...->mc", g, window)
    return out


def plan(M: int, C: int, taps: int, rows: int, sms: int, row_taps: int = 1) -> dict:
    """The launch's shape: ``tm`` output channels a thread (1 for one, else 4,
    8 or 16; at most the source's ``kRowMaxTm`` where a thread takes
    ``row_taps`` = 3 taps along x), the channels padded to its multiples
    (``cg``) and to 4 (``cx``), and the output rows cut into ``slices`` of
    ``rows_per_slice``, for about ``kSliceThreadsPerSm`` threads on each of
    ``sms`` SMs."""
    tm = 16 if M >= 16 else 8 if M >= 8 else 4 if M > 1 else 1
    if row_taps > 1:
        tm = min(tm, _build.source_constant(NAME, "kRowMaxTm"))
    cg, cx = -(-M // tm) * tm, -(-C // 4) * 4
    combos = cg // tm * (cx // 4) * (taps // row_taps)
    target = _build.source_constant(NAME, "kSliceThreadsPerSm") * sms
    slices = max(1, min(rows, -(-target // combos)))
    rows_per_slice = -(-rows // slices)
    return {"tm": tm, "cg": cg, "cx": cx, "row_taps": row_taps,
            "slices": -(-rows // rows_per_slice), "rows_per_slice": rows_per_slice}


def _channels_last(t: torch.Tensor, channels: int) -> torch.Tensor:
    """(N, C, D, H, W) as a contiguous (N, D, H, W, ``channels``), zeros past C
    (free when ``t`` is already laid out so)."""
    t = t.movedim(1, -1)
    if t.shape[-1] < channels:
        t = F.pad(t, (0, channels - t.shape[-1]))
    return t.contiguous()


def conv_weight_grad(x: torch.Tensor, g: torch.Tensor, weight_shape, stride, padding,
                     transposed: bool = False) -> torch.Tensor:
    """The gradient of the weight (``weight_shape``) of a convolution of ``x``
    (N, C, *S, 2D or 3D) with ``stride`` and ``padding``, for its output's
    gradient ``g``; ``transposed`` for a transposed convolution. CPU tensors
    take the plain version; CUDA ones the kernel, float32 only."""
    weight_shape = tuple(weight_shape)
    dims = len(weight_shape) - 2
    if x.dim() != dims + 2 or g.dim() != dims + 2 or dims not in (2, 3):
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, g {tuple(g.shape)} and weight "
                         f"{weight_shape} are not one 2D or 3D convolution")
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, g, weight_shape, stride, padding, transposed)
    xi, gi = _roles(x, g, transposed)
    M, C = weight_shape[:2]
    if gi.shape[1] != M or xi.shape[1] != C or xi.shape[0] != gi.shape[0]:
        raise ValueError(f"{NAME}: x {tuple(x.shape)} and g {tuple(g.shape)} do not fit "
                         f"weight {weight_shape} (transposed={transposed})")
    if dims == 2:  # depth 1
        xi, gi = xi.unsqueeze(2), gi.unsqueeze(2)
        weight_shape3 = (M, C, 1, *weight_shape[2:])
        stride, padding = (1, *stride), (0, *padding)
    else:
        weight_shape3 = weight_shape
    dev = x.device
    N, _, Di, Hi, Wi = xi.shape
    Do, Ho, Wo = gi.shape[2:]
    taps = math.prod(weight_shape3[2:])
    # three taps along x in one thread (csrc/conv_wgrad.cu: conv_wgrad_kernel_row3)
    row_taps = 3 if weight_shape3[-1] == 3 and padding[-1] == 1 and stride[-1] in (1, 2) else 1
    p = plan(M, C, taps, N * Do * Ho, _build.sm_count(dev), row_taps)
    xc, gc = _channels_last(xi, p["cx"]), _channels_last(gi, p["cg"])
    _build.check_inputs(NAME, dev, x=xc, g=gc)
    part = torch.empty(p["slices"] * p["cg"] * p["cx"] * taps, dtype=torch.float32, device=dev)
    out = torch.empty(weight_shape3, dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "conv_wgrad_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(xc.data_ptr(), gc.data_ptr(), part.data_ptr(), out.data_ptr(), N, Di, Hi, Wi,
                p["cx"], Do, Ho, Wo, p["cg"], *weight_shape3[2:], *stride, *padding, M, C,
                p["tm"], p["row_taps"], p["slices"], p["rows_per_slice"], _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out.reshape(weight_shape)
