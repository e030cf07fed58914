"""Kernels 7 and 8: the MVSNeRF renderer MLP (``Renderer_ours``) per sample.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/mlp.py``: ``fused_renderer_mlp``
(kernel #7, inputs already positionally encoded) and
``fused_renderer_mlp_rows`` (kernel #8, raw coordinates encoded in the
kernel). The rows layout of #8 exists for TPU tiling; here one CUDA source,
``csrc/renderer_mlp.cu``, serves both with flat (B, N, .) inputs, in two
template instances: 63-wide encoded input, or 3-wide raw coordinates with
10 frequencies encoded in the kernel.

As in JAX, ``compute_dtype`` sets the dense layers' operands: bfloat16 (the
default, as on the TPU) rounds both operands of every dense layer and sums
in float32 on the tensor cores; float32 runs the f32 kernel. Every bias,
nonlinearity and the pts_bias modulation stay in float32.

``params`` maps each name of ``LAYERS`` to its (weight, bias) in
``nn.Linear`` layout (out, in). The kernel takes the published shape only:
width 128, depth 6, a skip after layer 4.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from boostmvsnerfs_torch.ops.cuda import _build
from boostmvsnerfs_torch.ops.cuda._tensor_cores import (
    check_compute_dtype,
    dense,
    packed,
    padded_rows,
)

NAME = "renderer_mlp"
WIDTH, DEPTH, SKIPS, FREQS = 128, 6, (4,), 10
ENC = 3 * (1 + 2 * FREQS)  # 63
LAYERS = ("pts_bias",) + tuple(f"pts_{i}" for i in range(DEPTH)) + (
    "alpha", "feature", "views_0", "rgb")
# packed order: the tiled layers transposed to (in, out), then the two
# narrow heads in (out, in); every segment padded to 4 floats
_TILED = ("pts_bias",) + tuple(f"pts_{i}" for i in range(DEPTH)) + ("feature", "views_0")
_HEADS = ("alpha", "rgb")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_BF16_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^f x_d), cos(2^f x_d)]`` with f-major, d-minor order
    (JAX ``models/mvsnerf.py::positional_encoding``): (..., d*(1+2F))."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    xs = x.repeat(*([1] * (x.dim() - 1)), n_freqs) * freqs.repeat_interleave(x.shape[-1])
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)


def mlp_trunk(params: dict, pts: torch.Tensor, feat: torch.Tensor,
              compute_dtype=torch.float32, additive_bias: bool = False) -> torch.Tensor:
    """The trunk of the renderer heads: ``pts_bias(feat)`` multiplies each
    ``pts_{i}`` layer's output before its ReLU (``Renderer_ours``), or is
    added to it with ``additive_bias`` (``Renderer_linear``, the ``v2`` and
    attention heads; the kernel has only the multiplying trunk). Depth and
    skips are read from the layer shapes: a layer wider than the trunk
    takes the encoding ``pts`` concatenated in front. -> the last hidden
    state (B, N, W[+P])."""

    def layer(x, name):
        return dense(x, *params[name], compute_dtype=compute_dtype)

    bias = layer(feat, "pts_bias")
    h = pts
    depth = sum(k.startswith("pts_") and k != "pts_bias" for k in params)
    for i in range(depth):
        h = layer(h, f"pts_{i}")
        h = F.relu(h + bias if additive_bias else h * bias)
        if params[f"pts_{i + 1}" if i + 1 < depth else "alpha"][0].shape[1] != h.shape[-1]:
            h = torch.cat([pts, h], dim=-1)
    return h


def renderer_mlp_plain(
    params: dict, pts: torch.Tensor, feat: torch.Tensor, dirs: torch.Tensor,
    encode_freqs: int = 0, compute_dtype=torch.float32, additive_bias: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version (the XLA trunk of JAX ``RendererMLP``):
    pts (B, N, P) encoded, or raw (B, N, d) with ``encode_freqs``; feat
    (B, N, F); dirs (B, N, 3) -> raw (rgb, alpha) (B, N, 4). The trunk is
    ``mlp_trunk``'s; ``additive_bias`` selects the ``v2`` trunk, which only
    the plain version has. With bfloat16 every dense layer, the alpha and
    rgb heads included, rounds its two operands."""
    check_compute_dtype(NAME, compute_dtype)

    def layer(x, name):
        return dense(x, *params[name], compute_dtype=compute_dtype)

    if encode_freqs:
        pts = positional_encoding(pts, encode_freqs)
    h = mlp_trunk(params, pts, feat, compute_dtype, additive_bias)
    alpha = F.relu(layer(h, "alpha"))
    feature = layer(h, "feature")
    h = F.relu(layer(torch.cat([feature, dirs], dim=-1), "views_0"))
    rgb = torch.sigmoid(layer(h, "rgb"))
    return torch.cat([rgb, alpha], dim=-1)


def _pad4(t: torch.Tensor) -> list:
    t = t.reshape(-1)
    return [t, t.new_zeros(-t.numel() % 4)]


def _f32_layout(params: dict, rnd) -> tuple[torch.Tensor]:
    parts = []
    for name in _TILED:
        w, b = params[name]
        parts += _pad4(w.t()) + _pad4(b)
    for name in _HEADS:
        w, b = params[name]
        parts += _pad4(w) + _pad4(b)
    return (torch.cat(parts),)


def pack_mlp_weights(params: dict) -> torch.Tensor:
    """The f32 kernel's weight buffer: the tiled layers as (in, out) then
    bias, the alpha and rgb heads as (out, in) then bias, in ``_TILED``
    then ``_HEADS`` order, each segment padded to a multiple of 4 floats."""
    return packed(params, _f32_layout)[0]


def bf16_layers(n_feat: int) -> tuple:
    """The bf16 kernel's weight buffers in order: (layer name, padded input
    width, [((first, end) input columns, their first column in the padded
    row)]). Widths are padded to k16 steps: F to a multiple of 16, 63 -> 64,
    [feature 128, dir 3] -> 144. The skip layer over [enc 63, h 128] is two
    buffers, over enc (64) and over h (128)."""
    skip = f"pts_{DEPTH - 1}"
    return (("pts_bias", 16 * math.ceil(n_feat / 16), [((0, n_feat), 0)]),
            ("pts_0", 64, [((0, ENC), 0)]),
            *((f"pts_{i}", WIDTH, [((0, WIDTH), 0)]) for i in range(1, DEPTH - 1)),
            (skip, 64, [((0, ENC), 0)]),
            (skip, WIDTH, [((ENC, ENC + WIDTH), 0)]),
            ("feature", WIDTH, [((0, WIDTH), 0)]),
            ("views_0", WIDTH + 16, [((0, WIDTH + 3), 0)]))


def _bf16_layout(params: dict, rnd) -> tuple[torch.Tensor, torch.Tensor]:
    mats = [padded_rows(params[name][0], params[name][0].shape[0], k_pad, cols)
            for name, k_pad, cols in bf16_layers(params["pts_bias"][0].shape[1])]
    vecs = [params[name][1].reshape(-1) for name in _TILED]
    for name in _HEADS:
        w, b = params[name]
        vecs += [rnd(w).reshape(-1), b.reshape(-1), b.new_zeros(4 - b.numel())]
    return torch.cat(mats), torch.cat(vecs)


def pack_mlp_weights_bf16(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's two buffers. Matrices: each layer of
    ``bf16_layers`` in ``nn.Linear``'s (out, in) layout, the tensor cores'
    ``col`` B operand, in bf16 rows of the padded input width plus 8 (a
    shared-memory row then starts 4 banks after the one above it), zeros
    in every pad (``padded_rows``). Vectors (float32): the biases of ``_TILED``, the alpha
    head's 128 weights (bf16-rounded) and bias padded to 4, the rgb head's
    3 x 64 weights (bf16-rounded) and 3 biases padded to 4 (csrc/renderer_mlp.cu
    VEC_*)."""
    mats, vecs = packed(params, _bf16_layout)
    return mats.to(torch.bfloat16), vecs


def _check_params(params: dict, n_feat: int) -> None:
    want = {"pts_bias": (WIDTH, n_feat), "alpha": (1, WIDTH), "feature": (WIDTH, WIDTH),
            "views_0": (WIDTH // 2, WIDTH + 3), "rgb": (3, WIDTH // 2)}
    for i in range(DEPTH):
        want[f"pts_{i}"] = (WIDTH, ENC if i == 0 else ENC + WIDTH if i - 1 in SKIPS else WIDTH)
    got = {k: tuple(w.shape) for k, (w, _) in params.items()}
    if got != want:
        raise ValueError(f"{NAME}: the kernel takes the width-{WIDTH}, depth-{DEPTH} MLP with a "
                         f"skip after layer {SKIPS[0]}; layer shapes {got}")


def fused_renderer_mlp(
    params: dict,
    pts: torch.Tensor,  # (B, N, 63) encoded, or (B, N, 3) raw with encode_freqs=10
    feat: torch.Tensor,  # (B, N, F) [volume features, (rgb, in-mask) per view]
    dirs: torch.Tensor,  # (B, N, 3) view directions
    encode_freqs: int = 0,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Raw (rgb, alpha), (B, N, 4), for every sample. On the card
    ``compute_dtype`` picks the kernel: bfloat16 (the default, JAX's) the
    tensor-core kernel, float32 the f32 kernel. CPU tensors take the plain
    version in float32, as the JAX package takes its XLA path off the TPU."""
    check_compute_dtype(NAME, compute_dtype)
    if pts.device.type == "cpu":
        return renderer_mlp_plain(params, pts, feat, dirs, encode_freqs)
    if pts.dim() != 3 or feat.dim() != 3 or tuple(dirs.shape) != (*pts.shape[:2], 3) \
            or feat.shape[:2] != pts.shape[:2]:
        raise ValueError(
            f"{NAME}: expected pts (B,N,P), feat (B,N,F), dirs (B,N,3); got "
            f"{tuple(pts.shape)}, {tuple(feat.shape)}, {tuple(dirs.shape)}"
        )
    pin = pts.shape[-1]
    if (encode_freqs, pin) not in ((0, ENC), (FREQS, 3)):
        raise ValueError(f"{NAME}: takes {ENC}-wide encoded input, or 3-wide raw coordinates "
                         f"with encode_freqs={FREQS}; got width {pin}, encode_freqs={encode_freqs}")
    n_feat = feat.shape[-1]
    if not 0 < n_feat <= WIDTH:
        raise ValueError(f"{NAME}: feature width {n_feat} not in [1, {WIDTH}]")
    max_feat = _build.source_constant(NAME, "MAX_FEAT")
    if compute_dtype == torch.bfloat16 and n_feat > max_feat:
        raise ValueError(f"{NAME}: the bf16 kernel stages feat up to {max_feat} wide in "
                         f"shared memory; got {n_feat} (compute_dtype=torch.float32 takes it)")
    _check_params(params, n_feat)
    dev = pts.device
    B, N = pts.shape[:2]
    if compute_dtype == torch.float32:
        weights = pack_mlp_weights(params)
        _build.check_inputs(NAME, dev, weights=weights, pts=pts, feat=feat, dirs=dirs)
        out = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
        fn = _build.kernel_function(NAME, "renderer_mlp_launch", _ARGTYPES)
        with torch.cuda.device(dev.index):
            rc = fn(weights.data_ptr(), weights.numel(), pts.data_ptr(), feat.data_ptr(),
                    dirs.data_ptr(), out.data_ptr(), B * N, n_feat, pin, _build.stream_ptr(dev))
    else:
        mats, vecs = pack_mlp_weights_bf16(params)
        _build.check_inputs(NAME, dev, vecs=vecs, pts=pts, feat=feat, dirs=dirs)
        _build.check_inputs(NAME, dev, dtype=torch.bfloat16, mats=mats)
        out = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
        fn = _build.kernel_function(NAME, "renderer_mlp_bf16_launch", _BF16_ARGTYPES)
        with torch.cuda.device(dev.index):
            rc = fn(mats.data_ptr(), mats.numel(), vecs.data_ptr(), vecs.numel(),
                    pts.data_ptr(), feat.data_ptr(), dirs.data_ptr(), out.data_ptr(), B * N,
                    n_feat, pin, _build.sm_count(dev), _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
