"""Kernels 7 and 8: the MVSNeRF renderer MLP (``Renderer_ours``) per sample.

Counterpart of ``boostmvsnerfs_tpu/ops/pallas/mlp.py``: ``fused_renderer_mlp``
(kernel #7, inputs already positionally encoded) and
``fused_renderer_mlp_rows`` (kernel #8, raw coordinates encoded in the
kernel). The rows layout of #8 exists for TPU tiling; here one CUDA kernel,
``csrc/renderer_mlp.cu``, serves both with flat (B, N, .) inputs, in two
template instances: 63-wide encoded input, or 3-wide raw coordinates with
10 frequencies encoded in the kernel.

``params`` maps each name of ``LAYERS`` to its (weight, bias) in
``nn.Linear`` layout (out, in). The kernel takes the published shape only:
width 128, depth 6, a skip after layer 4.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from boostmvsnerfs_torch.ops.cuda import _build

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


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^f x_d), cos(2^f x_d)]`` with f-major, d-minor order
    (JAX ``models/mvsnerf.py::positional_encoding``): (..., d*(1+2F))."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    xs = x.repeat(*([1] * (x.dim() - 1)), n_freqs) * freqs.repeat_interleave(x.shape[-1])
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)


def renderer_mlp_plain(
    params: dict, pts: torch.Tensor, feat: torch.Tensor, dirs: torch.Tensor,
    encode_freqs: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version (the XLA trunk of JAX ``RendererMLP``):
    pts (B, N, P) encoded, or raw (B, N, d) with ``encode_freqs``; feat
    (B, N, F); dirs (B, N, 3) -> raw (rgb, alpha) (B, N, 4). Depth and
    skips are read from the layer shapes: a layer wider than the trunk
    takes the encoding concatenated in front."""
    if encode_freqs:
        pts = positional_encoding(pts, encode_freqs)
    bias = F.linear(feat, *params["pts_bias"])
    h = pts
    depth = sum(k.startswith("pts_") and k != "pts_bias" for k in params)
    for i in range(depth):
        h = F.relu(F.linear(h, *params[f"pts_{i}"]) * bias)
        if params[f"pts_{i + 1}" if i + 1 < depth else "alpha"][0].shape[1] != h.shape[-1]:
            h = torch.cat([pts, h], dim=-1)
    alpha = F.relu(F.linear(h, *params["alpha"]))
    feature = F.linear(h, *params["feature"])
    h = F.relu(F.linear(torch.cat([feature, dirs], dim=-1), *params["views_0"]))
    rgb = torch.sigmoid(F.linear(h, *params["rgb"]))
    return torch.cat([rgb, alpha], dim=-1)


def _pad4(t: torch.Tensor) -> list:
    t = t.reshape(-1)
    return [t, t.new_zeros(-t.numel() % 4)]


def pack_mlp_weights(params: dict) -> torch.Tensor:
    """The kernel's weight buffer: the tiled layers as (in, out) then bias,
    the alpha and rgb heads as (out, in) then bias, in ``_TILED`` then
    ``_HEADS`` order, each segment padded to a multiple of 4 floats."""
    parts = []
    for name in _TILED:
        w, b = params[name]
        parts += _pad4(w.t()) + _pad4(b)
    for name in _HEADS:
        w, b = params[name]
        parts += _pad4(w) + _pad4(b)
    return torch.cat(parts).float().contiguous()


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
) -> torch.Tensor:
    """Raw (rgb, alpha), (B, N, 4), for every sample. CPU tensors take the
    plain version."""
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
    _check_params(params, n_feat)
    dev = pts.device
    weights = pack_mlp_weights(params)
    _build.check_inputs(NAME, dev, weights=weights, pts=pts, feat=feat, dirs=dirs)
    B, N = pts.shape[:2]
    out = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    fn = _build.kernel_function(NAME, "renderer_mlp_launch", _ARGTYPES)
    with torch.cuda.device(dev.index):
        rc = fn(weights.data_ptr(), weights.numel(), pts.data_ptr(), feat.data_ptr(),
                dirs.data_ptr(), out.data_ptr(), B * N, n_feat, pin, _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
