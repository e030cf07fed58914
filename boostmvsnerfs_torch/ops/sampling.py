"""Resampling: bilinear / trilinear gathers and align-corners resize.

Counterpart of ``boostmvsnerfs_tpu/ops/sampling.py``. Coordinates are in
pixel units with align-corners semantics (pixel centers at 0..size-1); the
samplers gather their taps explicitly instead of normalising to [-1, 1]
for ``F.grid_sample``, whose round trip moves a tap by ~2e-5 px at 184-px
widths.
"""

from __future__ import annotations

import torch


def linspace(start: float, stop: float, num: int, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """``jnp.linspace``, by its formula: ``start * (1 - t) + stop * t`` with
    ``t = i / (num-1)``, endpoint exact. XLA rounds some float32 entries 1-2
    ulps away from this (it folds the constant arithmetic its own way), as
    ``torch.linspace`` does with another formula; the tests allow for it."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - step) + stop * step
    end = torch.full((1,), stop, dtype=dtype, device=device)
    return torch.cat([out, end])


def _batched(img: torch.Tensor, pts: torch.Tensor, rank: int):
    """Add a batch axis to an unbatched (image, points) pair."""
    if img.dim() == rank:
        return img[None], pts[None], False
    return img, pts, True


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows: flat (B, M, C), idx (B, N) -> (B, N, C)."""
    b = torch.arange(flat.shape[0], device=flat.device)[:, None]
    return flat[b, idx]


def bilinear_taps(x: torch.Tensor, y: torch.Tensor, H: int, W: int, padding_mode: str):
    """The four bilinear taps of pixel coordinates ``x``, ``y`` (any shape)
    in an H x W image: (flat indices [00, 01, 10, 11] clamped into the
    image, their weights (0 for a tap outside the image with ``zeros``
    padding), their validity (bool), tx, ty, and whether x and y lie inside
    the clamp range, bounds included).

    ``border`` clamps the coordinates to the image rectangle first;
    ``zeros`` clamps them to [-2, size+1] before ``floor`` (taps that far out
    carry zero weight either way), which keeps the float->int conversion of
    behind-camera projections (~1e10) defined.
    """
    if padding_mode == "border":
        lo_x, hi_x, lo_y, hi_y = 0.0, W - 1, 0.0, H - 1
    elif padding_mode == "zeros":
        lo_x, hi_x, lo_y, hi_y = -2.0, W + 1.0, -2.0, H + 1.0
    else:
        raise ValueError(f"padding_mode {padding_mode!r}")
    in_x, in_y = (x >= lo_x) & (x <= hi_x), (y >= lo_y) & (y <= hi_y)
    x, y = x.clamp(lo_x, hi_x), y.clamp(lo_y, hi_y)
    x0f, y0f = torch.floor(x), torch.floor(y)
    tx, ty = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = x0 + 1, y0 + 1

    w = [(1 - ty) * (1 - tx), (1 - ty) * tx, ty * (1 - tx), ty * tx]
    if padding_mode == "zeros":
        vx0, vx1 = (x0 >= 0) & (x0 <= W - 1), (x1 >= 0) & (x1 <= W - 1)
        vy0, vy1 = (y0 >= 0) & (y0 <= H - 1), (y1 >= 0) & (y1 <= H - 1)
        valid = [vy0 & vx0, vy0 & vx1, vy1 & vx0, vy1 & vx1]
        w = [torch.where(v, wi, 0.0) for v, wi in zip(valid, w)]
    else:
        valid = [torch.ones_like(in_x)] * 4
    x0, x1 = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0, y1 = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    idx = [y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1]
    return idx, w, valid, tx, ty, in_x, in_y


def grid_sample_2d(
    img: torch.Tensor,  # ([B,] H, W, C)
    xy: torch.Tensor,  # ([B,] N, 2) pixel coords (x, y)
    padding_mode: str = "zeros",
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Bilinear sample, ([B,] N, C). ``zeros``: out-of-range taps
    contribute 0; ``border``: coordinates clamped to the image rectangle
    (``bilinear_taps``). With ``compute_dtype`` bfloat16 the map and the
    tap weights are rounded to bf16 first, and the products (exact) and
    their sums stay float32."""
    img, xy, batched = _batched(img, xy, 3)
    B, H, W, C = img.shape
    idx, w, *_ = bilinear_taps(xy[..., 0], xy[..., 1], H, W, padding_mode)
    if compute_dtype != torch.float32:
        img = img.to(compute_dtype).float()
        w = [wi.to(compute_dtype).float() for wi in w]
    flat = img.reshape(B, H * W, C)
    out = (
        _take(flat, idx[0]) * w[0][..., None]
        + _take(flat, idx[1]) * w[1][..., None]
        + _take(flat, idx[2]) * w[2][..., None]
        + _take(flat, idx[3]) * w[3][..., None]
    )
    return out if batched else out[0]


def grid_sample_2d_bwd(
    img: torch.Tensor,  # (B, H, W, C)
    x: torch.Tensor,  # (B, N)
    y: torch.Tensor,  # (B, N)
    g: torch.Tensor,  # (B, N, C) cotangent of grid_sample_2d's output
    padding_mode: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d img, d x, d y) of ``grid_sample_2d``, with the Pallas backward
    kernels' conventions (``ops/pallas/img_sample.py:625-642``): a triangle
    weight max(0, 1 - |j - x|) has derivative sign(j - x) where |j - x| < 1
    and 0 elsewhere, so d x is 0 at an integer x, and a coordinate carries a
    gradient only inside its clamp range, bounds included. (Autodiff of the
    floor-based forward would take a one-sided difference at integers and
    half the gradient at clamp bounds.)"""
    B, H, W, C = img.shape
    idx, w, valid, tx, ty, in_x, in_y = bilinear_taps(x, y, H, W, padding_mode)
    flat = img.reshape(B, H * W, C)
    p00, p01, p10, p11 = (_take(flat, i) * v[..., None] for i, v in zip(idx, valid))
    offset = (torch.arange(B, device=img.device) * (H * W))[:, None]
    d_img = torch.zeros(B * H * W, C, dtype=img.dtype, device=img.device)
    for i, wi in zip(idx, w):
        d_img.index_add_(0, (i + offset).reshape(-1), (g * wi[..., None]).reshape(-1, C))
    gx = torch.sum(g * ((1 - ty)[..., None] * (p01 - p00) + ty[..., None] * (p11 - p10)), -1)
    gy = torch.sum(g * ((1 - tx)[..., None] * (p10 - p00) + tx[..., None] * (p11 - p01)), -1)
    dx = torch.where(in_x & (tx != 0), gx, 0.0)
    dy = torch.where(in_y & (ty != 0), gy, 0.0)
    return d_img.reshape(B, H, W, C), dx, dy


def grid_sample_3d(
    vol: torch.Tensor,  # ([B,] D, H, W, C)
    xyz: torch.Tensor,  # ([B,] N, 3) pixel coords (x->W, y->H, z->D)
    padding_mode: str = "zeros",
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Trilinear sample, ([B,] N, C) (5D ``grid_sample``, align-corners).
    With ``compute_dtype`` bfloat16, ``_grid_sample_3d_bf16``."""
    vol, xyz, batched = _batched(vol, xyz, 4)
    B, D, H, W, C = vol.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if padding_mode == "border":
        x, y, z = x.clamp(0.0, W - 1), y.clamp(0.0, H - 1), z.clamp(0.0, D - 1)
    elif padding_mode == "zeros":
        x = x.clamp(-2.0, W + 1.0)
        y = y.clamp(-2.0, H + 1.0)
        z = z.clamp(-2.0, D + 1.0)
    else:
        raise ValueError(f"padding_mode {padding_mode!r}")
    if compute_dtype != torch.float32:
        out = _grid_sample_3d_bf16(vol, x, y, z, compute_dtype)
        return out if batched else out[0]
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0f, y - y0f, z - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()

    flat = vol.reshape(B, D * H * W, C)
    out = torch.zeros(xyz.shape[:-1] + (C,), dtype=vol.dtype, device=vol.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                w = (
                    (tx if dx else 1 - tx)
                    * (ty if dy else 1 - ty)
                    * (tz if dz else 1 - tz)
                )
                if padding_mode == "zeros":
                    valid = (
                        (xi >= 0) & (xi <= W - 1)
                        & (yi >= 0) & (yi <= H - 1)
                        & (zi >= 0) & (zi <= D - 1)
                    )
                    w = torch.where(valid, w, 0.0)
                xi, yi, zi = xi.clamp(0, W - 1), yi.clamp(0, H - 1), zi.clamp(0, D - 1)
                out = out + _take(flat, (zi * H + yi) * W + xi) * w[..., None]
    return out if batched else out[0]


def _grid_sample_3d_bf16(vol, x, y, z, compute_dtype):
    """The trilinear sample of ``vol`` (B, D, H, W, C) at clamped
    coordinates (B, N) each, at bf16 operands rounded where the Pallas
    kernel rounds (``ops/pallas/tri_sample.py``: an x contraction of the
    bf16 volume against bf16 triangle weights, then a bf16 (y, z)-weighted
    partial per tap row):

        out[c] = sum_{dz, dy} bf16((sum_dx bf16(v[c]) * bf16(wx)) * wy * wz)

    with triangle weights w = max(0, 1 - |tap - coordinate|), wy and wz in
    float32, the products of bf16 values exact in float32, the x sums and
    the (dz, dy) sum (z-major) in float32; taps outside the volume weigh 0.
    """
    B, D, H, W, C = vol.shape

    def taps(c, size):
        """The two taps of coordinates ``c``: (index clamped into the
        volume, triangle weight, inside the volume) for each."""
        c0 = torch.floor(c)
        out = []
        for d in (0, 1):
            i = c0 + d
            w = (1.0 - (i - c).abs()).clamp_min(0.0)
            out.append((i.long().clamp(0, size - 1), w, (i >= 0) & (i <= size - 1)))
        return out

    tx, ty, tz = taps(x, W), taps(y, H), taps(z, D)
    flat = vol.to(compute_dtype).float().reshape(B, D * H * W, C)
    out = torch.zeros(x.shape + (C,), dtype=torch.float32, device=vol.device)
    for zi, wz, vz in tz:
        for yi, wy, vy in ty:
            row = 0.0
            for xi, wx, vx in tx:
                wx = torch.where(vx, wx.to(compute_dtype).float(), 0.0)
                row = row + _take(flat, (zi * H + yi) * W + xi) * wx[..., None]
            term = (row * wy[..., None] * wz[..., None]).to(compute_dtype).float()
            out = out + torch.where((vy & vz)[..., None], term, 0.0)
    return out


def _lerp_taps(n_out: int, n_in: int, device, dtype):
    """Align-corners linear interpolation from n_in to n_out samples: the
    two taps of each output and their triangle weights max(0, 1-|pos-j|),
    in the image's float type (as the JAX resize builds its matrices).
    A 16-bit image takes positions and weights computed in float32, its
    weights then rounded to its type: bf16 holds integers exactly only to
    256, so wider rows would round positions and taps onto each other (and
    the last tap past the row). JAX builds its bf16 matrices in bf16, and
    above 256 pixels their rows sum to up to 3 (ROADMAP fault 14)."""
    calc = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    pos = linspace(0.0, n_in - 1, n_out, device=device, dtype=calc)
    i0 = torch.floor(pos).clamp(0, n_in - 1)
    i1 = i0 + 1
    w0 = (1.0 - (pos - i0).abs()).clamp_min(0.0)
    w1 = (1.0 - (pos - i1).abs()).clamp_min(0.0)
    return i0.long(), i1.clamp(max=n_in - 1).long(), w0.to(dtype), w1.to(dtype)


def _resize_axis(img: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    n_in = img.shape[dim]
    if n_in == 1:
        return torch.repeat_interleave(img, n_out, dim=dim)
    i0, i1, w0, w1 = _lerp_taps(n_out, n_in, img.device, img.dtype)
    shape = [1] * img.dim()
    shape[dim] = n_out
    return (
        img.index_select(dim, i0) * w0.view(shape)
        + img.index_select(dim, i1) * w1.view(shape)
    )


def resize_bilinear(img: torch.Tensor, H_out: int, W_out: int) -> torch.Tensor:
    """Align-corners bilinear resize of (..., H, W, C) to (..., H_out, W_out, C)
    (``F.interpolate(mode='bilinear', align_corners=True)`` semantics), as
    two separable 2-tap lerps: rows first, then columns."""
    H, W = img.shape[-3], img.shape[-2]
    if H == H_out and W == W_out:
        return img
    return _resize_axis(_resize_axis(img, img.dim() - 3, H_out), img.dim() - 2, W_out)


def resize_antialiased(img: torch.Tensor, H_out: int, W_out: int) -> torch.Tensor:
    """Half-pixel bilinear resize of (N, H, W, C) with an antialiasing
    filter when shrinking: ``jax.image.resize(..., "bilinear")``, whose
    default is ``antialias=True``."""
    out = torch.nn.functional.interpolate(img.permute(0, 3, 1, 2), (H_out, W_out),
                                          mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def resize_bilinear_2d(x: torch.Tensor, H_out: int, W_out: int) -> torch.Tensor:
    """Resize a (..., H, W) map (no channel axis)."""
    return resize_bilinear(x[..., None], H_out, W_out)[..., 0]
