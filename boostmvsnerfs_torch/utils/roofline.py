"""Work and least times on the card: the kernels' bytes and operations, and
a frame's (counterpart of ``boostmvsnerfs_tpu/utils/roofline.py``, in the
port's formulation).

* **The card's peaks** (``peaks``, ``CARD_PEAKS``): NVIDIA's published
  figures for the card the port is built for, the NVIDIA H100 80GB HBM3
  (SXM) at its 700.00 W power limit: 3.35 TB/s of HBM, 989 TFLOP/s of bf16
  on the tensor cores (dense), 67 TFLOP/s of f32 outside them. A card set
  below 700 W runs slower under load than these peaks assume.
* **A kernel's work** on its inputs (``warp_work``, ``sample_work``,
  ``head_work``, ``tri_work``, ``mlp_work`` and the backward kernels'):
  bytes (each input read once, each output written once), f32 operations
  and, for the bf16 kernels, the dense layers' operations on the tensor
  cores. Where the work depends on the data, it counts what these inputs
  need: the warps' taps inside the source image (``live_tap_share``), the
  samplers' map pixels and voxels that their taps touch
  (``touched_pixels``, ``touched_voxels``). The shape-level ``*_counts``
  take those as numbers. ``bound`` turns
  work into the least time the card could take.
* **A frame's work** (``flagship_render_costs``, ``mvsnerf_render_costs``):
  per rendered target view, by stage, of the BoostENeRF and BoostMVSNeRF
  eval frames as the port runs them. JAX counts the TPU's window matmuls
  for the plane-sweep warp and the row sampler; the port gathers directly,
  so it counts the gathers' bytes and taps (every tap live, every map pixel
  and voxel touched: a frame's count without its data). The networks' FLOPs (FPN,
  the cost-regularisation U-Nets, the ENeRF head) are JAX's; the renderer
  MLP counts the port's layers (its view branch is 64 wide, JAX's count
  takes 128). Elementwise work (projections, depth regression,
  compositing) is left out, so a frame's bound is a lower bound.
  ``speed_of_light`` / ``mvsnerf_speed_of_light`` give a measured frame's
  MFU and bound share.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's peak rates: HBM bytes/s, f32 FLOP/s outside the tensor
    cores, bf16 FLOP/s on the tensor cores (dense)."""

    hbm_bytes_per_s: float
    f32_flops: float
    bf16_tc_flops: float


# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
H100 = Peaks(hbm_bytes_per_s=3.35e12, f32_flops=67e12, bf16_tc_flops=989e12)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": H100}


def peaks(given: Peaks | None = None, device=None) -> Peaks:
    """``given``, or the peaks of the CUDA card ``device`` (the current one
    by default) from ``CARD_PEAKS``; raises on a card it has no figures
    for."""
    if given is not None:
        return given
    import torch

    name = torch.cuda.get_device_name(device)
    if name not in CARD_PEAKS:
        raise ValueError(f"no peak figures for {name!r} (known: {sorted(CARD_PEAKS)}); "
                         "pass its Peaks")
    return CARD_PEAKS[name]


def bound(nbytes: float, ops: float, tc_ops: float = 0.0, card: Peaks = H100) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate,
    or f32 operations over the f32 rate plus bf16 tensor-core operations
    over the tensor cores' rate, whichever is larger; and which one it is
    ("bytes" or "operations")."""
    t_bytes = nbytes / card.hbm_bytes_per_s
    t_ops = ops / card.f32_flops + tc_ops / card.bf16_tc_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- kernels


def live_tap_share(feats, pm, dv) -> float:
    """The share of the plane-sweep warp's bilinear taps (4 per voxel and
    view) that land inside the source image, from the voxels' coordinates
    as the kernels compute them."""
    import torch

    from boostmvsnerfs_torch.ops import cost_volume

    Hs, Ws = feats.shape[2:4]
    live = 0
    for s in range(feats.shape[1]):
        x, y = cost_volume.warp_coords(pm[:, s], dv)
        x0, y0 = torch.floor(x.clamp(-2.0, Ws + 1.0)), torch.floor(y.clamp(-2.0, Hs + 1.0))
        in_x = [(x0 + d >= 0) & (x0 + d <= Ws - 1) for d in (0, 1)]
        in_y = [(y0 + d >= 0) & (y0 + d <= Hs - 1) for d in (0, 1)]
        live += sum(int((a & b).sum()) for a in in_x for b in in_y)
    return live / (4 * feats.shape[1] * dv.numel())


def warp_counts(n_feats: int, n_pm: int, n: int, S: int, C: int, live: float = 1.0):
    """The warp's (#1) work over ``n`` voxels of ``S`` views of ``C``
    channels: per voxel and view the projection, 4 taps x C multiply-adds
    (``live`` of them inside the image) and the sums of w and w^2; per voxel
    the variance. Reads the f32 features (the bf16 instance rounds them as
    it loads them), the matrices and the depths; writes the C-channel
    variance."""
    return 4 * (n_feats + n_pm + n + n * C), n * (S * (35 + 3 * C) + 4 * C) + live * n * S * 8 * C


def warp_work(feats, pm, dv, compute_dtype=None):
    """``warp_counts`` on the warp's inputs, either instance."""
    B, S, Hs, Ws, C = feats.shape
    return warp_counts(feats.numel(), pm.numel(), dv.numel(), S, C, live_tap_share(feats, pm, dv))


def warp_bwd_counts(n_feats: int, n_pm: int, n: int, S: int, C: int, live: float = 1.0):
    """The warp backward's (#2) work: reads the features, matrices, depths
    and cotangent, writes d feats and d depth; per voxel and view the
    projection, the per-view cotangent and the coordinate derivatives, and
    per live tap the loads for the mean and for the cotangent and the
    scatter (3 x 8 C operations)."""
    return (4 * (2 * n_feats + n_pm + 2 * n + n * C),
            n * S * (80 + 21 * C) + live * n * S * 24 * C)


def warp_bwd_work(feats, pm, dv, g):
    B, S, Hs, Ws, C = feats.shape
    return warp_bwd_counts(feats.numel(), pm.numel(), dv.numel(), S, C,
                           live_tap_share(feats, pm, dv))


def touched_pixels(imgs, x, y, padding_mode="border") -> int:
    """The distinct in-image pixels among the four bilinear taps of every
    sample, from the coordinates as the sampler kernels clamp them: the map
    pixels a sampler has to read (at most all of them). A ray block of the
    fine-tuning step samples a band of each map, not the whole map."""
    import torch

    V, H, W = imgs.shape[:3]
    lo, hi_x, hi_y = (0.0, W - 1, H - 1) if padding_mode == "border" else (-2.0, W + 1, H + 1)
    x0 = torch.floor(x.clamp(lo, hi_x)).long()
    y0 = torch.floor(y.clamp(lo, hi_y)).long()
    view = torch.arange(V, device=x.device)[:, None] * (H * W)
    hit = torch.zeros(V * H * W, dtype=torch.bool, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            hit[(view + yi * W + xi)[inside]] = True
    return int(hit.sum())


def sample_counts(touched: int, n: int, C: int):
    """The row sampler's (#3) work on ``n`` samples of ``C`` channels: reads
    the ``touched`` map pixels and the coordinates, writes the samples; per
    sample the taps, per channel four products and three sums."""
    return 4 * (touched * C + 2 * n + n * C), n * (20 + 7 * C)


def sample_work(imgs, x, y, padding_mode="border"):
    return sample_counts(touched_pixels(imgs, x, y, padding_mode), x.numel(), imgs.shape[-1])


def sample_bwd_counts(touched: int, n_imgs: int, n: int, C: int):
    """The sampler backward's (#4) work: reads the ``touched`` map pixels,
    the coordinates and the cotangent, writes the whole of d imgs
    (``n_imgs`` values, zero-filled, then scattered into), d x and d y; per
    sample and channel four scattered products and the two derivatives."""
    return 4 * (touched * C + n_imgs + 4 * n + n * C), n * (20 + 18 * C)


def sample_bwd_work(imgs, x, y, g, padding_mode="border"):
    return sample_bwd_counts(touched_pixels(imgs, x, y, padding_mode), imgs.numel(), x.numel(),
                             imgs.shape[-1])


def head_macs(S: int, C: int, L: int = 24) -> int:
    """The ENeRF head's dense multiply-adds per sample over ``S`` views of
    ``C`` channels; ``L`` lr0's input width ([vox 8, agg 16], or [agg 16]
    without voxel features)."""
    return (S * C * 4 + 2 * 32 * C + S * 32 * C + S * 32 + 16 * 32 + 64 * L + 64
            + 64 * (64 + L) + S * 64 * (C + 4) + S * 64)


def nerf_head_flops(N: int, Ns: int, S: int, C: int, L: int = 24) -> int:
    """The head's FLOPs over ``N`` rays of ``Ns`` samples (JAX's
    ``nerf_head_flops``)."""
    return N * Ns * 2 * head_macs(S, C, L)


def head_work(params, vox, feat, dirs):
    """The head's (#5) dense layers' multiply-adds per sample, all on bf16
    tensor cores (the kernel's one contract); lr0 and color0's per-sample
    part over [vox 8, agg 16], or [agg 16] for the image-feature-only head
    (no voxel features read)."""
    B, S, P, C = feat.shape
    n_weights = sum(w.numel() + b.numel() for w, b in params.values())
    n_vox = 0 if vox is None else vox.numel()
    nbytes = 4 * (n_vox + feat.numel() + dirs.numel() + 4 * B * P + n_weights)
    return nbytes, 0.0, nerf_head_flops(B * P, 1, S, C, params["lr0"][0].shape[1])


def touched_voxels(vol, xyz) -> int:
    """The distinct in-volume voxels among the eight trilinear taps of every
    sample (zeros padding: a tap outside reads nothing), from the
    coordinates (B, P, 3) as the volume sampler clamps them: the voxels it
    has to read. A ray block samples a slab of the volume, not all of it."""
    import torch

    B, D, H, W = vol.shape[:4]
    x, y, z = (torch.floor(xyz[..., i].clamp(-2.0, n + 1.0)).long()
               for i, n in enumerate((W, H, D)))
    base = torch.arange(B, device=xyz.device)[:, None] * (D * H * W)
    hit = torch.zeros(B * D * H * W, dtype=torch.bool, device=xyz.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x + dx, y + dy, z + dz
                inside = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                          & (zi >= 0) & (zi <= D - 1))
                hit[(base + (zi * H + yi) * W + xi)[inside]] = True
    return int(hit.sum())


def tri_counts(touched: int, n: int, C: int):
    """The volume sampler's (#6) work on ``n`` samples of ``C`` channels:
    reads the ``touched`` voxels and the coordinates (both instances read
    the f32 volume; the bf16 one rounds it), writes the samples; per sample
    the 8 tap weights and the taps' products and sums."""
    return 4 * (touched * C + 3 * n + n * C), n * (8 * (2 + 2 * C) + 12)


def tri_work(vol, xyz, *_):
    return tri_counts(touched_voxels(vol, xyz), xyz.numel() // 3, vol.shape[-1])


def mlp_work(params, pts, feat, dirs, encode_freqs=0, compute_dtype=None):
    """The renderer MLP's (#7/#8) multiply-adds of every layer (the weights'
    size) per sample, on the tensor cores at bf16 (the default) and as f32
    operations at f32, plus the sines and cosines of an in-kernel encoding
    (f32)."""
    import torch

    n = pts.shape[0] * pts.shape[1]
    macs = sum(w.numel() for w, _ in params.values())
    n_weights = sum(w.numel() + b.numel() for w, b in params.values())
    nbytes = 4 * (pts.numel() + feat.numel() + dirs.numel() + 4 * n + n_weights)
    dense_ops, enc_ops = n * 2 * macs, n * 2 * 3 * encode_freqs
    if compute_dtype in (None, torch.bfloat16):
        return nbytes, enc_ops, dense_ops
    return nbytes, enc_ops + dense_ops, 0.0


# ---------------------------------------------------------------- frames


def _conv2d(h, w, cin, cout, k):
    return 2 * h * w * cin * cout * k * k


def _conv3d(d, h, w, cin, cout, k=3):
    return 2 * d * h * w * cin * cout * k ** 3


def fpn_flops(H, W, n_views):
    """FeatureNet (models/feature_net.py): 6 conv stages + FPN merges."""
    f = 0
    f += _conv2d(H, W, 3, 8, 3) + _conv2d(H, W, 8, 8, 3)
    f += _conv2d(H // 2, W // 2, 8, 16, 5) + _conv2d(H // 2, W // 2, 16, 16, 3)
    f += _conv2d(H // 4, W // 4, 16, 32, 5) + _conv2d(H // 4, W // 4, 32, 32, 3)
    f += _conv2d(H // 4, W // 4, 32, 32, 1)  # toplayer
    f += _conv2d(H // 2, W // 2, 16, 32, 1) + _conv2d(H, W, 8, 32, 1)  # lats
    f += _conv2d(H // 2, W // 2, 32, 16, 3) + _conv2d(H, W, 32, 8, 3)  # smooth
    return n_views * f


def costreg_flops(D, Hv, Wv, cin, deep: bool):
    """MinCostRegNet (deep=False) / CostRegNet (models/cost_reg_net.py)."""
    f = _conv3d(D, Hv, Wv, cin, 8)
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 8, 16)
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 16, 16)
    f += _conv3d(D // 4, Hv // 4, Wv // 4, 16, 32)
    f += _conv3d(D // 4, Hv // 4, Wv // 4, 32, 32)
    if deep:
        f += _conv3d(D // 8, Hv // 8, Wv // 8, 32, 64) * 2
        f += _conv3d(D // 4, Hv // 4, Wv // 4, 64, 32)  # deconv to /4
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 32, 16)
    f += _conv3d(D, Hv, Wv, 16, 8)
    f += _conv3d(D, Hv, Wv, 8, 8) + _conv3d(D, Hv, Wv, 8, 1)
    return f


@dataclasses.dataclass
class Roofline:
    """One stage's work: f32 FLOPs (``flops``), HBM bytes and bf16
    tensor-core FLOPs (``tc_flops``)."""

    flops: float
    bytes: float
    tc_flops: float = 0.0

    @property
    def intensity(self):
        return (self.flops + self.tc_flops) / max(self.bytes, 1)

    def bound(self, card: Peaks = H100) -> tuple[float, str]:
        """``bound`` of this work: (ms, "bytes" or "operations")."""
        return bound(self.bytes, self.flops, self.tc_flops, card)


def _total(stages: dict) -> dict:
    stages["total"] = Roofline(*(sum(getattr(s, f) for s in stages.values())
                                 for f in ("flops", "bytes", "tc_flops")))
    return stages


def _head_roofline(k, n_rays, Ns, S, C, L=24):
    """The head (#5) over ``k`` volumes' ``n_rays`` rays of ``Ns`` samples:
    voxel features, view features and directions read, raw written."""
    P = n_rays * Ns
    return Roofline(0.0, k * 4.0 * P * (8 + S * C + S * 4 + 4),
                    k * nerf_head_flops(n_rays, Ns, S, C, L))


def _sample_roofline(V, H, W, C, n_per_map):
    """The row sampler (#3) over ``V`` maps of (H, W, C), every pixel
    touched."""
    nbytes, ops = sample_counts(V * H * W, V * n_per_map, C)
    return Roofline(ops, nbytes)


def flagship_render_costs(H, W, n_views=6, k_best=4, s_cv=3, cas=None):
    """Per-view FLOPs/bytes of the BoostENeRF eval frame as the port runs it
    (bench.py's workload at ``cas``, by default ``CascadeConfig(k_best=
    k_best)``). Returns {stage: Roofline} plus a 'total'."""
    if cas is None:
        from boostmvsnerfs_torch.models.enerf import CascadeConfig

        cas = CascadeConfig(k_best=k_best)
    k, S = k_best, s_cv
    stages = {"fpn": Roofline(fpn_flops(H, W, n_views),
                              n_views * H * W * (3 + 8 + 32 // 4 + 16 // 2) * 4.0)}
    D0, D1 = cas.volume_planes
    Hv0, Wv0 = int(H * cas.volume_scale[0]), int(W * cas.volume_scale[0])
    Hv1, Wv1 = int(H * cas.volume_scale[1]), int(W * cas.volume_scale[1])
    for level, (D, Hv, Wv, hs, ws, C) in enumerate(((D0, Hv0, Wv0, H // 4, W // 4, 32),
                                                    (D1, Hv1, Wv1, H // 2, W // 2, 16))):
        nbytes, ops = warp_counts(k * S * hs * ws * C, k * S * 12, k * D * Hv * Wv, S, C)
        stages[f"warp{level}"] = Roofline(ops, nbytes)
        stages[f"costreg{level}"] = Roofline(
            k * costreg_flops(D, Hv, Wv, C, deep=level == 1),
            k * D * Hv * Wv * (C + 8 + 8 + 1) * 4.0 * 2)
    # the rendered levels only (the eval recipe renders level 1 alone:
    # configs/exps/evaluate/enerf/base_eval.yaml)
    for level, (h, w, C) in enumerate(((H // 4, W // 4, 32 + 3), (H, W, 8 + 3))):
        if not cas.render_if[level]:
            continue
        Ns = cas.num_samples[level]
        stages[f"sample{level}"] = _sample_roofline(k * S, h, w, C, h * w * Ns)
        stages[f"nerf{level}"] = _head_roofline(k, h * w, Ns, S, C)
    return _total(stages)


def frame_speed_of_light(costs: Roofline, seconds: float, card: Peaks = H100) -> dict:
    """A frame's MFU (the least time of its operations, over ``seconds``),
    its bound (ms, and what bounds it) and the bound's share of
    ``seconds``."""
    t_ops = costs.flops / card.f32_flops + costs.tc_flops / card.bf16_tc_flops
    bms, by = costs.bound(card)
    return {"mfu": t_ops / seconds, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / 1e3 / seconds,
            "gflops_per_view": (costs.flops + costs.tc_flops) / 1e9,
            "gbytes_per_view": costs.bytes / 1e9}


def speed_of_light(H, W, seconds, card: Peaks | None = None, **kw):
    """MFU and bound share of one BoostENeRF frame of ``seconds``
    (``flagship_render_costs(H, W, **kw)``) on ``card`` (the current card's
    ``peaks`` by default)."""
    return frame_speed_of_light(flagship_render_costs(H, W, **kw)["total"], seconds, peaks(card))


def mvsnerf_mlp_macs(width=128, depth=6, n_feat=20, enc=63):
    """The v0 renderer MLP's multiply-adds per sample: ``depth`` trunk
    layers (the skip after layer 4 re-reads the encoding), pts_bias over the
    features, alpha, feature, the 64-wide view branch and rgb."""
    trunk = enc * width + (depth - 1) * width * width + enc * width
    return (trunk + n_feat * width + width + width * width
            + (width + 3) * (width // 2) + (width // 2) * 3)


def mvsnerf_render_costs(H, W, k_best=4, s_cv=3, D=32, pad=24, mlp_width=128, mlp_depth=6,
                         n_views=6, pos_freqs=10):
    """Per-view FLOPs/bytes of the BoostMVSNeRF eval frame as the port runs
    it (reference protocol: one padded cost volume of D planes per selected
    combination, D samples per ray, the ``v0`` head; reference
    lib/networks/mvsnerf/network.py). Returns {stage: Roofline} plus a
    'total'."""
    h, w = H // 4, W // 4
    hp, wp = h + 2 * pad, w + 2 * pad
    k = k_best
    stages = {}
    # feature net over all source views: 8 conv blocks 3->8->16->32 + toplayer
    f = _conv2d(H, W, 3, 8, 3) + _conv2d(H, W, 8, 8, 3)
    f += _conv2d(H // 2, W // 2, 8, 16, 5) + 2 * _conv2d(H // 2, W // 2, 16, 16, 3)
    f += _conv2d(h, w, 16, 32, 5) + 2 * _conv2d(h, w, 32, 32, 3)
    f += _conv2d(h, w, 32, 32, 1)
    stages["features"] = Roofline(n_views * f, n_views * (H * W * 3 + h * w * 32) * 4.0)
    # the plain plane-sweep warp (grid_sample gathers): per voxel and warped
    # view the projection and 4 taps of 32 features + 3 colours; the
    # volume's 9 + 32 channels written
    n_vox = D * hp * wp
    stages["warp"] = Roofline(k * (s_cv - 1) * n_vox * (20 + 8 * (32 + 3)),
                              k * (s_cv * h * w * (32 + 3) + n_vox * (9 + 32)) * 4.0)
    # 3D U-Net 41ch -> 8ch over (D, hp, wp)
    cr = _conv3d(D, hp, wp, 41, 8)
    cr += 2 * _conv3d(D // 2, hp // 2, wp // 2, 8, 16)
    cr += 2 * _conv3d(D // 4, hp // 4, wp // 4, 16, 32)
    cr += 2 * _conv3d(D // 8, hp // 8, wp // 8, 32, 64)
    cr += _conv3d(D // 4, hp // 4, wp // 4, 64, 32)
    cr += _conv3d(D // 2, hp // 2, wp // 2, 32, 16)
    cr += _conv3d(D, hp, wp, 16, 8)
    stages["costreg"] = Roofline(k * cr, k * n_vox * (41 + 8) * 4.0 * 2)
    n_pts = H * W * D
    # the volume lookup (#6, every voxel touched) and the colour lookup (#3,
    # every pixel touched)
    nbytes, ops = tri_counts(k * n_vox, k * n_pts, 8)
    stages["tri_sample"] = Roofline(ops, nbytes)
    stages["img_sample"] = _sample_roofline(k * s_cv, H, W, 3, n_pts)
    # the renderer MLP (#8): raw coordinates encoded in the kernel (f32),
    # the dense layers on the tensor cores; xyz, features, dirs in, raw out
    n_feat = 8 + 4 * s_cv
    macs = mvsnerf_mlp_macs(mlp_width, mlp_depth, n_feat, 3 + 6 * pos_freqs)
    stages["mlp"] = Roofline(k * n_pts * 2 * 3 * pos_freqs,
                             k * n_pts * (3 + n_feat + 3 + 4) * 4.0, k * n_pts * 2 * macs)
    return _total(stages)


def mvsnerf_speed_of_light(H, W, seconds, card: Peaks | None = None, **kw):
    """MFU and bound share of one BoostMVSNeRF frame of ``seconds``
    (``mvsnerf_render_costs(H, W, **kw)``) on ``card``."""
    return frame_speed_of_light(mvsnerf_render_costs(H, W, **kw)["total"], seconds, peaks(card))
