"""The yardstick of work: the card's peaks and a frame's counted work by
stage, a frozen copy of the port's ``utils/roofline.py`` as it stands.

* **The card's peaks** (``CARD_PEAKS``): NVIDIA's data-sheet figures for the
  NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: 3.35 TB/s of HBM,
  989 TFLOP/s of bf16 on the tensor cores (dense), 67 TFLOP/s of f32
  outside them. A card set below 700 W runs slower under load.
* **A frame's work** (``flagship_render_costs``, ``mvsnerf_render_costs``):
  per rendered target view, by stage, of the BoostENeRF and BoostMVSNeRF
  eval frames as the port runs them: the networks' FLOPs (FPN, the cost
  U-Nets, the heads), the gathers' bytes and taps with every tap live and
  every map pixel and voxel touched. Elementwise work (projections, depth
  regression, compositing) is left out, so a frame's bound is a lower bound.
  The renderer MLP counts the port's layers (its view branch is 64 wide).
* ``bound`` turns work into the least time the card could take, and
  ``frame_speed_of_light`` a frame's measured time into its MFU.
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


H100 = Peaks(hbm_bytes_per_s=3.35e12, f32_flops=67e12, bf16_tc_flops=989e12)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": H100}


def peaks(name: str) -> Peaks:
    """The peaks of the card named ``name``; raises on a card without
    figures here."""
    if name not in CARD_PEAKS:
        raise ValueError(f"no peak figures for {name!r} (known: {sorted(CARD_PEAKS)})")
    return CARD_PEAKS[name]


def bound(nbytes: float, ops: float, tc_ops: float = 0.0, card: Peaks = H100) -> tuple[float, str]:
    """The least time (ms): bytes over the memory rate, or f32 operations
    over the f32 rate plus bf16 tensor-core operations over theirs,
    whichever is larger; and which one ("bytes" or "operations")."""
    t_bytes = nbytes / card.hbm_bytes_per_s
    t_ops = ops / card.f32_flops + tc_ops / card.bf16_tc_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@dataclasses.dataclass
class Roofline:
    """One stage's work: f32 FLOPs, HBM bytes and bf16 tensor-core FLOPs."""

    flops: float
    bytes: float
    tc_flops: float = 0.0

    def bound(self, card: Peaks = H100) -> tuple[float, str]:
        return bound(self.bytes, self.flops, self.tc_flops, card)


def _total(stages: dict) -> dict:
    stages["total"] = Roofline(*(sum(getattr(s, f) for s in stages.values())
                                 for f in ("flops", "bytes", "tc_flops")))
    return stages


def frame_speed_of_light(costs: Roofline, seconds: float, card: Peaks = H100) -> dict:
    """A frame's MFU (the least time of its operations over ``seconds``),
    its bound (ms, and what bounds it) and the bound's share of ``seconds``."""
    t_ops = costs.flops / card.f32_flops + costs.tc_flops / card.bf16_tc_flops
    bms, by = costs.bound(card)
    return {"mfu": t_ops / seconds, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / 1e3 / seconds}


# ---------------------------------------------------------------- counts


def warp_counts(n_feats: int, n_pm: int, n: int, S: int, C: int, live: float = 1.0):
    """The plane-sweep warp's (#1) bytes and f32 operations over ``n``
    voxels of ``S`` views of ``C`` channels."""
    return 4 * (n_feats + n_pm + n + n * C), n * (S * (35 + 3 * C) + 4 * C) + live * n * S * 8 * C


def sample_counts(touched: int, n: int, C: int):
    """The row sampler's (#3) bytes and operations on ``n`` samples of ``C``
    channels over ``touched`` map pixels."""
    return 4 * (touched * C + 2 * n + n * C), n * (20 + 7 * C)


def head_macs(S: int, C: int, L: int = 24) -> int:
    """The ENeRF head's dense multiply-adds per sample over ``S`` views of
    ``C`` channels; ``L`` lr0's input width."""
    return (S * C * 4 + 2 * 32 * C + S * 32 * C + S * 32 + 16 * 32 + 64 * L + 64
            + 64 * (64 + L) + S * 64 * (C + 4) + S * 64)


def nerf_head_flops(N: int, Ns: int, S: int, C: int, L: int = 24) -> int:
    return N * Ns * 2 * head_macs(S, C, L)


def tri_counts(touched: int, n: int, C: int):
    """The volume sampler's (#6) bytes and operations on ``n`` samples of
    ``C`` channels over ``touched`` voxels."""
    return 4 * (touched * C + 3 * n + n * C), n * (8 * (2 + 2 * C) + 12)


def _conv2d(h, w, cin, cout, k):
    return 2 * h * w * cin * cout * k * k


def _conv3d(d, h, w, cin, cout, k=3):
    return 2 * d * h * w * cin * cout * k ** 3


def fpn_flops(H, W, n_views):
    """The ENeRF FPN: 6 conv stages and the merges."""
    f = 0
    f += _conv2d(H, W, 3, 8, 3) + _conv2d(H, W, 8, 8, 3)
    f += _conv2d(H // 2, W // 2, 8, 16, 5) + _conv2d(H // 2, W // 2, 16, 16, 3)
    f += _conv2d(H // 4, W // 4, 16, 32, 5) + _conv2d(H // 4, W // 4, 32, 32, 3)
    f += _conv2d(H // 4, W // 4, 32, 32, 1)
    f += _conv2d(H // 2, W // 2, 16, 32, 1) + _conv2d(H, W, 8, 32, 1)
    f += _conv2d(H // 2, W // 2, 32, 16, 3) + _conv2d(H, W, 32, 8, 3)
    return n_views * f


def costreg_flops(D, Hv, Wv, cin, deep: bool):
    """MinCostRegNet (``deep`` False) or CostRegNet."""
    f = _conv3d(D, Hv, Wv, cin, 8)
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 8, 16)
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 16, 16)
    f += _conv3d(D // 4, Hv // 4, Wv // 4, 16, 32)
    f += _conv3d(D // 4, Hv // 4, Wv // 4, 32, 32)
    if deep:
        f += _conv3d(D // 8, Hv // 8, Wv // 8, 32, 64) * 2
        f += _conv3d(D // 4, Hv // 4, Wv // 4, 64, 32)
    f += _conv3d(D // 2, Hv // 2, Wv // 2, 32, 16)
    f += _conv3d(D, Hv, Wv, 16, 8)
    f += _conv3d(D, Hv, Wv, 8, 8) + _conv3d(D, Hv, Wv, 8, 1)
    return f


def _head_roofline(k, n_rays, Ns, S, C, L=24):
    P = n_rays * Ns
    return Roofline(0.0, k * 4.0 * P * (8 + S * C + S * 4 + 4),
                    k * nerf_head_flops(n_rays, Ns, S, C, L))


def _sample_roofline(V, H, W, C, n_per_map):
    nbytes, ops = sample_counts(V * H * W, V * n_per_map, C)
    return Roofline(ops, nbytes)


# ---------------------------------------------------------------- frames


def flagship_render_costs(H, W, n_views, k_best, s_cv, volume_planes, volume_scale,
                          render_if, num_samples):
    """The BoostENeRF eval frame's work by stage ({stage: Roofline} and
    'total'): the FPN over all views, each level's warp and U-Net over the K
    volumes, and each rendered level's sampler and head."""
    k, S = k_best, s_cv
    stages = {"fpn": Roofline(fpn_flops(H, W, n_views),
                              n_views * H * W * (3 + 8 + 32 // 4 + 16 // 2) * 4.0)}
    D0, D1 = volume_planes
    Hv0, Wv0 = int(H * volume_scale[0]), int(W * volume_scale[0])
    Hv1, Wv1 = int(H * volume_scale[1]), int(W * volume_scale[1])
    for level, (D, Hv, Wv, hs, ws, C) in enumerate(((D0, Hv0, Wv0, H // 4, W // 4, 32),
                                                    (D1, Hv1, Wv1, H // 2, W // 2, 16))):
        nbytes, ops = warp_counts(k * S * hs * ws * C, k * S * 12, k * D * Hv * Wv, S, C)
        stages[f"warp{level}"] = Roofline(ops, nbytes)
        stages[f"costreg{level}"] = Roofline(
            k * costreg_flops(D, Hv, Wv, C, deep=level == 1),
            k * D * Hv * Wv * (C + 8 + 8 + 1) * 4.0 * 2)
    for level, (h, w, C) in enumerate(((H // 4, W // 4, 32 + 3), (H, W, 8 + 3))):
        if not render_if[level]:
            continue
        Ns = num_samples[level]
        stages[f"sample{level}"] = _sample_roofline(k * S, h, w, C, h * w * Ns)
        stages[f"nerf{level}"] = _head_roofline(k, h * w, Ns, S, C)
    return _total(stages)


def mvsnerf_mlp_macs(width=128, depth=6, n_feat=20, enc=63):
    """The v0 renderer MLP's multiply-adds per sample."""
    trunk = enc * width + (depth - 1) * width * width + enc * width
    return (trunk + n_feat * width + width + width * width
            + (width + 3) * (width // 2) + (width // 2) * 3)


def mvsnerf_render_costs(H, W, k_best, s_cv, D, pad, mlp_width, mlp_depth, n_views, pos_freqs):
    """The BoostMVSNeRF eval frame's work by stage ({stage: Roofline} and
    'total'): the feature net, the plain warp, the U-Net, the volume and
    colour lookups and the renderer MLP over the K padded volumes."""
    h, w = H // 4, W // 4
    hp, wp = h + 2 * pad, w + 2 * pad
    k = k_best
    stages = {}
    f = _conv2d(H, W, 3, 8, 3) + _conv2d(H, W, 8, 8, 3)
    f += _conv2d(H // 2, W // 2, 8, 16, 5) + 2 * _conv2d(H // 2, W // 2, 16, 16, 3)
    f += _conv2d(h, w, 16, 32, 5) + 2 * _conv2d(h, w, 32, 32, 3)
    f += _conv2d(h, w, 32, 32, 1)
    stages["features"] = Roofline(n_views * f, n_views * (H * W * 3 + h * w * 32) * 4.0)
    n_vox = D * hp * wp
    stages["warp"] = Roofline(k * (s_cv - 1) * n_vox * (20 + 8 * (32 + 3)),
                              k * (s_cv * h * w * (32 + 3) + n_vox * (9 + 32)) * 4.0)
    cr = _conv3d(D, hp, wp, 41, 8)
    cr += 2 * _conv3d(D // 2, hp // 2, wp // 2, 8, 16)
    cr += 2 * _conv3d(D // 4, hp // 4, wp // 4, 16, 32)
    cr += 2 * _conv3d(D // 8, hp // 8, wp // 8, 32, 64)
    cr += _conv3d(D // 4, hp // 4, wp // 4, 64, 32)
    cr += _conv3d(D // 2, hp // 2, wp // 2, 32, 16)
    cr += _conv3d(D, hp, wp, 16, 8)
    stages["costreg"] = Roofline(k * cr, k * n_vox * (41 + 8) * 4.0 * 2)
    n_pts = H * W * D
    nbytes, ops = tri_counts(k * n_vox, k * n_pts, 8)
    stages["tri_sample"] = Roofline(ops, nbytes)
    stages["img_sample"] = _sample_roofline(k * s_cv, H, W, 3, n_pts)
    n_feat = 8 + 4 * s_cv
    macs = mvsnerf_mlp_macs(mlp_width, mlp_depth, n_feat, 3 + 6 * pos_freqs)
    stages["mlp"] = Roofline(k * n_pts * 2 * 3 * pos_freqs,
                             k * n_pts * (3 + n_feat + 3 + 4) * 4.0, k * n_pts * 2 * macs)
    return _total(stages)


def frame_costs(cfg: dict, H: int, W: int) -> dict:
    """A configuration tree's eval frame work at H x W, by its family:
    ``flagship_render_costs`` for BoostENeRF, ``mvsnerf_render_costs`` for
    BoostMVSNeRF."""
    en = cfg["enerf"]
    cas = en["cas_config"]
    family = cfg["network_module"].rsplit(".", 1)[-1]
    if family == "boost_enerf":
        return flagship_render_costs(H, W, en["test_input_views"], cas["k_best"],
                                     en["cost_volume_input_views"], cas["volume_planes"],
                                     cas["volume_scale"], cas["render_if"], cas["num_samples"])
    if family == "boost_mvsnerf":
        mv = cfg["mvsnerf"]
        return mvsnerf_render_costs(H, W, cas["k_best"], en["cost_volume_input_views"],
                                    cas["num_samples"][0], mv["pad"], mv["mlp_dim"],
                                    mv["mlp_depth"], en["test_input_views"], mv["pos_freqs"])
    raise ValueError(f"no frame costs for {family}")
