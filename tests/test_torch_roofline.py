"""``boostmvsnerfs_torch/utils/roofline.py`` on the CPU: the card's peaks,
each kernel's bound at its main path's shapes, and a frame's work against
JAX's ``utils/roofline.py`` where the two count the same thing.

The per-kernel bounds are PERF.md's kernel table (section 6, the bound
column, NVIDIA H100 80GB HBM3 peaks), each at its row's shapes; the
kernels' inputs there come from the seeded main paths at full width. Where
the work depends on the data, the share it takes comes from the card's run
of those inputs, as ``chip_smoke.py``'s ``kernels`` lines print it: the
warps' live tap share (``live_tap_share``), the samplers' touched map pixels
and voxels (``touched_pixels``, ``touched_voxels``). The rest is shapes,
given here as meta tensors.
"""

import pytest
import torch

from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig, RendererMLP
from boostmvsnerfs_torch.utils import roofline as r
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.utils import roofline as jr

H, W = 480, 736  # the BoostENeRF paths
K, S = 4, 3
MVS_RAYS = 224 * 352  # the BoostMVSNeRF path
# the data's shares on the card (chip_smoke.py's kernels lines on the
# NVIDIA H100 80GB HBM3): the fine-tuning step's warp backward at both
# levels (live taps), the eval frame's level-1 sampler and the step's
# level-0 and first level-1 block samplers (touched map pixels), the
# MVSNeRF frame's volume sampler (touched voxels)
WARP_BWD_LIVE = (0.9615, 0.9620)
SAMPLE_TOUCHED = 3_490_537
SAMPLE_BWD_TOUCHED = (223_215, 283_640)
TRI_TOUCHED = 420_021


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _within(got_ms: float, want_ms: float):
    assert abs(got_ms - want_ms) <= 0.01 * want_ms, (got_ms, want_ms)


def _levels():
    """(n_feats, n_pm, voxels, channels) of the cascade's two warps."""
    return ((K * S * (H // 4) * (W // 4) * 32, K * S * 12, K * 64 * (H // 8) * (W // 8), 32),
            (K * S * (H // 2) * (W // 2) * 16, K * S * 12, K * 8 * (H // 2) * (W // 2), 16))


@pytest.mark.parametrize("live", [0.0, 1.0])
def test_warp_bound(live):
    """#1, level 0 + level 1: each bound by bytes whatever share of taps is
    live."""
    bounds = [r.bound(*r.warp_counts(nf, npm, n, S, C, live)) for nf, npm, n, C in _levels()]
    _within(sum(ms for ms, _ in bounds), 0.143)
    assert [by for _, by in bounds] == ["bytes", "bytes"]


def test_warp_bwd_bound():
    """#2, level 0 (bound by operations) + level 1 (by bytes)."""
    bounds = [r.bound(*r.warp_bwd_counts(nf, npm, n, S, C, live))
              for (nf, npm, n, C), live in zip(_levels(), WARP_BWD_LIVE)]
    _within(sum(ms for ms, _ in bounds), 0.196)
    assert [by for _, by in bounds] == ["operations", "bytes"]


def test_sample_bound():
    ms, by = r.bound(*r.sample_counts(SAMPLE_TOUCHED, K * S * H * W * 2, 11))
    _within(ms, 0.177)
    assert by == "bytes"


@pytest.mark.parametrize("level,shape,n,want", [
    (0, (K * S, H // 4, W // 4, 35), H // 4 * W // 4 * 8, 0.119),
    (1, (K * S, H, W, 11), H * W // 16 * 2, 0.069)])
def test_sample_bwd_bound(level, shape, n, want):
    """#4 at level 0 and on the first of 16 level-1 ray blocks."""
    n_imgs = shape[0] * shape[1] * shape[2] * shape[3]
    ms, by = r.bound(*r.sample_bwd_counts(SAMPLE_BWD_TOUCHED[level], n_imgs, K * S * n,
                                          shape[3]))
    _within(ms, want)
    assert by == "bytes"


def test_head_bound():
    params = BoostENeRF(CascadeConfig(), device="cpu").nerf_1.head_params()
    P = H * W * 2
    ms, by = r.bound(*r.head_work(params, _meta(K, P, 8), _meta(K, S, P, 11), _meta(K, S, P, 4)))
    _within(ms, 0.192)
    assert by == "bytes"


def test_tri_bound():
    """#6 reads the voxels its taps touch (a quarter of the padded volume on
    the main path); counting the whole volume gives 0.150 ms."""
    n = MVS_RAYS * 32
    ms, by = r.bound(*r.tri_counts(TRI_TOUCHED, K * n, 8))
    _within(ms, 0.137)
    assert by == "bytes"
    _within(r.bound(*r.tri_counts(K * 32 * 104 * 136, K * n, 8))[0], 0.150)


@pytest.mark.parametrize("width,freqs,dtype,want", [(63, 0, torch.bfloat16, 2.565),
                                                    (3, 10, torch.bfloat16, 2.574),
                                                    (3, 10, torch.float32, 37.877)])
def test_mlp_bound(width, freqs, dtype, want):
    """#7 (encoded input), #8 (raw coordinates) and #8b (its f32 kernel)."""
    params = RendererMLP(MVSNeRFConfig(), 20).mlp_params()
    n = MVS_RAYS * 32
    ms, by = r.bound(*r.mlp_work(params, _meta(K, n, width), _meta(K, n, 20), _meta(K, n, 3),
                                 freqs, dtype))
    _within(ms, want)
    assert by == "operations"


def test_work_counts_what_the_inputs_need():
    """On real inputs the work functions take the shares from the data: a
    sampler whose samples sit inside one pixel per map touches 4 pixels a
    map, a volume sampler's inside one voxel 8 voxels per volume and none
    outside; a warp whose voxels all project outside the source image has
    no live tap."""
    imgs = torch.zeros(2, 9, 13, 5)
    x, y = torch.full((2, 7), 4.5), torch.full((2, 7), 2.5)
    assert r.sample_work(imgs, x, y) == r.sample_counts(8, 14, 5)
    vol = torch.zeros(2, 4, 5, 6, 8)
    xyz = torch.tensor([[2.5, 1.5, 0.5]] * 3 + [[-1.5, 9.0, 1.0]] * 2).expand(2, 5, 3)
    assert r.touched_voxels(vol, xyz) == 16
    assert r.tri_work(vol, xyz) == r.tri_counts(16, 10, 8)
    assert r.touched_voxels(vol, torch.stack(torch.meshgrid(
        torch.arange(6.0), torch.arange(5.0), torch.arange(4.0), indexing="ij"),
        -1).reshape(1, -1, 3).expand(2, -1, 3)) == vol.numel() // 8
    feats = torch.zeros(1, 2, 6, 8, 4)
    pm = torch.zeros(1, 2, 3, 4)
    pm[..., 0, 3], pm[..., 2, 3] = 1e3, 1.0  # x = 1000 px everywhere
    dv = torch.ones(1, 3, 5, 7)
    assert r.live_tap_share(feats, pm, dv) == 0.0
    assert r.warp_work(feats, pm, dv) == r.warp_counts(feats.numel(), pm.numel(), dv.numel(),
                                                       2, 4, 0.0)


def test_peaks():
    assert r.peaks(r.H100) is r.H100
    assert r.CARD_PEAKS["NVIDIA H100 80GB HBM3"] == r.Peaks(3.35e12, 67e12, 989e12)


@pytest.mark.parametrize("name,known", [("NVIDIA H100 80GB HBM3", True), ("Tesla T4", False)])
def test_peaks_of_the_card(monkeypatch, name, known):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    if known:
        assert r.peaks() == r.H100
    else:
        with pytest.raises(ValueError, match="no peak figures"):
            r.peaks()
        assert r.peaks(r.H100) == r.H100


@pytest.mark.parametrize("render_if", [(False, True), (True, True)])
def test_flagship_networks_and_head_count_as_jax(render_if):
    """FPN, the two cost-regularisation U-Nets and the ENeRF head: the same
    FLOPs as JAX's count (the head's on the port's tensor cores)."""
    got = r.flagship_render_costs(H, W, cas=CascadeConfig(render_if=render_if))
    want = jr.flagship_render_costs(H, W, cas=JaxCascadeConfig(render_if=render_if))
    assert got.keys() == want.keys()
    for stage in ("fpn", "costreg0", "costreg1"):
        assert got[stage].flops == want[stage].flops, stage
    for level in (0, 1):
        if render_if[level]:
            assert got[f"nerf{level}"].tc_flops == want[f"nerf{level}"].flops
            assert got[f"nerf{level}"].flops == 0.0


def test_head_flops_equal_jaxs():
    for args in ((H * W, 2, 3, 11), ((H // 4) * (W // 4), 8, 3, 35), (1000, 4, 8, 11)):
        assert r.nerf_head_flops(*args) == jr.nerf_head_flops(*args)
    assert r.fpn_flops(H, W, 6) == jr.fpn_flops(H, W, 6)
    for deep in (False, True):
        assert r.costreg_flops(64, 60, 92, 32, deep) == jr.costreg_flops(64, 60, 92, 32, deep)


@pytest.mark.parametrize("hw", [(224, 352), (480, 736)])
def test_mvsnerf_networks_count_as_jax(hw):
    """The feature net (over the 6 source views) and the 3D U-Net: JAX's
    FLOPs. The MLP counts the port's layers, whose view branch is 64 wide
    (JAX's count takes 128)."""
    got, want = r.mvsnerf_render_costs(*hw), jr.mvsnerf_render_costs(*hw)
    for stage in ("features", "costreg"):
        assert got[stage].flops == want[stage].flops, stage
    params = RendererMLP(MVSNeRFConfig(), 20).mlp_params()
    assert r.mvsnerf_mlp_macs() == sum(w.numel() for w, _ in params.values())
    assert got["mlp"].tc_flops < want["mlp"].flops


def test_frame_stages_are_the_kernels_work():
    """The frames' kernel stages count what the kernels' work functions
    count on the main paths' shapes (every map pixel touched, every tap
    live), and 'total' sums the stages."""
    cas = CascadeConfig(render_if=(False, True))
    costs = r.flagship_render_costs(H, W, cas=cas)
    params = BoostENeRF(cas, device="cpu").nerf_1.head_params()
    P = H * W * 2
    nbytes, _, tc = r.head_work(params, _meta(K, P, 8), _meta(K, S, P, 11), _meta(K, S, P, 4))
    weights = sum(w.numel() + b.numel() for w, b in params.values())
    assert (costs["nerf1"].bytes, costs["nerf1"].tc_flops) == (nbytes - 4 * weights, tc)
    assert (costs["sample1"].bytes, costs["sample1"].flops) == r.sample_counts(
        K * S * H * W, K * S * P, 11)
    mvs = r.mvsnerf_render_costs(224, 352)
    assert (mvs["tri_sample"].bytes, mvs["tri_sample"].flops) == r.tri_counts(
        K * 32 * 104 * 136, K * MVS_RAYS * 32, 8)
    mlp = r.mlp_work(RendererMLP(MVSNeRFConfig(), 20).mlp_params(), _meta(K, MVS_RAYS * 32, 3),
                     _meta(K, MVS_RAYS * 32, 20), _meta(K, MVS_RAYS * 32, 3), 10)
    assert mvs["mlp"].tc_flops == mlp[2] and mvs["mlp"].flops == mlp[1]
    for c in (costs, mvs):
        parts = [v for k, v in c.items() if k != "total"]
        assert c["total"].bytes == sum(p.bytes for p in parts)
        assert c["total"].flops + c["total"].tc_flops == sum(p.flops + p.tc_flops for p in parts)


def test_speed_of_light():
    """MFU: the frame's operations' least time over its time; the bound
    share: its bound over its time."""
    costs = r.mvsnerf_render_costs(224, 352)["total"]
    t_ops = costs.flops / 67e12 + costs.tc_flops / 989e12
    sol = r.mvsnerf_speed_of_light(224, 352, 0.05, card=r.H100)
    assert sol["mfu"] == pytest.approx(t_ops / 0.05)
    assert sol["bound_ms"] == pytest.approx(max(t_ops, costs.bytes / 3.35e12) * 1e3)
    assert sol["bound_share"] == pytest.approx(sol["bound_ms"] / 50.0)
    flag = r.speed_of_light(H, W, 0.06, card=r.H100, cas=CascadeConfig(render_if=(False, True)))
    assert 0 < flag["mfu"] <= flag["bound_share"] < 1
