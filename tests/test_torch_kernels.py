"""The ENeRF kernel modules of boostmvsnerfs_torch.ops.cuda on the CPU.

Each forward kernel's plain PyTorch version is held (a) against the JAX
exact op and (b) against the Pallas kernel in interpret mode with a window
that covers every tap, at rtol 1e-4 / atol 1e-5 (the JAX kernel tests'
bar; tests/test_pallas_warp.py). The plain versions of the two backward
kernels are held against JAX's custom VJPs (Pallas forward and backward in
interpret mode) at the bars of tests/test_pallas_warp.py and
tests/test_pallas_sample.py, and the autograd Functions around them pass
torch's gradcheck. The CUDA kernels themselves are compared with these
plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from boostmvsnerfs_torch.ops.cuda.enerf_head import (
    fused_nerf_head,
    _head_layout,
    nerf_head_plain,
    pack_head_weights,
)
from boostmvsnerfs_torch.ops.cuda.img_sample import (
    fused_row_sample,
    fused_row_sample_diff,
    row_sample_bwd,
    row_sample_bwd_plain,
    row_sample_plain,
)
from boostmvsnerfs_torch.ops.cuda.warp_variance import (
    fused_warp_variance,
    fused_warp_variance_diff,
    warp_variance_bwd,
    warp_variance_bwd_plain,
    warp_variance_plain,
)
from boostmvsnerfs_torch.models.nerf_head import NeRFHead as TorchHead
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch
from boostmvsnerfs_tpu.models.nerf_head import NeRFHead as FlaxHead
from boostmvsnerfs_tpu.ops import cost_volume, geometry, sampling
from boostmvsnerfs_tpu.ops.pallas.img_sample import fused_row_sample as pallas_row_sample
from boostmvsnerfs_tpu.ops.pallas.img_sample import fused_row_sample_diff as pallas_row_sample_diff
from boostmvsnerfs_tpu.ops.pallas.warp_variance import fused_warp_variance as pallas_warp
from boostmvsnerfs_tpu.ops.pallas.warp_variance import (
    fused_warp_variance_diff as pallas_warp_diff,
)
from boostmvsnerfs_tpu.utils import port_weights as jpw

RTOL, ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parents[1]


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ warp_variance


def _warp_inputs(seed, B=2, S=3, C=8, Hs=24, Ws=36, Ht=12, Wt=18, D=5, rig="orbit"):
    """Real cascade geometry (volume at half the feature scale), random
    features; the orbit rig's wide baselines put taps out of range."""
    b = make_scene_batch(B=B, n_views=S, H=Hs, W=Ws, seed=seed, rig=rig)
    pm = np.array(geometry.proj_mats(
        jnp.asarray(b["src_ixts"]), jnp.asarray(b["src_exts"]),
        jnp.asarray(b["tar_ixt"]), jnp.asarray(b["tar_ext"]), 1.0, Ht / Hs,
    ))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, S, Hs, Ws, C)).astype(np.float32)
    near, far = b["near_far"][0]
    dv = rng.uniform(near, far, (B, D, Ht, Wt)).astype(np.float32)
    return feats, pm, dv


@pytest.mark.parametrize("rig,C", [("orbit", 8), ("forward", 4)])
def test_warp_plain_matches_jax_exact(rig, C):
    feats, pm, dv = _warp_inputs(1, C=C, rig=rig)
    got = warp_variance_plain(*map(torch.from_numpy, (feats, pm, dv)))
    want = jax.vmap(cost_volume.variance_volume)(*map(jnp.asarray, (feats, pm, dv)))
    close(got, want)


def test_warp_plain_matches_pallas_interpret():
    feats, pm, dv = _warp_inputs(2)
    got = warp_variance_plain(*map(torch.from_numpy, (feats, pm, dv)))
    want = pallas_warp(*map(jnp.asarray, (feats, pm, dv)), window_h=feats.shape[2],
                       compute_dtype=jnp.float32, interpret=True)
    close(got, want)


@pytest.mark.parametrize("C,D", [(32, 64), (16, 8), (8, 7), (4, 2), (12, 5), (64, 3), (1024, 9)])
def test_sweep_tile_fits_the_kernels(C, D):
    """The warp kernels' chunk: a tile of powers of two (csrc/plane_sweep.cuh
    takes their logarithms), at most one (pixel, 4 channels) per thread of
    a block and at least one pixel, as square as powers of two allow, and a
    run of at most PLANES_PER_RUN planes."""
    from boostmvsnerfs_torch.ops.cuda.warp_variance import PLANES_PER_RUN, THREADS, sweep_tile

    tx, ty, nd = sweep_tile(C, D)
    assert tx & (tx - 1) == 0 and ty & (ty - 1) == 0 and tx >= ty >= 1
    assert tx * ty * (C // 4) <= THREADS or tx * ty == 1
    assert 2 * tx * ty * (C // 4) > THREADS  # the largest such tile
    assert nd == min(D, PLANES_PER_RUN)


def _mean_rel_err(got, want) -> float:
    """tests/test_pallas_warp.py's bf16 measure: mean error over the mean
    magnitude (plus 1e-3)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).mean() / (np.abs(want).mean() + 1e-3))


# The warp at bf16 (the eval path's warp_dtype, the Pallas kernel's default
# compute_dtype) rounds other operands than the Pallas kernel does (the
# features and the four tap weights, where Pallas rounds the features, the
# x weights and the x-interpolated rows), so it is held at JAX's own bf16
# bar, mean error below 0.05 of the mean magnitude
# (tests/test_pallas_warp.py::test_fused_bf16_close); measured 3.5e-3.
@pytest.mark.parametrize("rig,C", [("orbit", 8), ("forward", 4)])
def test_warp_plain_bf16_matches_pallas_bf16_interpret(rig, C):
    feats, pm, dv = _warp_inputs(1, C=C, rig=rig)
    got = warp_variance_plain(*map(torch.from_numpy, (feats, pm, dv)), torch.bfloat16)
    want = pallas_warp(*map(jnp.asarray, (feats, pm, dv)), window_h=feats.shape[2],
                       compute_dtype=jnp.bfloat16, interpret=True)
    assert _mean_rel_err(got, want) < 0.05


# Against its own f32 version the bf16 warp moves by bf16 rounding alone:
# measured 2.8e-3 of the mean magnitude and 5.3e-3 of the largest; bars
# JAX's 0.05 and the card's 1e-2 of the largest magnitude.
@pytest.mark.parametrize("rig,C", [("orbit", 8), ("forward", 4)])
def test_warp_plain_bf16_rounds_the_f32_version(rig, C):
    t = list(map(torch.from_numpy, _warp_inputs(3, C=C, rig=rig)))
    got, want = warp_variance_plain(*t, torch.bfloat16), warp_variance_plain(*t)
    rel = _mean_rel_err(got, want)
    assert 1e-4 < rel < 0.05  # rounded, and by bf16 rounding only
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_cascade_config_takes_jax_warp_dtype():
    """``warp_dtype`` has JAX's default and values; it selects the eval
    warp's compute dtype on the card (the CPU takes float32 either way)."""
    from boostmvsnerfs_torch.models.enerf import WARP_DTYPES, CascadeConfig
    from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig

    assert CascadeConfig().warp_dtype == JaxCascadeConfig().warp_dtype == "bfloat16"
    assert WARP_DTYPES[CascadeConfig().warp_dtype] == torch.bfloat16
    assert WARP_DTYPES[CascadeConfig(warp_dtype="float32").warp_dtype] == torch.float32
    with pytest.raises(ValueError, match="warp_dtype"):
        CascadeConfig(warp_dtype="float16")


# --------------------------------------------------------------- img_sample


# the maps' channel counts on the model paths: MVSNeRF's colour lookup,
# ENeRF's level 1 (8 features + RGB) and level 0 (32 + RGB)
SAMPLE_WIDTHS = (3, 11, 35)


def _sample_inputs(seed, V=4, H=10, W=14, C=11, P=120):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((V, H, W, C)).astype(np.float32)
    x = rng.uniform(-3, W + 2, (V, P)).astype(np.float32)
    y = rng.uniform(-3, H + 2, (V, P)).astype(np.float32)
    x[:, :3] = [0.0, W - 1, 1e10]  # edges and a behind-camera projection
    y[:, :3] = [H - 1, 0.0, -1e10]
    return imgs, x, y


@pytest.mark.parametrize("C", SAMPLE_WIDTHS)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_plain_matches_jax_exact(padding_mode, C):
    imgs, x, y = _sample_inputs(3, C=C)
    got = row_sample_plain(*map(torch.from_numpy, (imgs, x, y)), padding_mode)
    want = jax.vmap(lambda im, c: sampling.grid_sample_2d(im, c, padding_mode))(
        jnp.asarray(imgs), jnp.stack([jnp.asarray(x), jnp.asarray(y)], -1))
    close(got, want)


@pytest.mark.parametrize("C", SAMPLE_WIDTHS)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_plain_matches_pallas_interpret(padding_mode, C):
    imgs, x, y = _sample_inputs(4, C=C, P=6 * 20)
    x, y = np.clip(x, -50, 50), np.clip(y, -50, 50)  # finite rows for the band origin
    V, H = imgs.shape[:2]
    got = row_sample_plain(*map(torch.from_numpy, (imgs, x, y)), padding_mode)
    want = pallas_row_sample(
        jnp.asarray(imgs), jnp.asarray(x.reshape(V, 6, 20)), jnp.asarray(y.reshape(V, 6, 20)),
        window_h=H, padding_mode=padding_mode, compute_dtype=jnp.float32, interpret=True,
    ).reshape(V, 6 * 20, -1)
    close(got, want)


# ------------------------------------------------ the two backward kernels


def _scaled_close(got, want, atol=2e-5, name=""):
    """Gradients after scaling both by the reference's largest magnitude
    (tests/test_pallas_warp.py's bar)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("rig,C", [("orbit", 8), ("forward", 4)])
def test_warp_bwd_plain_matches_pallas_interpret(rig, C):
    """Kernel #2: the plain backward against JAX's custom VJP (Pallas
    forward and backward in interpret mode) with a window of every source
    row, so every tap is held; spatially varying depths give a non-trivial
    depth cotangent, and the orbit rig puts taps out of range."""
    feats, pm, dv = _warp_inputs(13, C=C, rig=rig)
    ct = np.random.default_rng(14).standard_normal(dv.shape + (C,)).astype(np.float32)
    window = feats.shape[2]

    def loss(f, d):
        v = pallas_warp_diff(f, jnp.asarray(pm), d, window, jnp.float32, True)
        return jnp.sum(v * jnp.asarray(ct))

    want_loss, want = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(dv))
    t = [torch.from_numpy(a) for a in (feats, pm, dv, ct)]
    got_loss = torch.sum(warp_variance_plain(*t[:3]) * t[3])
    got = warp_variance_bwd_plain(*t)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)
    for g, w, name in zip(got, want, ("d_src_feats", "d_depth_values")):
        assert g.shape == w.shape, name
        _scaled_close(g.numpy(), w, name=name)
    assert np.abs(got[1].numpy()).max() > 0


@pytest.mark.parametrize("C", SAMPLE_WIDTHS)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_row_sample_bwd_plain_matches_pallas_interpret(padding_mode, C):
    """Kernel #4: the plain backward against JAX's custom VJP in interpret
    mode, a window of every row. The samples include the frame's edges and
    integer points, where both follow the Pallas convention (dx = 0)."""
    imgs, x, y = _sample_inputs(15, C=C, P=6 * 20)
    x, y = np.clip(x, -50, 50), np.clip(y, -50, 50)
    x[:, 3:6], y[:, 3:6] = [2.0, 5.0, 0.5], [3.0, 0.25, 7.0]
    V, H, W, C = imgs.shape
    ct = np.random.default_rng(16).standard_normal((V, 6 * 20, C)).astype(np.float32)

    def loss(im, xx, yy):
        out = pallas_row_sample_diff(im, xx, yy, H, padding_mode, True, 0)
        return jnp.sum(out.reshape(V, 6 * 20, C) * jnp.asarray(ct))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(imgs), jnp.asarray(x.reshape(V, 6, 20)), jnp.asarray(y.reshape(V, 6, 20)))
    got = row_sample_bwd_plain(*map(torch.from_numpy, (imgs, x, y, ct)), padding_mode)
    for g, w, name in zip(got, want, ("d_imgs", "d_x", "d_y")):
        close(g, np.asarray(w).reshape(g.shape), rtol=1e-4, atol=1e-4)


def test_autograd_functions_pass_gradcheck_with_their_plain_backward():
    """On CPU tensors the autograd Functions run the plain versions; in
    float64 their backward passes torch's finite-difference gradcheck at
    points off the integer lattice and inside the clamp ranges."""
    rng = np.random.default_rng(17)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()  # noqa: E731
    imgs = f64(rng.standard_normal((2, 5, 6, 3)))
    x = f64(rng.uniform(0.1, 4.9, (2, 7)))
    y = f64(rng.uniform(0.1, 3.9, (2, 7)))
    for mode in ("border", "zeros"):
        assert torch.autograd.gradcheck(lambda i, a, b: fused_row_sample_diff(i, a, b, mode),
                                        (imgs, x, y), eps=1e-6, atol=1e-6)
    feats, pm, _ = _warp_inputs(18, B=1, S=2, C=4, Hs=6, Ws=8, Ht=3, Wt=4, D=2, rig="forward")
    dv = f64(rng.uniform(2.5, 5.0, (1, 2, 3, 4)))
    pm = torch.from_numpy(pm.astype(np.float64))
    assert torch.autograd.gradcheck(lambda f, d: fused_warp_variance_diff(f, pm, d),
                                    (f64(feats), dv), eps=1e-6, atol=1e-6)


def test_autograd_functions_backward_is_the_plain_backward():
    """The Functions' float32 gradients on the CPU are exactly the plain
    backward versions' outputs, and nothing counts a launch."""
    reset_launch_counts()
    feats, pm, dv = _warp_inputs(19)
    ct = torch.from_numpy(np.random.default_rng(20).standard_normal(dv.shape + (8,)).astype(np.float32))
    f, d = torch.from_numpy(feats).requires_grad_(), torch.from_numpy(dv).requires_grad_()
    p = torch.from_numpy(pm)
    got = torch.autograd.grad(torch.sum(fused_warp_variance_diff(f, p, d) * ct), (f, d))
    want = warp_variance_bwd_plain(f.detach(), p, d.detach(), ct)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    imgs, x, y = _sample_inputs(21)
    ct = torch.from_numpy(np.random.default_rng(22).standard_normal((4, 120, 11)).astype(np.float32))
    args = [torch.from_numpy(a).requires_grad_() for a in (imgs, x, y)]
    got = torch.autograd.grad(torch.sum(fused_row_sample_diff(*args) * ct), args)
    want = row_sample_bwd_plain(*(a.detach() for a in args), ct, "border")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


# --------------------------------------------------------------- enerf_head


def _heads(seed, feat_ch, viewdir_agg=True):
    sd = random_state_dict(TorchHead(feat_ch, viewdir_agg=viewdir_agg), seed, "nerf_0.")
    params = {}
    jpw.port_nerf_head(sd, params, "nerf_0", "head", viewdir_agg)
    head = TorchHead(feat_ch, viewdir_agg=viewdir_agg)
    head.load_state_dict({k[len("nerf_0."):]: torch.from_numpy(v) for k, v in sd.items()})
    return head, FlaxHead(feat_ch=feat_ch, viewdir_agg=viewdir_agg), {"params": params["head"]}


def _head_inputs(seed, B=2, S=3, P=60, C=11):
    rng = np.random.default_rng(seed)
    vox = rng.standard_normal((B, P, 8)).astype(np.float32)
    feat = rng.standard_normal((B, S, P, C)).astype(np.float32)
    feat[..., -3:] = rng.uniform(0, 1, (B, S, P, 3))  # RGB
    dirs = rng.standard_normal((B, S, P, 4)).astype(np.float32)
    return vox, feat, dirs


@pytest.mark.parametrize("feat_ch,viewdir_agg,S", [
    pytest.param(11, True, 3, id="11-True"), pytest.param(35, True, 3, id="35-True"),
    pytest.param(11, False, 3, id="11-False"), pytest.param(11, True, 2, id="11-True-S2"),
    pytest.param(11, True, 4, id="11-True-S4"), pytest.param(35, False, 2, id="35-False-S2"),
    pytest.param(35, True, 4, id="35-True-S4")])
def test_head_plain_matches_flax(feat_ch, viewdir_agg, S):
    head, fhead, variables = _heads(5, feat_ch, viewdir_agg)
    vox, feat, dirs = _head_inputs(6, S=S, C=feat_ch)
    with torch.no_grad():
        got = nerf_head_plain(head.head_params(), *map(torch.from_numpy, (vox, feat, dirs)))
    ifrd = np.concatenate([feat, dirs], -1).transpose(0, 2, 1, 3)  # (B, P, S, C+4)
    want = fhead.apply(variables, jnp.asarray(vox), jnp.asarray(ifrd))
    close(got, want)


# The head at bf16 (the kernel's contract: the Pallas kernel's default
# precision on the TPU) against the flax head in f32 on the CPU: every
# dense layer's operands move by up to half a bf16 ulp (2^-9 relative).
# Measured on the CPU: at most 2.3e-3 of the output's magnitude (mean
# 2e-4); bar 1e-2 of it (at least 1), the card check's bar
# (chip_smoke.KERNEL_BF16_RTOL).
HEAD_BF16_BAR = 1e-2


@pytest.mark.parametrize("feat_ch,viewdir_agg", [(11, True), (35, True), (11, False)])
def test_head_plain_bf16_matches_flax(feat_ch, viewdir_agg):
    head, fhead, variables = _heads(5, feat_ch, viewdir_agg)
    vox, feat, dirs = _head_inputs(6, C=feat_ch)
    with torch.no_grad():
        got = nerf_head_plain(head.head_params(), *map(torch.from_numpy, (vox, feat, dirs)),
                              compute_dtype=torch.bfloat16).numpy()
    ifrd = np.concatenate([feat, dirs], -1).transpose(0, 2, 1, 3)  # (B, P, S, C+4)
    want = np.asarray(fhead.apply(variables, jnp.asarray(vox), jnp.asarray(ifrd)))
    err = np.abs(got - want)
    assert err.max() <= HEAD_BF16_BAR * max(1.0, float(np.abs(want).max()))
    assert err.max() > 1e-5  # the operands were rounded


@pytest.mark.parametrize("feat_ch,viewdir_agg", [(11, True), (35, False)])
def test_head_bf16_buffers_hold_each_layer_where_the_kernel_reads_it(feat_ch, viewdir_agg):
    """``pack_head_weights``: the kernel's Layout (csrc/enerf_head.cu), the
    per-view widths padded to k16 (CP, CV), rows 8 elements longer, and
    the one-output layers' weights as bf16 values in the vector buffer."""
    head, _, _ = _heads(9, feat_ch, viewdir_agg)
    p = {k: (w.detach(), b.detach()) for k, (w, b) in head.head_params().items()}
    mats, vecs = pack_head_weights(p)
    C = feat_ch
    CP, CV = 16 * -(-C // 16), 16 * -(-(C + 4) // 16)
    shapes = ([("view_fc", CP, 16)] if viewdir_agg else []) + [
        ("global_fc", 32, 3 * CP), ("fc", 16, 32), ("lr0", 64, 32), ("color0", 64, 96),
        ("color0_view", 64, CV)]
    assert mats.dtype == torch.bfloat16
    assert mats.numel() == sum(r * (k + 8) for _, r, k in shapes)
    at, m = 0, {}
    for name, r, k in shapes:
        m[name] = mats[at:at + r * (k + 8)].reshape(r, k + 8).float()
        at += r * (k + 8)
    bf = lambda w: w.to(torch.bfloat16).float()  # noqa: E731
    kg, kc = p["global_fc"][0], p["color0"][0]
    for i in range(3):  # [img, var, avg], each CP wide
        assert torch.equal(m["global_fc"][:, i * CP:i * CP + C], bf(kg[:, i * C:(i + 1) * C]))
        assert not m["global_fc"][:, i * CP + C:(i + 1) * CP].any()
    assert torch.equal(m["color0"][:, :88], bf(kc[:, :88])) and not m["color0"][:, 88:].any()
    assert torch.equal(m["color0_view"][:, :C + 4], bf(kc[:, 88:]))
    assert not m["color0_view"][:, C + 4:].any()
    assert torch.equal(m["lr0"][:, :24], bf(p["lr0"][0])) and not m["lr0"][:, 24:].any()
    if viewdir_agg:
        assert torch.equal(m["view_fc"][:C, :4], bf(p["view_fc"][0]))
        assert not m["view_fc"][C:].any() and not m["view_fc"][:, 4:].any()
    assert vecs.numel() == CP + 348  # Layout::V_N
    assert torch.equal(vecs[CP + 32:CP + 64], bf(p["agg_w_fc"][0]).reshape(-1))  # WA
    assert torch.equal(vecs[CP + 216:CP + 280], p["color0"][1])  # BC
    assert torch.equal(vecs[CP + 280:CP + 344], bf(p["color1"][0]).reshape(-1))  # WC


def test_head_plain_rejects_other_compute_dtypes():
    head, _, _ = _heads(10, 11)
    vox, feat, dirs = map(torch.from_numpy, _head_inputs(11))
    with torch.no_grad(), pytest.raises(TypeError, match="compute_dtype"):
        nerf_head_plain(head.head_params(), vox, feat, dirs, compute_dtype=torch.float16)


def test_head_plain_matches_pallas_interpret():
    head, fhead, variables = _heads(7, 11)
    B, S, R, T, C = 2, 3, 3, 40, 11
    vox, feat, dirs = _head_inputs(8, B=B, S=S, P=R * T, C=C)
    with torch.no_grad():
        got = nerf_head_plain(head.head_params(), *map(torch.from_numpy, (vox, feat, dirs)))
    rows = lambda a: jnp.asarray(np.moveaxis(a.reshape(*a.shape[:-2], R, T, a.shape[-1]), -1, -2))
    out = fhead.apply(variables, rows(vox), rows(feat), rows(dirs), interpret=True,
                      method=FlaxHead.fused)  # (B, R, 4, T)
    close(got, jnp.moveaxis(out, 2, 3).reshape(B, R * T, 4))


# ------------------------------------------------------------ wrapper rules


def test_wrappers_take_plain_on_cpu_and_do_not_count():
    reset_launch_counts()
    feats, pm, dv = _warp_inputs(9)
    t = lambda *a: map(torch.from_numpy, a)  # noqa: E731
    assert torch.equal(fused_warp_variance(*t(feats, pm, dv)), warp_variance_plain(*t(feats, pm, dv)))
    imgs, x, y = _sample_inputs(10)
    assert torch.equal(fused_row_sample(*t(imgs, x, y), "border"),
                       row_sample_plain(*t(imgs, x, y), "border"))
    head, _, _ = _heads(11, 11)
    vox, feat, dirs = _head_inputs(12)
    with torch.no_grad():
        assert torch.equal(head(*t(vox, feat, dirs)),
                           nerf_head_plain(head.head_params(), *t(vox, feat, dirs)))
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,error", [
    (lambda: fused_warp_variance(_meta(1, 3, 8, 8, 6), _meta(1, 3, 3, 4), _meta(1, 2, 4, 4)),
     ValueError),  # channels not a multiple of 4
    (lambda: fused_warp_variance(_meta(1, 3, 8, 8, 8), _meta(1, 2, 3, 4), _meta(1, 2, 4, 4)),
     ValueError),  # proj_mats shape
    (lambda: fused_warp_variance(_meta(1, 3, 8, 8, 8, dtype=torch.float64),
                                 _meta(1, 3, 3, 4), _meta(1, 2, 4, 4)), TypeError),
    (lambda: fused_row_sample(_meta(2, 8, 8, 5), _meta(2, 10), _meta(2, 11)), ValueError),
    (lambda: fused_row_sample(_meta(2, 8, 8, 5), _meta(2, 10), _meta(2, 10), "reflect"),
     ValueError),
    (lambda: fused_row_sample(_meta(2, 8, 8, 5, dtype=torch.float16), _meta(2, 10),
                              _meta(2, 10)), TypeError),
    (lambda: TorchHead(11)(_meta(1, 7, 8), _meta(1, 3, 6, 11), _meta(1, 3, 6, 4)), ValueError),
    (lambda: TorchHead(13)(_meta(1, 6, 8), _meta(1, 3, 6, 13), _meta(1, 3, 6, 4)), ValueError),
    (lambda: warp_variance_bwd(_meta(1, 3, 8, 8, 8), _meta(1, 3, 3, 4), _meta(1, 2, 4, 4),
                               _meta(1, 2, 4, 4, 4)), ValueError),  # cotangent shape
    (lambda: warp_variance_bwd(_meta(1, 3, 8, 8, 6), _meta(1, 3, 3, 4), _meta(1, 2, 4, 4),
                               _meta(1, 2, 4, 4, 6)), ValueError),  # channels
    (lambda: row_sample_bwd(_meta(2, 8, 8, 5), _meta(2, 10), _meta(2, 10), _meta(2, 10, 4)),
     ValueError),  # cotangent shape
    (lambda: row_sample_bwd(_meta(2, 8, 8, 5), _meta(2, 10), _meta(2, 10), _meta(2, 10, 5),
                            "reflect"), ValueError),
    (lambda: TorchHead(11)(_meta(1, 6, 8), _meta(1, 9, 6, 11), _meta(1, 9, 6, 4)),
     ValueError),  # more views than the kernel's MAX_VIEWS
    (lambda: TorchHead(35)(_meta(1, 6, 8), _meta(1, 1, 6, 35), _meta(1, 1, 6, 4)),
     ValueError),  # one view
    (lambda: fused_warp_variance(_meta(1, 3, 8, 8, 8), _meta(1, 3, 3, 4), _meta(1, 2, 4, 4),
                                 torch.float16), TypeError),  # compute dtype
])
def test_wrappers_reject_bad_inputs_off_cpu(call, error):
    """Off the CPU a wrapper launches its kernel or raises; malformed
    inputs raise before any launch (meta tensors stand in for CUDA ones)."""
    with torch.no_grad(), pytest.raises(error):
        call()
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


# ----------------------------------------------------------- import hygiene

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
# importing any of these would raise: triton, and the data and config
# layers' optional readers, which the package imports where it reads files
for blocked in ("triton", "yaml", "imageio", "PIL", "cv2"):
    sys.modules[blocked] = None
import boostmvsnerfs_torch
names = [m.name for m in pkgutil.walk_packages(boostmvsnerfs_torch.__path__, "boostmvsnerfs_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "boostmvsnerfs_tpu"))
assert not bad, bad
print(len(names))
"""


def test_package_imports_without_jax_nvcc_or_triton():
    """Every module imports in a fresh interpreter with no nvcc on PATH and
    triton, PyYAML, imageio, Pillow and OpenCV blocked, and none pulls in
    JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 52


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "boostmvsnerfs_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "boostmvsnerfs_tpu"}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_kernel_inputs_rehearse_on_cpu():
    """chip_smoke.py's per-kernel inputs, taken from the model's stages, at
    a small geometry on the CPU: each kernel's wrapper accepts them (taking
    its plain version here), and the bytes/operations counts are positive."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors

    smoke = _load_chip_smoke()
    model = BoostENeRF(CascadeConfig(k_best=2, volume_planes=(8, 8), render_if=(False, True)),
                       device="cpu")
    model.load_state_dict(smoke.random_weights(model, 0), strict=True)
    batch = make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, k_best=2, rig="forward")
    with torch.no_grad():
        inputs = smoke.main_path_kernel_inputs(model, to_tensors(batch, torch.device("cpu")))
        (l0, (f0, _, d0)), (l1, (f1, _, d1)) = inputs["warp_variance"]
        assert (l0, l1) == ("level0", "level1")
        assert f0.shape == (2, 3, 8, 16, 32) and d0.shape == (2, 8, 4, 8)
        assert f1.shape == (2, 3, 16, 32, 16) and d1.shape == (2, 8, 16, 32)
        (_, (imgs, x, _)), = inputs["img_sample"]
        assert imgs.shape == (6, 32, 64, 11) and x.shape == (6, 32 * 64 * 2)
        (_, (params, vox, feat, dirs)), = inputs["enerf_head"]
        assert vox.shape == (2, 4096, 8) and feat.shape == (2, 3, 4096, 11)
        assert dirs.shape == (2, 3, 4096, 4)
        for n in smoke.HEAD_VIEWS:  # the head's other view counts: the views cycled
            (_, (_, vox_n, feat_n, dirs_n)), = inputs[f"enerf_head/S{n}"]
            assert vox_n is vox and feat_n.shape == (2, n, 4096, 11)
            assert torch.equal(feat_n[:, n - 1], feat[:, (n - 1) % 3])
            assert torch.equal(dirs_n[:, n - 1], dirs[:, (n - 1) % 3])
        work = {"warp_variance": (fused_warp_variance, smoke.warp_work),
                "img_sample": (fused_row_sample, smoke.sample_work),
                "enerf_head": (fused_nerf_head, smoke.head_work),
                **{f"enerf_head/S{n}": (fused_nerf_head, smoke.head_work)
                   for n in smoke.HEAD_VIEWS}}
        for name, (wrapper, count) in work.items():
            for _, args in inputs[name]:
                assert torch.isfinite(wrapper(*args)).all(), name
                nbytes, *ops = count(*args)
                assert nbytes > 0 and sum(ops) > 0 and min(ops) >= 0, name


def test_packed_weights_are_kept_until_a_parameter_changes():
    """The wrappers' packed weights hold each call's parameter values: the
    layout's plan is made once per device and shapes, and each call gathers
    the current values, whether a parameter changed in place, through
    ``.data`` (which PyTorch does not version) or was replaced."""
    from boostmvsnerfs_torch.ops.cuda import _tensor_cores

    head, _, _ = _heads(12, 11)

    def direct():  # the layout run on the values themselves, no plan
        mats, vecs = _head_layout(head.head_params(), _tensor_cores.round_bf16)
        return mats.to(torch.bfloat16), vecs

    changes = [
        lambda: None,
        lambda: head.lr0[0].weight.add_(1.0),  # in place: a new version
        lambda: head.color[2].weight.data.copy_(-head.color[2].weight),  # no new version
        lambda: setattr(head.lr0[0], "weight", torch.nn.Parameter(head.lr0[0].weight * 2)),
        lambda: setattr(head.agg.fc[0].bias, "data", head.agg.fc[0].bias + 3),  # new storage
    ]
    with torch.no_grad():
        before = pack_head_weights(head.head_params())
        plans = len(_tensor_cores._plans)
        for i, change in enumerate(changes):
            change()
            got = pack_head_weights(head.head_params())
            want = direct()
            assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
            assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True)), i
            assert i == 0 or not all(torch.equal(g, b) for g, b in zip(got, before)), i
            before = got
        assert len(_tensor_cores._plans) == plans  # one plan served every call
        head.to("meta")  # moved: packed again, on the parameters' device
        assert all(t.device.type == "meta" for t in pack_head_weights(head.head_params()))
        assert len(_tensor_cores._plans) == plans + 1
