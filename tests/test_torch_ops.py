"""The port's ops (boostmvsnerfs_torch.ops) against their JAX functions.

Same numpy inputs through both; tolerance rtol 1e-4 / atol 1e-5, the bar
of the JAX kernel tests (tests/test_pallas_warp.py), which also covers the
1-2 ulp by which ``sampling.linspace`` and ``jnp.linspace`` differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.ops import cost_volume as tcv
from boostmvsnerfs_torch.ops import geometry as tg
from boostmvsnerfs_torch.ops import render as tr
from boostmvsnerfs_torch.ops import sampling as ts
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch
from boostmvsnerfs_tpu.ops import cost_volume as jcv
from boostmvsnerfs_tpu.ops import geometry as jg
from boostmvsnerfs_tpu.ops import render as jr
from boostmvsnerfs_tpu.ops import sampling as js

RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def both(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.tensor(np.asarray(a)), jnp.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def scene():
    return make_scene_batch(B=2, n_views=3, H=32, W=48, seed=1, rig="orbit")


# ---------------------------------------------------------------- geometry


def test_scale_ixt(scene):
    (t, j), = both(scene["src_ixts"])
    close(tg.scale_ixt(t, 0.25), jg.scale_ixt(j, 0.25))
    assert np.array_equal(t.numpy(), scene["src_ixts"])  # input untouched


@pytest.mark.parametrize("scales", [(0.25, 0.125), (0.5, 0.5)])
def test_proj_mats(scene, scales):
    args = both(scene["src_ixts"], scene["src_exts"], scene["tar_ixt"], scene["tar_ext"])
    got = tg.proj_mats(*[a[0] for a in args], *scales)
    want = jg.proj_mats(*[a[1] for a in args], *scales)
    close(got, want, rtol=1e-4, atol=1e-4)


def test_rays_from_pixels_and_flat_idx(scene):
    W = 48
    idx = np.random.default_rng(0).integers(0, 32 * W, (2, 50)).astype(np.int32)
    close(tg.flat_idx_to_xy(torch.from_numpy(idx).long(), W), jg.flat_idx_to_xy(jnp.asarray(idx), W))
    xy = np.asarray(jg.flat_idx_to_xy(jnp.asarray(idx), W))
    (ti, ji), (te, je), (tx, jx) = both(scene["tar_ixt"], scene["tar_ext"], xy)
    o_t, d_t = tg.rays_from_pixels(ti, te, tx)
    o_j, d_j = jg.rays_from_pixels(ji, je, jx)
    close(o_t, o_j)
    close(d_t, d_j)


def test_project_points_and_cam_center(scene):
    pts = np.random.default_rng(2).normal(0, 2, (2, 40, 3)).astype(np.float32)
    (tp, jp), (te, je), (ti, ji) = both(pts, scene["src_exts"][:, 0], scene["src_ixts"][:, 0])
    xy_t, d_t = tg.project_points(tp, te, ti)
    xy_j, d_j = jg.project_points(jp, je, ji)
    close(xy_t, xy_j, rtol=1e-4, atol=1e-3)  # pixel units, up to ~1e4 px near z=0
    close(d_t, d_j)
    close(tg.cam_center(te), jg.cam_center(je))


# ------------------------------------------------------------- cost volume


@pytest.mark.parametrize("inverse", [True, False])
def test_initial_depth_values(inverse):
    (t, j), = both(np.array([[2.0, 6.0], [1.5, 4.0]], np.float32))
    close(tcv.initial_depth_values(t, 16, 3, 5, inverse), jcv.initial_depth_values(j, 16, 3, 5, inverse))


@pytest.mark.parametrize("prev_inverse,inverse", [(True, False), (False, False), (True, True)])
def test_refined_depth_values(prev_inverse, inverse):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.2, 0.4, (2, 4, 6)).astype(np.float32)
    std = rng.uniform(0.01, 0.05, (2, 4, 6)).astype(np.float32)
    nf = np.stack([np.full((2, 4, 6), 0.5), np.full((2, 4, 6), 0.17)], 1).astype(np.float32)
    if not prev_inverse:
        depth, std, nf = 1.0 / depth, std * 10, nf[:, ::-1].copy() ** -1
    args = both(depth, std, nf)
    got = tcv.refined_depth_values(*[a[0] for a in args], 8, 8, 12, prev_inverse, inverse)
    want = jcv.refined_depth_values(*[a[1] for a in args], 8, 8, 12, prev_inverse, inverse)
    close(got, want)


@pytest.mark.parametrize("inverse", [True, False])
def test_depth_values_near_far(inverse):
    dv = np.random.default_rng(4).uniform(2, 6, (2, 5, 3, 4)).astype(np.float32)
    (t, j), = both(dv)
    close(tcv.depth_values_near_far(t, inverse), jcv.depth_values_near_far(j, inverse))


def _warp_setup(seed=5, S=3, C=8, Hs=24, Ws=36, Ht=12, Wt=18, D=6):
    b = make_scene_batch(B=1, n_views=S, H=Hs, W=Ws, seed=seed, rig="orbit")
    pm = np.asarray(jg.proj_mats(
        jnp.asarray(b["src_ixts"]), jnp.asarray(b["src_exts"]),
        jnp.asarray(b["tar_ixt"]), jnp.asarray(b["tar_ext"]), 1.0, Ht / Hs,
    ))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((1, S, Hs, Ws, C)).astype(np.float32)
    dv = np.broadcast_to(np.linspace(1.5, 6.0, D, dtype=np.float32)[None, :, None, None],
                         (1, D, Ht, Wt)).copy()
    return feats, pm, dv


def test_warp_src_view():
    feats, pm, dv = _warp_setup()
    args = both(feats[0, 0], pm[0, 0], dv[0])
    close(tcv.warp_src_view(*[a[0] for a in args]), jcv.warp_src_view(*[a[1] for a in args]))


@pytest.mark.parametrize("batched", [False, True])
def test_variance_volume(batched):
    feats, pm, dv = _warp_setup(seed=6)
    if not batched:
        feats, pm, dv = feats[0], pm[0], dv[0]
    args = both(feats, pm, dv)
    want_fn = jcv.variance_volume
    want = want_fn(*[a[1] for a in args]) if not batched else want_fn(
        *[a[1][0] for a in args])[None]
    close(tcv.variance_volume(*[a[0] for a in args]), want)


# ---------------------------------------------------------------- sampling


def _coords(rng, n, H, W, margin=4.0):
    x = rng.uniform(-margin, W - 1 + margin, n)
    y = rng.uniform(-margin, H - 1 + margin, n)
    xy = np.stack([x, y], -1)
    xy[:4] = [[0, 0], [W - 1, H - 1], [1e10, -1e10], [-1, H]]  # corners, far out, edges
    return xy.astype(np.float32)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d(padding_mode):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((9, 13, 5)).astype(np.float32)
    (ti, ji), (tx, jx) = both(img, _coords(rng, 200, 9, 13))
    close(ts.grid_sample_2d(ti, tx, padding_mode), js.grid_sample_2d(ji, jx, padding_mode))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d(padding_mode):
    rng = np.random.default_rng(8)
    vol = rng.standard_normal((2, 5, 7, 9, 4)).astype(np.float32)
    pts = rng.uniform(-2, 9, (2, 150, 3)).astype(np.float32)
    (tv, jv), (tp, jp) = both(vol, pts)
    got = ts.grid_sample_3d(tv, tp, padding_mode)
    for b in range(2):
        close(got[b], js.grid_sample_3d(jv[b], jp[b], padding_mode))


@pytest.mark.parametrize("shape_out", [(16, 24), (5, 9), (8, 1), (1, 12)])
def test_resize_bilinear(shape_out):
    img = np.random.default_rng(9).standard_normal((2, 8, 12, 3)).astype(np.float32)
    (t, j), = both(img)
    close(ts.resize_bilinear(t, *shape_out), js.resize_bilinear(j, *shape_out))
    close(ts.resize_bilinear_2d(t[..., 0], *shape_out), js.resize_bilinear_2d(j[..., 0], *shape_out))


def test_linspace_within_ulps_of_jax():
    """Same formula as jnp.linspace; XLA folds the constant arithmetic its
    own way and lands up to 2 ulp (2.4e-7 relative) away."""
    for a, b, n in [(0.0, 1.0, 8), (0.0, 367.0, 736), (2.0, 6.0, 64), (0.0, 1.0, 1)]:
        got = ts.linspace(a, b, n).numpy()
        np.testing.assert_allclose(got, np.asarray(jnp.linspace(a, b, n, dtype=jnp.float32)),
                                   rtol=4e-7, atol=0)


# ------------------------------------------------------------------ render


@pytest.mark.parametrize("inverse", [True, False])
def test_depth_regression(inverse):
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((2, 6, 3, 4)).astype(np.float32)
    dv = rng.uniform(2, 6, (2, 6, 3, 4)).astype(np.float32)
    (tl, jl), (td, jd) = both(logits, dv)
    for got, want in zip(tr.depth_regression(tl, td, inverse), jr.depth_regression(jl, jd, inverse)):
        close(got, want)


@pytest.mark.parametrize("inverse", [True, False])
def test_ray_bounds_maps(inverse):
    rng = np.random.default_rng(11)
    depth = rng.uniform(0.2, 0.4, (2, 4, 6)).astype(np.float32)
    std = rng.uniform(0.01, 0.05, (2, 4, 6)).astype(np.float32)
    nf = rng.uniform(0.1, 0.5, (2, 2, 4, 6)).astype(np.float32)
    args = both(depth, std, nf)
    close(tr.ray_bounds_maps(*[a[0] for a in args], 16, 24, inverse),
          jr.ray_bounds_maps(*[a[1] for a in args], 16, 24, inverse))


@pytest.mark.parametrize("n_samples,inverse", [(1, False), (2, False), (8, True)])
def test_sample_along_depth(n_samples, inverse):
    rng = np.random.default_rng(12)
    o = rng.standard_normal((2, 30, 3)).astype(np.float32)
    d = rng.standard_normal((2, 30, 3)).astype(np.float32)
    lo, hi = rng.uniform(0.2, 0.3, (2, 30)), rng.uniform(0.35, 0.5, (2, 30))
    bounds = (np.stack([hi, lo, hi + 0.1, lo - 0.1], -1) if inverse
              else np.stack([lo, hi, lo - 0.1, hi + 0.1], -1) * 10).astype(np.float32)
    uv = rng.uniform(0, 20, (2, 30, 2)).astype(np.float32)
    args = both(o, d, bounds, uv)
    got = tr.sample_along_depth(*[a[0] for a in args], n_samples, inverse)
    want = jr.sample_along_depth(*[a[1] for a in args], n_samples, inverse)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("softmax_depth,with_z", [(True, True), (False, True), (True, False)])
def test_composite(softmax_depth, with_z):
    rng = np.random.default_rng(13)
    raw = rng.uniform(0, 2, (2, 20, 5, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (2, 20, 5)), -1).astype(np.float32)
    (trw, jrw), (tz, jz) = both(raw, z)
    got = tr.composite(trw, tz if with_z else None, softmax_depth)
    want = jr.composite(jrw, jz if with_z else None, softmax_depth)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_composite_blend_and_masks():
    rng = np.random.default_rng(14)
    raws = rng.uniform(0, 2, (2, 3, 20, 2, 4)).astype(np.float32)
    masks = (rng.uniform(0, 1, (2, 3, 20, 2)) > 0.4).astype(np.float32)
    masks[:, :, :3] = 0.0  # no volume sees these samples: uniform 1/K
    z = rng.uniform(2, 6, (2, 3, 20, 2)).astype(np.float32)
    (tm, jm), = both(masks)
    tn, jn = tr.normalize_blend_masks(tm), jr.normalize_blend_masks(jm)
    close(tn, jn)
    (trw, jrw), (tz, jz) = both(raws, z)
    got, want = tr.composite_blend(trw, tn, tz), jr.composite_blend(jrw, jn, jz)
    for k in want:
        close(got[k], want[k])


def test_mask_viewport(scene):
    rng = np.random.default_rng(15)
    pts = rng.normal(0, 1.5, (2, 40, 3, 3)).astype(np.float32)
    inv = np.array([[47, 31], [47, 31]], np.float32)
    args = both(pts, scene["src_exts"], scene["src_ixts"], inv)
    got = tr.mask_viewport(*[a[0] for a in args])
    want = jr.mask_viewport(*[a[1] for a in args])
    close(got, want)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_unpreprocess(scene, scale):
    (t, j), = both(scene["src_inps"])
    close(tr.unpreprocess(t, scale), jr.unpreprocess(j, scale))
