"""The port's MVSNeRF family against the JAX package, on the CPU.

Weights: a seeded numpy state_dict under the reference names goes to JAX
through ``port_mvsnerf`` and comes back to the port through
``mvsnerf_state_dict_from_jax`` (no flax ``init``). Bars:

* ops, the raw cost volume and the networks: rtol 1e-4 / atol 1e-5 (the
  JAX kernel tests' bar); the conv stacks sum up to 27*64 products in
  another order and take atol 1e-4, as in tests/test_torch_models.py;
* the plain versions of kernels #6 (tri_sample) and #7/#8 (renderer MLP)
  against the Pallas kernels in interpret mode at f32, with windows that
  hold every tap: rtol 1e-4 / atol 1e-5; the MLP's plain version at bf16
  against the Pallas kernels at their default bf16: 1e-3 of the output's
  magnitude (MLP_BF16_BAR); tri_sample's at bf16 against the Pallas kernel
  at its default bf16: 1e-6 of the output's magnitude (the same roundings;
  only the order of a four-term f32 sum may differ);
* the slice, BoostMVSNeRF and MVSNeRF at 64x96 (4 views, K=2 of C(4,3),
  pad 24, full MLP widths, 8 samples, every pixel): rgb PSNR > 45 dB, the
  model bar of tests/test_reference_parity.py. The JAX model takes its
  flat XLA path (no Pallas on the CPU). Its blend and colour masks compare
  projected pixels with the frame's edges, so a sample that lands within
  rounding of an edge can flip between the two packages; depth is held at
  1e-4 on 99% of the rays and 1e-2 on all of them.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from boostmvsnerfs_torch.models import mvsnerf as tm
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.ops import sampling as ts
from boostmvsnerfs_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from boostmvsnerfs_torch.ops.cuda.img_sample import fused_row_sample
from boostmvsnerfs_torch.ops.cuda.renderer_mlp import (
    bf16_layers,
    _f32_layout,
    fused_renderer_mlp,
    pack_mlp_weights,
    pack_mlp_weights_bf16,
    renderer_mlp_plain,
)
from boostmvsnerfs_torch.ops.cuda.tri_sample import fused_tri_sample, tri_sample_plain
from boostmvsnerfs_torch.utils.port_weights import mvsnerf_state_dict_from_jax, random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch
from boostmvsnerfs_tpu.models import mvsnerf as jm
from boostmvsnerfs_tpu.models.boost_mvsnerf import BoostMVSNeRF as JaxBoostMVSNeRF
from boostmvsnerfs_tpu.ops.pallas.mlp import fused_renderer_mlp as pallas_mlp
from boostmvsnerfs_tpu.ops.pallas.mlp import fused_renderer_mlp_rows as pallas_mlp_rows
from boostmvsnerfs_tpu.ops.pallas.tri_sample import fused_tri_sample as pallas_tri
from boostmvsnerfs_tpu.utils.port_weights import port_mvsnerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parents[1]
SLICE = dict(num_samples=8, k_best=2)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def weights():
    """(port MVSNeRF on the CPU with the weights carried back from JAX,
    the JAX variables)."""
    model = tm.MVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    variables = port_mvsnerf(random_state_dict(model, 0))
    model.load_state_dict(mvsnerf_state_dict_from_jax(variables), strict=True)
    return model, variables


@pytest.fixture(scope="module")
def batch():
    return mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, seed=0,
                                          rig="forward", render_scales=(1.0,)), k_best=(0, 3))


# ---------------------------------------------------------------- ops


def test_positional_encoding():
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (2, 50, 3)).astype(np.float32)
    got = tm.positional_encoding(*t(x), 10)
    assert got.shape == (2, 50, 63)
    close(got, jm.positional_encoding(*j(x), 10))


def test_mvs_proj_mats(batch):
    ixts, exts = batch["all_src_ixts"][:, :3], batch["all_src_exts"][:, :3]
    got = tm.mvs_proj_mats(*t(ixts, exts))
    close(got, jm.mvs_proj_mats(*j(ixts, exts)), atol=1e-4)
    assert np.array_equal(got[:, 0].numpy(), np.eye(4, dtype=np.float32)[None, :3])


@pytest.mark.parametrize("pad", [24, 0])
def test_ndc_coords(batch, pad):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (1, 200, 3)).astype(np.float32) + np.float32([0, 0, 2.5])
    near, far = np.float32([[[1.6]]]), np.float32([[[4.2]]])
    inv_scale = np.float32([95, 63])
    w2c, ixt = batch["all_src_exts"][:, 0], batch["all_src_ixts"][:, 0]
    got = tm.ndc_coords(*t(w2c, ixt, pts, inv_scale, near, far), pad, (16, 24))
    want = jm.ndc_coords(*j(w2c, ixt, pts, inv_scale, near, far), pad, (16, 24))
    close(got, want)


@pytest.mark.parametrize("hw,out", [((64, 96), (16, 24)), ((128, 96), (32, 24)),
                                    ((30, 44), (12, 20))])
def test_resize_is_jax_antialiased_bilinear(hw, out):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks."""
    x = np.random.default_rng(2).uniform(-1, 1, (3, *hw, 3)).astype(np.float32)
    got = ts.resize_antialiased(*t(x), *out)
    want = jax.image.resize(jnp.asarray(x), (3, *out, 3), method="bilinear")
    close(got, want)


def _jax_raw_volume(variables, cfg, *args):
    """The 41-channel volume that JAX ``build_volume`` hands its U-Net."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if isinstance(context.module, jm.MVSCostRegNet) and context.method_name == "__call__":
            seen["volume"] = args[0]
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(grab):
        jm.MVSNeRF(cfg).apply(variables, *args, False, method=jm.MVSNeRF.build_volume)
    return seen["volume"]


@pytest.mark.parametrize("H,W", [(64, 96), (128, 64)])
def test_raw_volume_matches_jax(weights, H, W):
    """Plane-sweep RGB and feature variance, (B, D, h+2p, w+2p, 41). At
    h = H/4 <= 32 the JAX windowed warp holds every tap, so both are the
    exact bilinear warp."""
    model, variables = weights
    b = mvsnerf_batch(make_scene_batch(B=1, n_views=3, H=H, W=W, boost=True, seed=4,
                                       rig="forward", render_scales=(1.0,)))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((1, 3, H // 4, W // 4, 32)).astype(np.float32)
    src = b["all_src_inps"]
    pm = np.asarray(jm.mvs_proj_mats(*j(b["all_src_ixts"], b["all_src_exts"])))
    near, far = b["near_far"][0]
    dv = np.linspace(near, far, 8, dtype=np.float32)[None]
    got = model.raw_volume(*t(src, feats, pm, dv))
    want = _jax_raw_volume(variables, jm.MVSNeRFConfig(**SLICE), *j(src, feats, pm, dv))
    assert got.shape == want.shape == (1, 8, H // 4 + 48, W // 4 + 48, 41)
    close(got, want)


# ------------------------------------------------------------- networks


def test_feature_net_matches_flax(weights):
    model, variables = weights
    x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.feature(*t(x))
    want = jm.MVSFeatureNet().apply({"params": variables["params"]["feature"],
                                     "batch_stats": variables["batch_stats"]["feature"]},
                                    jnp.asarray(x), False)
    assert got.shape == (2, 8, 12, 32)
    close(got, want, atol=1e-4)


def test_cost_reg_net_matches_flax(weights):
    model, variables = weights
    x = np.random.default_rng(7).standard_normal((1, 8, 16, 24, 41)).astype(np.float32)
    with torch.no_grad():
        got = model.cost_reg_2(*t(x))
    want = jm.MVSCostRegNet().apply({"params": variables["params"]["cost_reg"],
                                     "batch_stats": variables["batch_stats"]["cost_reg"]},
                                    jnp.asarray(x), False)
    assert got.shape == (1, 8, 16, 24, 8)
    close(got, want, atol=1e-4)


def _mlp_inputs(seed, B=2, N=384, width=63):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (B, N, width)).astype(np.float32)
    feat = rng.standard_normal((B, N, 20)).astype(np.float32)
    dirs = rng.standard_normal((B, N, 3)).astype(np.float32)
    return pts, feat, dirs


def test_renderer_mlp_module_matches_flax(weights):
    model, variables = weights
    pts, feat, dirs = _mlp_inputs(8)
    with torch.no_grad():
        got = model.nerf.nerf(*t(pts, feat, dirs))
    want = jm.RendererMLP(jm.MVSNeRFConfig()).apply(
        {"params": variables["params"]["renderer"]}, *j(pts, feat, dirs))
    close(got, want)


def test_renderer_mlp_other_depth_and_skip_match_flax():
    """A trunk other than the published one (the plain version reads depth
    and skips from the layer shapes; the kernel refuses it)."""
    cfg = dict(mlp_width=64, mlp_depth=4, skips=(1,), pos_freqs=4)
    mlp = tm.RendererMLP(tm.MVSNeRFConfig(**cfg), 20)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(mlp, 15).items()})
    params = {k: {"kernel": w.detach().numpy().T, "bias": b.detach().numpy()}
              for k, (w, b) in mlp.mlp_params().items()}
    pts, feat, dirs = _mlp_inputs(16, width=27)
    with torch.no_grad():
        got = mlp(*t(pts, feat, dirs))
    want = jm.RendererMLP(jm.MVSNeRFConfig(**cfg)).apply({"params": params}, *j(pts, feat, dirs))
    close(got, want)


def test_state_dict_round_trip_through_jax():
    model = BoostMVSNeRF(device="cpu")
    sd = random_state_dict(model, 9)
    back = mvsnerf_state_dict_from_jax(port_mvsnerf(sd))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == torch.from_numpy(v).dtype, k
        assert np.array_equal(back[k].numpy(), v), k
    model.load_state_dict(back, strict=True)


# --------------------------------------------------------- plain kernels


def _tri_case(seed, far=False):
    """Kernel #6's inputs: smooth per-row coordinate curves with
    out-of-volume excursions; with ``far``, also coordinates just outside
    each face, far outside and at +-1e10 (behind-camera projections)."""
    rng = np.random.default_rng(seed)
    B, Dp, Hp, Wp, C, R, T = 2, 10, 20, 24, 8, 6, 40
    vol = rng.standard_normal((B, Dp, Hp, Wp, C)).astype(np.float32)
    x = np.linspace(-2, Wp + 1, T)[None, None] + rng.normal(0, 0.3, (B, R, T))
    y = (np.arange(R) * 3.5)[None, :, None] + rng.normal(0, 0.8, (B, R, T))
    z = (np.arange(R) % 5 * 2.2)[None, :, None] + rng.normal(0, 0.2, (B, R, T))
    x, y, z = (a.astype(np.float32) for a in (x, y, z))
    if far:
        x[:, 0, :8] = [1e10, -1e10, -0.5, Wp - 0.5, Wp + 7, -1.0, 3.25, Wp - 1]
        y[:, 0, :8] = [2.5, -1e10, 1e10, -0.25, 4.5, Hp - 0.75, -3.0, Hp - 1]
        z[:, 0, :8] = [-1e10, 3.5, 1.0, Dp + 4, -0.5, Dp - 0.5, 1e10, Dp - 1]
    return vol, x, y, z


def test_tri_sample_plain_matches_pallas_interpret():
    """Kernel #6 with windows over the whole volume (exact everywhere)."""
    vol, x, y, z = _tri_case(10)
    B, Dp, Hp, Wp, C = vol.shape
    R, T = x.shape[1:]
    got = tri_sample_plain(*t(vol, np.stack([x, y, z], -1).reshape(B, R * T, 3)))
    want = pallas_tri(*j(vol, x, y, z), window_h=Hp, window_z=Dp,
                      compute_dtype=jnp.float32, interpret=True)
    close(got, np.asarray(want).reshape(B, R * T, C))


@pytest.mark.parametrize("seed,far", [(10, False), (3, True)])
def test_tri_sample_plain_bf16_matches_pallas_interpret(seed, far):
    """Kernel #6 at bf16, the Pallas kernel's default, with windows over the
    whole volume: the volume and the x tap weights rounded to bf16, each
    (y, z)-weighted tap row's partial rounded again. The same rounding at
    the same points; only the order of the final four-term f32 sum may
    differ, so max |error| <= 1e-6 of the output's largest magnitude."""
    vol, x, y, z = _tri_case(seed, far)
    B, Dp, Hp, Wp, C = vol.shape
    R, T = x.shape[1:]
    xyz = np.stack([x, y, z], -1).reshape(B, R * T, 3)
    got = tri_sample_plain(*t(vol, xyz), compute_dtype=torch.bfloat16).numpy()
    want = np.asarray(pallas_tri(*j(vol, x, y, z), window_h=Hp, window_z=Dp,
                                 interpret=True)).reshape(B, R * T, C)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # and it is bf16 rounding of the f32 sample, not another function
    f32 = tri_sample_plain(*t(vol, xyz)).numpy()
    assert 0 < np.abs(got - f32).mean() < 5e-3 * np.abs(f32).mean()


@pytest.mark.parametrize("encode_freqs", [0, 10])
def test_renderer_mlp_plain_matches_pallas_interpret(weights, encode_freqs):
    """Kernel #7: encoded input, or raw coordinates encoded in the kernel."""
    model, variables = weights
    pts, feat, dirs = _mlp_inputs(11, N=300, width=3 if encode_freqs else 63)
    with torch.no_grad():
        got = renderer_mlp_plain(model.nerf.nerf.mlp_params(), *t(pts, feat, dirs),
                                 encode_freqs=encode_freqs)
    want = pallas_mlp(variables["params"]["renderer"], *j(pts, feat, dirs), block=256,
                      compute_dtype=jnp.float32, interpret=True, encode_freqs=encode_freqs)
    close(got, want)


def test_renderer_mlp_plain_matches_pallas_rows_interpret(weights):
    """Kernel #8, rows layout: samples (r, t) of (B, R, C, T) planes; the
    plain version takes them flat, features [vox, (rgb, mask) per view]."""
    model, variables = weights
    rng = np.random.default_rng(12)
    B, R, T, V = 1, 3, 128, 3
    uvd = rng.uniform(-0.2, 1.2, (B, R, 3, T)).astype(np.float32)
    vox = rng.standard_normal((B, R, 8, T)).astype(np.float32)
    col = rng.uniform(0, 1, (B, V, R, 4, T)).astype(np.float32)
    dirs = rng.standard_normal((B, R, 3, T)).astype(np.float32)

    def flat(a):  # (B, R, C, T) -> (B, R*T, C)
        return np.moveaxis(a, -2, -1).reshape(B, R * T, -1)

    feat = np.concatenate([flat(vox)] + [flat(col[:, v]) for v in range(V)], -1)
    with torch.no_grad():
        got = renderer_mlp_plain(model.nerf.nerf.mlp_params(),
                                 *t(flat(uvd), feat, flat(dirs)), encode_freqs=10)
    want = pallas_mlp_rows(variables["params"]["renderer"], *j(uvd, vox, col, dirs),
                           compute_dtype=jnp.float32, interpret=True, encode_freqs=10)
    close(got, flat(np.asarray(want)))


# bf16 plain version vs the Pallas kernels at compute_dtype bf16 (interpret
# mode): both round the same operands and sum exactly products in float32,
# in another order, so where a sum straddles a bf16 rounding boundary the
# next layer's operand moves by one bf16 ulp. Measured on the CPU: at most
# 1.4e-4 of the output's magnitude; bar 1e-3 of it (at least 1).
MLP_BF16_BAR = 1e-3


@pytest.mark.parametrize("layout,encode_freqs", [("flat", 0), ("flat", 10), ("rows", 10)])
def test_renderer_mlp_plain_bf16_matches_pallas_bf16(weights, layout, encode_freqs):
    """Kernels #7 (flat, encoded or raw input) and #8 (rows layout) at their
    default compute dtype, bf16, against ``renderer_mlp_plain`` at bf16."""
    model, variables = weights
    params, renderer = model.nerf.nerf.mlp_params(), variables["params"]["renderer"]
    if layout == "flat":
        pts, feat, dirs = _mlp_inputs(15, N=300, width=3 if encode_freqs else 63)
        want = np.asarray(pallas_mlp(renderer, *j(pts, feat, dirs), block=256, interpret=True,
                                     compute_dtype=jnp.bfloat16, encode_freqs=encode_freqs))
    else:
        rng = np.random.default_rng(16)
        B, R, T, V = 1, 3, 128, 3
        uvd = rng.uniform(-0.2, 1.2, (B, R, 3, T)).astype(np.float32)
        vox = rng.standard_normal((B, R, 8, T)).astype(np.float32)
        col = rng.uniform(0, 1, (B, V, R, 4, T)).astype(np.float32)
        d = rng.standard_normal((B, R, 3, T)).astype(np.float32)

        def flat(a):  # (B, R, C, T) -> (B, R*T, C)
            return np.moveaxis(a, -2, -1).reshape(B, R * T, -1)

        pts, dirs = flat(uvd), flat(d)
        feat = np.concatenate([flat(vox)] + [flat(col[:, v]) for v in range(V)], -1)
        want = flat(np.asarray(pallas_mlp_rows(renderer, *j(uvd, vox, col, d), interpret=True,
                                               compute_dtype=jnp.bfloat16, encode_freqs=10)))
    with torch.no_grad():
        got = renderer_mlp_plain(params, *t(pts, feat, dirs), encode_freqs=encode_freqs,
                                 compute_dtype=torch.bfloat16).numpy()
        f32 = renderer_mlp_plain(params, *t(pts, feat, dirs), encode_freqs=encode_freqs).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= MLP_BF16_BAR * scale
    # bf16 is not f32: the same inputs at f32 differ by far more
    assert np.abs(f32 - want).max() > 10 * np.abs(got - want).max()


def test_renderer_mlp_bf16_buffers_hold_each_layer_where_the_kernel_reads_it(weights):
    """``pack_mlp_weights_bf16``: each buffer's (out, in) bf16 rows of the
    padded width + 8 at csrc/renderer_mlp.cu's offsets, the skip layer as
    two buffers (over enc, over h) and views_0's input as [feature, dir, 0];
    the vector buffer at the kernel's VEC_* offsets."""
    model, _ = weights
    params = model.nerf.nerf.mlp_params()
    mats, vecs = pack_mlp_weights_bf16(params)
    widths = [32, 64, 128, 128, 128, 128, 64, 128, 128, 144]  # F = 20 -> 32
    rows = [128] * 9 + [64]
    assert mats.dtype == torch.bfloat16 and mats.numel() == sum(
        r * (k + 8) for r, k in zip(rows, widths))
    at, bufs = 0, []
    for (name, k_pad, _), r, k in zip(bf16_layers(20), rows, widths, strict=True):
        assert k_pad == k
        bufs.append((name, mats[at:at + r * (k_pad + 8)].reshape(r, k_pad + 8).float()))
        at += r * (k_pad + 8)
    bf = lambda w: w.detach().to(torch.bfloat16).float()  # noqa: E731
    (_, pb), (_, enc5), (_, h5), (_, v0) = bufs[0], bufs[6], bufs[7], bufs[9]
    assert torch.equal(pb[:, :20], bf(params["pts_bias"][0])) and not pb[:, 20:].any()
    assert torch.equal(enc5[:, :63], bf(params["pts_5"][0][:, :63])) and not enc5[:, 63:].any()
    assert torch.equal(h5[:, :128], bf(params["pts_5"][0][:, 63:])) and not h5[:, 128:].any()
    assert torch.equal(v0[:, :131], bf(params["views_0"][0])) and not v0[:, 131:].any()
    for name, m in bufs[1:6] + bufs[8:9]:
        n_in = params[name][0].shape[1]
        assert torch.equal(m[:, :n_in], bf(params[name][0])) and not m[:, n_in:].any(), name
    assert vecs.numel() == 1416  # VEC_N
    assert torch.equal(vecs[128 * 8:128 * 8 + 64], params["views_0"][1].detach())  # VEC_V0
    assert torch.equal(vecs[1088:1216], bf(params["alpha"][0]).reshape(-1))  # VEC_AW
    assert torch.equal(vecs[1220:1412], bf(params["rgb"][0]).reshape(-1))  # VEC_RW
    assert torch.equal(vecs[1412:1415], params["rgb"][1].detach())  # VEC_RB


def test_renderer_mlp_f32_buffer_is_its_layout(weights):
    """``pack_mlp_weights`` gathers through its plan what the f32 kernel's
    layout gives on the values themselves: every layer, 4-float aligned."""
    model, _ = weights
    params = model.nerf.nerf.mlp_params()
    with torch.no_grad():
        got = pack_mlp_weights(params)
        want, = _f32_layout(params, None)
    n = sum(-(-t.numel() // 4) * 4 for pair in params.values() for t in pair)
    assert got.dtype == torch.float32 and got.numel() == n and torch.equal(got, want)


def test_renderer_mlp_rejects_other_compute_dtypes(weights):
    model, _ = weights
    pts, feat, dirs = t(*_mlp_inputs(17, N=20, width=3))
    with torch.no_grad():
        for call in (fused_renderer_mlp, renderer_mlp_plain):
            with pytest.raises(TypeError, match="compute_dtype"):
                call(model.nerf.nerf.mlp_params(), pts, feat, dirs, 10, torch.float16)


def test_new_wrappers_take_plain_on_cpu_and_do_not_count(weights):
    model, _ = weights
    reset_launch_counts()
    rng = np.random.default_rng(13)
    vol = torch.from_numpy(rng.standard_normal((1, 4, 5, 6, 8)).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-1, 6, (1, 30, 3)).astype(np.float32))
    assert torch.equal(fused_tri_sample(vol, xyz), tri_sample_plain(vol, xyz))
    assert torch.equal(fused_tri_sample(vol, xyz, 5), tri_sample_plain(vol, xyz))
    pts, feat, dirs = t(*_mlp_inputs(14, N=20, width=3))
    params = model.nerf.nerf.mlp_params()
    with torch.no_grad():
        assert torch.equal(fused_renderer_mlp(params, pts, feat, dirs, 10),
                           renderer_mlp_plain(params, pts, feat, dirs, 10))
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _meta_params(n_feat=20, depth=6):
    mlp = tm.RendererMLP(tm.MVSNeRFConfig(mlp_depth=depth), n_feat).to("meta")
    return mlp.mlp_params()


@pytest.mark.parametrize("call,error", [
    (lambda: fused_tri_sample(_meta(1, 4, 5, 6, 6), _meta(1, 10, 3)), ValueError),  # C % 4
    (lambda: fused_tri_sample(_meta(1, 4, 5, 6, 8), _meta(1, 10, 2)), ValueError),
    (lambda: fused_tri_sample(_meta(2, 4, 5, 6, 8), _meta(1, 10, 3)), ValueError),
    (lambda: fused_renderer_mlp(_meta_params(), _meta(1, 9, 3), _meta(1, 9, 20),
                                _meta(1, 9, 3), 0), ValueError),  # raw input, no encoding
    (lambda: fused_renderer_mlp(_meta_params(), _meta(1, 9, 63), _meta(1, 9, 20),
                                _meta(1, 9, 3), 10), ValueError),  # encoded twice
    (lambda: fused_renderer_mlp(_meta_params(), _meta(1, 9, 63), _meta(1, 8, 20),
                                _meta(1, 9, 3)), ValueError),
    (lambda: fused_renderer_mlp(_meta_params(depth=4), _meta(1, 9, 63), _meta(1, 9, 20),
                                _meta(1, 9, 3)), ValueError),  # not the published depth
    (lambda: fused_renderer_mlp(_meta_params(200), _meta(1, 9, 63), _meta(1, 9, 200),
                                _meta(1, 9, 3)), ValueError),  # features wider than 128
    (lambda: fused_renderer_mlp(_meta_params(80), _meta(1, 9, 63), _meta(1, 9, 80),
                                _meta(1, 9, 3)), ValueError),  # wider than the bf16 kernel stages
    (lambda: fused_tri_sample(_meta(1, 4, 5, 6, 8), _meta(1, 10, 3), 1, torch.float16),
     TypeError),
    (lambda: fused_tri_sample(_meta(1, 4, 5, 6, 8), _meta(1, 10, 3), 0), ValueError),
    (lambda: fused_tri_sample(_meta(1, 4, 5, 6, 8), _meta(1, 10, 3), 8.0), ValueError),
])
def test_new_wrappers_reject_bad_inputs_off_cpu(call, error):
    reset_launch_counts()
    with torch.no_grad(), pytest.raises(error):
        call()
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


# ------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def renders(weights, batch):
    """{model: (port outputs, JAX outputs)} for BoostMVSNeRF and MVSNeRF,
    same weights and batch."""
    plain, variables = weights
    boost = BoostMVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    boost.load_state_dict(plain.state_dict(), strict=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jm.MVSNeRFConfig(**SLICE)
    out = {}
    for name, model, jax_model in (("boost", boost, JaxBoostMVSNeRF(cfg)),
                                   ("plain", plain, jm.MVSNeRF(cfg))):
        got = {k: v.numpy() for k, v in model(batch).items()}
        want = jax_model.apply(variables, jbatch, False)
        out[name] = got, {k: np.asarray(v) for k, v in want.items()}
    return out


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_slice_outputs_match_jax_keys_and_shapes(renders, name):
    got, want = renders[name]
    assert got.keys() == want.keys() == {"rgb_level0", "depth_level0", "weights_level0"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
    assert got["rgb_level0"].shape == (1, 64 * 96, 3)


EDGE_TOL_PX = 1e-3  # far above the f32 rounding of a projection (~1e-5 px here)


@pytest.fixture(scope="module")
def ray_geometry(weights, batch):
    """{model: (edge (R,) bool, z (R, D))}: the rays with a sample whose
    projection into one of the views the model consults lies within
    EDGE_TOL_PX of a frame edge (where an in-frame mask can flip between
    the packages), and each ray's z values as its depth average takes
    them. Projections in float64 from the port's samples."""
    plain, _ = weights
    tb = to_tensors(batch, torch.device("cpu"))
    H, W = batch["all_src_inps"].shape[2:4]
    combos = {"plain": [np.arange(plain.cfg.n_views)],
              "boost": list(batch["combos"][batch["k_best"][0]])}
    out = {}
    for name, view_sets in combos.items():
        near_edge, zs = False, []
        for views in view_sets:
            near, far = plain.near_far(tb["depth_ranges"][:, views])
            with torch.no_grad():
                xyz, _, z = plain.sample_points({"src_inps": tb["all_src_inps"],
                                                 "tar_ext": tb["tar_ext"],
                                                 "tar_ixt": tb["tar_ixt"]},
                                                tb["ray_idx_0"], near, far)
            pts = xyz[0].double().numpy()  # (R, D, 3)
            zs.append(z[0].numpy())
            for v in views:
                ext = batch["all_src_exts"][0, v].astype(np.float64)
                pix = (pts @ ext[:3, :3].T + ext[:3, 3]) @ batch["all_src_ixts"][0, v].T
                x, y = pix[..., 0] / pix[..., 2], pix[..., 1] / pix[..., 2]
                dist = np.minimum.reduce([abs(x), abs(x - (W - 1)), abs(y), abs(y - (H - 1))])
                near_edge = near_edge | (dist < EDGE_TOL_PX).any(-1)
        out[name] = near_edge, np.mean(zs, axis=0)
    return out


def softmax_mean_span(z: np.ndarray) -> np.ndarray:
    """Per ray, the range of ``sum(softmax(w) * z)`` over all weights w in
    [0, 1]^D: the most a flipped mask can move an ENeRF-style depth, since
    every compositing weight stays in [0, 1]. The objective is linear-
    fractional in exp(w), so its extremes take exp(w) = e on the k largest
    (or smallest) z and 1 elsewhere, for some k."""
    z = np.sort(z, axis=-1)
    D = z.shape[-1]
    k = np.arange(D + 1)
    csum = np.concatenate([np.zeros_like(z[..., :1]), np.cumsum(z, -1)], -1)  # sum of k smallest
    total = csum[..., -1:]
    top = np.e * (total - csum[..., D - k]) + csum[..., D - k]  # e on the k largest
    bottom = np.e * csum[..., k] + (total - csum[..., k])  # e on the k smallest
    norm = np.e * k + (D - k)
    return (top / norm).max(-1) - (bottom / norm).min(-1)


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_slice_rgb_psnr_above_45db(renders, ray_geometry, name, record_property):
    got, want = renders[name]
    err = np.abs(got["rgb_level0"] - want["rgb_level0"])
    psnr = -10 * np.log10(np.mean(err**2))
    edge = ray_geometry[name][0]
    record_property("rgb_psnr_db", float(psnr))
    record_property("rgb_psnr_db_off_edge", float(-10 * np.log10(np.mean(err[0, ~edge] ** 2))))
    record_property("rgb_max_abs_err", float(err.max()))
    record_property("rays_off_by_1e-4", int((err.max(-1) > 1e-4).sum()))
    record_property("edge_rays", int(edge.sum()))
    assert psnr > 45.0
    assert 0.0 <= got["rgb_level0"].min() and got["rgb_level0"].max() <= 1.0


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_slice_depth_matches(renders, ray_geometry, name, record_property):
    """Rays away from every frame edge agree at 1e-4 + 1e-4 |depth|. A ray
    with a sample within rounding of an edge (the frame's border rays on
    the forward rig) can see a view's mask flip, and is held to the most a
    flip can move its depth (``softmax_mean_span``)."""
    got, want = renders[name]
    edge, z = ray_geometry[name]
    err = np.abs(got["depth_level0"] - want["depth_level0"])[0]
    off = ~edge
    record_property("depth_max_abs_err", float(err.max()))
    record_property("depth_max_abs_err_off_edge", float(err[off].max()))
    record_property("edge_rays", int(edge.sum()))
    assert 0 < edge.sum() < 0.1 * edge.size
    assert np.all(err[off] <= 1e-4 + 1e-4 * np.abs(want["depth_level0"][0, off]))
    assert np.all(err[edge] <= softmax_mean_span(z[edge]))


def test_entry_point_raises_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BoostMVSNeRF()
    assert BoostMVSNeRF(device="cpu").device.type == "cpu"


def test_chip_smoke_mvs_kernel_inputs_rehearse_on_cpu(weights, batch):
    """chip_smoke.py's MVSNeRF kernel inputs, taken from the model's stages,
    at the slice geometry: each wrapper accepts them (its plain version
    here) and the bytes/operations counts are positive."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    plain, _ = weights
    model = BoostMVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    model.load_state_dict(plain.state_dict(), strict=True)
    with torch.no_grad():
        inputs = smoke.mvs_kernel_inputs(model, to_tensors(batch, torch.device("cpu")))
        n = 64 * 96 * 8
        (_, (vol, xyz, samples_per_ray)), = inputs["tri_sample"]
        assert vol.shape == (2, 8, 64, 72, 8) and xyz.shape == (2, n, 3)
        assert samples_per_ray == 8
        (_, (*_, dtype)), = inputs["tri_sample/f32"]
        assert dtype == torch.float32
        (_, (imgs, x, y, mode)), = inputs["img_sample"]
        assert imgs.shape == (6, 64, 96, 3) and x.shape == y.shape == (6, n) and mode == "border"
        (_, (params, uvd, feat, dirs, freqs)), = inputs["renderer_mlp"]
        assert uvd.shape == (2, n, 3) and feat.shape == (2, n, 20) and freqs == 10
        (_, (_, enc, _, _, zero)), = inputs["renderer_mlp/encoded"]
        assert enc.shape == (2, n, 63) and zero == 0
        (_, (*_, dtype)), = inputs["renderer_mlp/f32"]
        assert dtype == torch.float32
        for entry, (name, _, _, work, *_) in smoke.MVS_KERNELS.items():
            wrapper = {"tri_sample": fused_tri_sample, "img_sample": fused_row_sample,
                       "renderer_mlp": fused_renderer_mlp}[name]
            (_, args), = inputs[entry]
            assert torch.isfinite(wrapper(*args)).all(), entry
            nbytes, *ops = work(*args)
            assert nbytes > 0 and sum(ops) > 0 and min(ops) >= 0, entry
