"""The port's networks and model utilities against the JAX package.

Weights are a seeded numpy state_dict under the reference names; the JAX
side gets them through the existing port_weights converters, the port
through load_state_dict. BatchNorm runs in eval mode. Conv stacks are held
at rtol 1e-4 / atol 1e-4 (sums over up to 27*64 products in another order);
the head at the op bar rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.models import boost_enerf as tbe
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.cost_reg_net import CostRegNet, MinCostRegNet
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.models.feature_net import FeatureNet
from boostmvsnerfs_torch.models.nerf_head import NeRFHead
from boostmvsnerfs_torch.utils import synthetic as tsyn
from boostmvsnerfs_torch.utils.port_weights import enerf_state_dict_from_jax, random_state_dict
from boostmvsnerfs_tpu.models import boost_enerf as jbe
from boostmvsnerfs_tpu.models import cost_reg_net as jcr
from boostmvsnerfs_tpu.models import feature_net as jfn
from boostmvsnerfs_tpu.models import nerf_head as jnh
from boostmvsnerfs_tpu.utils import port_weights as jpw
from boostmvsnerfs_tpu.utils import synthetic as jsyn

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def load(module: torch.nn.Module, sd: dict, prefix: str = "") -> torch.nn.Module:
    module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_feature_net_matches_flax():
    net = FeatureNet()
    sd = random_state_dict(net, 0, "feature_net.")
    params, stats = {}, {}
    jpw.port_feature_net(sd, params, stats)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    with torch.no_grad():
        got = load(net, sd, "feature_net.")(torch.from_numpy(x))
    want = jfn.FeatureNet().apply(
        {"params": params["feature_net"], "batch_stats": stats["feature_net"]}, jnp.asarray(x), False)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("minimal", [True, False])
def test_cost_reg_nets_match_flax(minimal):
    cin = 32 if minimal else 16
    net = MinCostRegNet(cin) if minimal else CostRegNet(cin)
    sd = random_state_dict(net, 2, "cost_reg_0.")
    params, stats = {}, {}
    jpw.port_cost_reg(sd, params, stats, "cost_reg_0", "reg", minimal=minimal)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 16, cin)).astype(np.float32)
    with torch.no_grad():
        feat, logits = load(net, sd, "cost_reg_0.")(torch.from_numpy(x))
    jnet = jcr.MinCostRegNet() if minimal else jcr.CostRegNet()
    jfeat, jlogits = jnet.apply({"params": params["reg"], "batch_stats": stats["reg"]},
                                jnp.asarray(x), False)
    close(feat, jfeat)
    close(logits, jlogits)


@pytest.mark.parametrize("feat_ch", [11, 35])
def test_nerf_head_module_matches_flax(feat_ch):
    head = NeRFHead(feat_ch)
    sd = random_state_dict(head, 4, "nerf_0.")
    params = {}
    jpw.port_nerf_head(sd, params, "nerf_0", "head")
    rng = np.random.default_rng(5)
    vox = rng.standard_normal((2, 50, 8)).astype(np.float32)
    feat = rng.standard_normal((2, 3, 50, feat_ch)).astype(np.float32)
    dirs = rng.standard_normal((2, 3, 50, 4)).astype(np.float32)
    with torch.no_grad():
        got = load(head, sd, "nerf_0.")(*map(torch.from_numpy, (vox, feat, dirs)))
    ifrd = np.concatenate([feat, dirs], -1).transpose(0, 2, 1, 3)
    want = jnh.NeRFHead(feat_ch=feat_ch).apply({"params": params["head"]},
                                               jnp.asarray(vox), jnp.asarray(ifrd))
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("viewdir_agg", [True, False])
def test_state_dict_round_trip_through_jax(viewdir_agg):
    model = BoostENeRF(CascadeConfig(viewdir_agg=viewdir_agg), device="cpu")
    sd = random_state_dict(model, 6)
    back = enerf_state_dict_from_jax(jpw.port_enerf(sd, viewdir_agg=viewdir_agg))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == torch.from_numpy(v).dtype, k
        assert np.array_equal(back[k].numpy(), v), k
    model.load_state_dict(back, strict=True)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(B=2, n_views=6, H=48, W=64, boost=True, k_best=4, rig="forward", seed=3),
    dict(n_views=4, boost=True, k_best=2, with_targets=True, ray_subsample={1: 100}, seed=9),
])
def test_make_scene_batch_equals_jax(kw):
    got, want = tsyn.make_scene_batch(**kw), jsyn.make_scene_batch(**kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    c = np.array([0.3, -0.2, 2.0])
    assert np.array_equal(tsyn.look_at_ext(c), jsyn.look_at_ext(c))


@pytest.mark.parametrize("n,i", [(4, 3), (6, 3), (5, 2)])
def test_view_combinations_equal_jax(n, i):
    got, want = tbe.view_combinations(n, i), jbe.view_combinations(n, i)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_search_k_best_equals_jax(k):
    rng = np.random.default_rng(k)
    masks = rng.uniform(0, 1, (6, 8, 10)).astype(np.float32) * (rng.uniform(0, 1, (6, 1, 1)) > 0.3)
    assert tbe.search_k_best(masks, k) == jbe.search_k_best(masks, k)
    assert tbe.search_k_best(np.zeros((3, 4, 4), np.float32), k) == [0]


@pytest.fixture(scope="module")
def bf16_renders():
    """The port's ENeRF with ``conv_dtype`` bfloat16 and float32, and JAX's
    with bfloat16, on the same weights and batch (32x64, 3 views, both
    levels rendered; JAX's exact path)."""
    from boostmvsnerfs_torch.models.enerf import ENeRF
    from boostmvsnerfs_torch.utils.port_weights import enerf_state_dict_from_jax
    from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
    from boostmvsnerfs_tpu.models.enerf import ENeRF as JaxENeRF

    cas = dict(volume_planes=(8, 8), render_if=(True, True))
    batch = tsyn.make_scene_batch(B=1, n_views=3, H=32, W=64, seed=1, rig="forward")
    variables = jpw.port_enerf(random_state_dict(ENeRF(CascadeConfig(**cas), device="cpu"), 1))
    out = {}
    for dtype in ("bfloat16", "float32"):
        model = ENeRF(CascadeConfig(conv_dtype=dtype, **cas), device="cpu")
        model.load_state_dict(enerf_state_dict_from_jax(variables), strict=True)
        out[dtype] = {k: v.numpy() for k, v in model(batch).items()}
    jax_model = JaxENeRF(cas=JaxCascadeConfig(
        warp_mode="gather", eval_sampling="gather", eval_head="xla", warp_dtype="float32",
        conv_dtype="bfloat16", **cas))
    want = jax.jit(lambda v, b: jax_model.apply(v, b, False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    out["jax_bfloat16"] = {k: np.asarray(v) for k, v in want.items()}
    return out


@pytest.mark.parametrize("level", [0, 1])
def test_bf16_convolutions_match_jax_bf16(bf16_renders, level, record_property):
    """JAX's own bar for its bf16 convolutions (tests/test_mixed_precision.py:
    the rgb mean absolute difference under 0.05) between the two bf16
    builds and between the port's bf16 and float32 builds; every output
    float32 and finite."""
    key = f"rgb_level{level}"
    got, jax_bf16, f32 = (bf16_renders[k][key] for k in ("bfloat16", "jax_bfloat16", "float32"))
    assert bf16_renders["bfloat16"].keys() == bf16_renders["jax_bfloat16"].keys()
    for k, v in bf16_renders["bfloat16"].items():
        assert v.dtype == np.float32 and np.isfinite(v).all(), k
    vs_jax, vs_f32 = float(np.abs(got - jax_bf16).mean()), float(np.abs(got - f32).mean())
    record_property("rgb_mean_abs_diff_vs_jax_bf16", vs_jax)
    record_property("rgb_mean_abs_diff_vs_f32", vs_f32)
    assert vs_jax < 0.05 and vs_f32 < 0.05
    assert vs_f32 > 0.0  # the convolutions did round


def test_bf16_convolutions_train_with_float32_state():
    """A train-mode backward through the bf16 FPN: the convolutions run in
    bf16 (the batch norms' inputs, seen by forward hooks), the gradients
    and BatchNorm statistics stay float32 and finite."""
    seen = set()
    net = FeatureNet(torch.bfloat16).train()
    hook = lambda m, inp, out: seen.update((inp[0].dtype, out.dtype))  # noqa: E731
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32))
    out = net(x)
    sum(v.square().mean() for v in out.values()).backward()
    for h in handles:
        h.remove()
    assert all(v.dtype == torch.float32 for v in out.values())
    assert seen == {torch.bfloat16}
    for name, p in net.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
    bn = net.conv0[0].bn
    assert bn.running_var.dtype == torch.float32 and bool((bn.running_var != 1).any())


def test_bf16_resize_keeps_rows_past_256_pixels():
    """The FPN's upsampling of bf16 features to 480x736 (``conv_dtype``
    bfloat16): taps computed in float32, so every output row interpolates
    two neighbours with weights summing to 1 (bf16 holds integers exactly
    only to 256; taps computed in bf16 fell past the row). The result is
    the float32 resize within bf16 rounding (the input, the weights, each
    pass's products and sums: 4 ulps of 1 at most, 2^-9 on average); JAX's
    bf16 matrices at this
    width sum rows to up to 3 (ROADMAP fault 14)."""
    from boostmvsnerfs_torch.ops.sampling import resize_bilinear
    from boostmvsnerfs_tpu.ops.sampling import _interp_matrix

    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 120, 184, 4)).astype(np.float32))
    got = resize_bilinear(x.to(torch.bfloat16), 480, 736)
    want = resize_bilinear(x, 480, 736)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert float(err.max()) < 2 ** -6 and float(err.mean()) < 2 ** -9
    assert float(np.asarray(_interp_matrix(736, 368, jnp.bfloat16), np.float32).sum(1).max()) == 3.0
