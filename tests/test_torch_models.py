"""The port's networks and model utilities against the JAX package.

Weights are a seeded numpy state_dict under the reference names; the JAX
side gets them through the existing port_weights converters, the port
through load_state_dict. BatchNorm runs in eval mode. Conv stacks are held
at rtol 1e-4 / atol 1e-4 (sums over up to 27*64 products in another order);
the head at the op bar rtol 1e-4 / atol 1e-5.
"""

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
