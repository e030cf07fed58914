"""The port's MVSNeRF renderer heads (``net_type`` v2, v1 / attention and
color_fusion) against the JAX package, on the CPU.

Weights: a seeded numpy state_dict of the port's model goes to JAX through
``mvsnerf_variables_from_state_dict`` and comes back through
``mvsnerf_state_dict_from_jax`` (a round trip that must return every
tensor exactly). Bars:

* the head modules (``MultiHeadAttention`` with and without its mask,
  ``RendererAttention``, ``RendererColorFusion``,
  ``RendererMLP(additive_bias=True)``) against flax on the same inputs:
  rtol 1e-4 / atol 1e-5;
* MVSNeRF and BoostMVSNeRF with each head at 64x96 (4 views, K=2 of
  C(4,3), pad 24, full MLP widths, 8 samples, every pixel; H/4 = 16 <= 32,
  so JAX's windowed warp is exact, ROADMAP fault 5): rgb PSNR > 45 dB,
  the model bar of tests/test_reference_parity.py;
* ``MVSNeRFConfig.from_cfg`` field by field against JAX's for each
  ``net_type``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import make_cfg
from boostmvsnerfs_torch.models import mvsnerf as tm
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.utils.port_weights import (
    mvsnerf_state_dict_from_jax,
    mvsnerf_variables_from_state_dict,
    random_state_dict,
)
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch
from boostmvsnerfs_tpu import config as jconfig
from boostmvsnerfs_tpu.models import mvsnerf as jm
from boostmvsnerfs_tpu.models.boost_mvsnerf import BoostMVSNeRF as JaxBoostMVSNeRF
from boostmvsnerfs_tpu.utils.port_weights import port_mvsnerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parents[1]
SLICE = dict(num_samples=8, k_best=2)
HEADS = ("v2", "v1", "attention", "color_fusion")
# v1 and attention build the same module
MODEL_HEADS = ("v2", "v1", "color_fusion")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this module (as in
    tests/test_torch_train_entry.py): several test processes share the
    machine's cores, and these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _port_model(net_type, cls=tm.MVSNeRF, seed=0):
    """(port model on the CPU with seeded weights, the JAX variables)."""
    model = cls(tm.MVSNeRFConfig(net_type=net_type, **SLICE), device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(model, seed).items()}
    model.load_state_dict(sd, strict=True)
    return model, mvsnerf_variables_from_state_dict(model.state_dict())


def _head_inputs(seed, B=2, N=96, V=3):
    """Encoded points, features [vox 8, (rgb, mask in {0, 1}) per view],
    view directions."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (B, N, 63)).astype(np.float32)
    feat = rng.standard_normal((B, N, 8 + 4 * V)).astype(np.float32)
    feat4 = feat[..., 8:].reshape(B, N, V, 4)
    feat4[..., 3] = rng.uniform(size=(B, N, V)) > 0.3
    feat[..., 8:] = feat4.reshape(B, N, 4 * V)
    dirs = rng.standard_normal((B, N, 3)).astype(np.float32)
    return pts, feat, dirs


# ---------------------------------------------------------------- heads


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_flax(masked):
    mha = tm.MultiHeadAttention(4, 12, 4, 4)
    mha.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(mha, 3).items()})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 3, 12)).astype(np.float32)
    mask = (rng.uniform(size=(40, 3, 1)) > 0.3).astype(np.float32) if masked else None
    params = {n: {"kernel": getattr(mha, n).weight.detach().numpy().T}
              for n in ("w_qs", "w_ks", "w_vs", "fc")}
    params["layer_norm"] = {"scale": mha.layer_norm.weight.detach().numpy(),
                            "bias": mha.layer_norm.bias.detach().numpy()}
    with torch.no_grad():
        got, got_attn = mha(*t(x, x, x), None if mask is None else torch.from_numpy(mask))
    want, want_attn = jm.MultiHeadAttention(4, 12, 4, 4).apply(
        {"params": params}, *j(x, x, x), None if mask is None else jnp.asarray(mask))
    close(got, want)
    close(got_attn, want_attn)


@pytest.mark.parametrize("net_type", HEADS)
def test_head_module_matches_flax(net_type):
    """Each head on encoded points, against flax's with the carried weights."""
    model, variables = _port_model(net_type)
    head = model.nerf.nerf
    flax_head = {"v2": lambda c: jm.RendererMLP(c, additive_bias=True),
                 "v1": jm.RendererAttention, "attention": jm.RendererAttention,
                 "color_fusion": jm.RendererColorFusion}[net_type]
    pts, feat, dirs = _head_inputs(5)
    with torch.no_grad():
        got = head(*t(pts, feat, dirs))
    want = flax_head(jm.MVSNeRFConfig(net_type=net_type)).apply(
        {"params": variables["params"]["renderer"]}, *j(pts, feat, dirs))
    assert got.shape == (2, 96, 4)
    close(got, want)


@pytest.mark.parametrize("net_type", HEADS)
def test_head_encodes_raw_coordinates(net_type):
    """Raw coordinates with ``encode_freqs`` equal the encoded input."""
    model, _ = _port_model(net_type)
    pts, feat, dirs = _head_inputs(6)
    raw = pts[..., :3]
    with torch.no_grad():
        got = model.nerf.nerf(*t(raw, feat, dirs), 10)
        want = model.nerf.nerf(tm.positional_encoding(*t(raw), 10), *t(feat, dirs))
    assert torch.equal(got, want)


def test_attention_trunk_adds_the_bias_without_skips():
    """The attention head's trunk: 11-channel ``pts_bias``, every layer
    W wide (no skip)."""
    model, _ = _port_model("v1")
    head = model.nerf.nerf
    assert head.pts_bias.in_features == 11
    assert [m.in_features for m in head.pts_linears] == [63] + [128] * 5
    assert head.color_attention.w_qs.in_features == 12
    assert tuple(head.weight_out.weight.shape) == (3, 12)
    cf = _port_model("color_fusion")[0].nerf.nerf
    assert [m.in_features for m in cf.pts_linears] == [63, 128, 128, 128, 128, 191]
    assert cf.ray_attention.w_qs.in_features == 20 and cf.feature_linear[0].out_features == 16


# -------------------------------------------------------------- weights


@pytest.mark.parametrize("net_type", tm.NET_TYPES)
@pytest.mark.parametrize("cls", [tm.MVSNeRF, BoostMVSNeRF])
def test_state_dict_round_trip_through_jax(net_type, cls):
    """port state_dict -> JAX variables -> port, every tensor exact, and
    the JAX tree is the one flax builds for that head (same leaves and
    shapes)."""
    model, variables = _port_model(net_type, cls)
    back = mvsnerf_state_dict_from_jax(variables)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    jcls = JaxBoostMVSNeRF if cls is BoostMVSNeRF else jm.MVSNeRF
    shapes = jax_shapes(jcls(jm.MVSNeRFConfig(net_type=net_type, eval_sampling="gather",
                                              **SLICE)), batch)
    ours = {"/".join(p): np.shape(v) for p, v in _leaves(variables)}
    assert ours == shapes


def jax_shapes(model, batch) -> dict:
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, False))
    return {"/".join(p): tuple(v.shape) for p, v in _leaves(tree)}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_v0_carrier_matches_port_mvsnerf():
    """For v0 the port's carrier and the JAX package's ``port_mvsnerf`` give
    the same tree."""
    model, variables = _port_model("v0")
    want = port_mvsnerf(random_state_dict(model, 0))
    assert dict(_leaves(variables)).keys() == dict(_leaves(want)).keys()
    for path, v in _leaves(want):
        node = variables
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, np.asarray(v), err_msg="/".join(path))


# ------------------------------------------------------------- the models


def _batch(H=64, W=96):
    return mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=H, W=W, boost=True, seed=0,
                                          rig="forward", render_scales=(1.0,)), k_best=(0, 3))


@pytest.fixture(scope="module")
def renders():
    """{(net_type, model): (port rgb, JAX rgb)} at 64x96, same weights."""
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for net_type in MODEL_HEADS:
        for name, cls, jcls in (("plain", tm.MVSNeRF, jm.MVSNeRF),
                                ("boost", BoostMVSNeRF, JaxBoostMVSNeRF)):
            model, variables = _port_model(net_type, cls)
            got = model(batch)["rgb_level0"].numpy()
            want = jcls(jm.MVSNeRFConfig(net_type=net_type, **SLICE)).apply(
                variables, jbatch, False)["rgb_level0"]
            out[net_type, name] = got, np.asarray(want)
    return out


@pytest.mark.parametrize("net_type", MODEL_HEADS)
@pytest.mark.parametrize("name", ["plain", "boost"])
def test_model_rgb_psnr_above_45db(renders, net_type, name, record_property):
    got, want = renders[net_type, name]
    assert got.shape == want.shape == (1, 64 * 96, 3)
    rgb_max = 3.0 if net_type == "color_fusion" else 1.0  # a sigmoid colour per view, summed
    assert np.isfinite(got).all() and 0.0 <= got.min() and got.max() <= rgb_max
    psnr = -10 * np.log10(np.mean((got - want) ** 2))
    record_property("rgb_psnr_db", float(psnr))
    assert psnr > 45.0


# ------------------------------------------------------------- the config


@pytest.mark.parametrize("net_type", tm.NET_TYPES)
@pytest.mark.parametrize("path", ["configs/exps/evaluate/mvsnerf_ours/free_eval.yaml",
                                  "configs/exps/finetune/mvsnerf/free/base.yaml"])
def test_from_cfg_matches_jax_for_each_net_type(monkeypatch, net_type, path):
    monkeypatch.chdir(REPO)
    opts = ["mvsnerf.net_type", net_type]
    got = _fields(tm.MVSNeRFConfig.from_cfg(make_cfg(path, opts)))
    want = _fields(jm.MVSNeRFConfig.from_cfg(jconfig.make_cfg(path, opts)))
    assert got["net_type"] == net_type
    assert got == {k: want[k] for k in got}
    model = runner.make_network(make_cfg(path, opts), "cpu")
    assert type(model.nerf.nerf) is type(tm.HEADS[net_type](model.cfg, 20))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_unknown_net_type_raises():
    with pytest.raises(ValueError, match="net_type"):
        tm.MVSNeRFConfig(net_type="v3")
