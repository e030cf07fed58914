"""MVSNeRF and BoostMVSNeRF training in the port against the JAX package,
on the CPU.

The reference step is assembled here: JAX's ``make_train_step`` reads
``model.cas``, which the flax MVSNeRF does not have, so it raises before
its first step on every MVSNeRF (ROADMAP fault 15,
``test_jax_make_train_step_fails_on_mvsnerf``). It is the JAX train-mode
forward (``model.apply(variables, batch, True, mutable=['batch_stats'])``,
batch-statistics BatchNorm, the XLA gathers and MLP) and JAX's
``enerf_loss`` under the recipe's ``CascadeConfig`` loss settings
(configs/exps/finetune/mvsnerf_ours/free/base.yaml: ``loss_weight (1.0,)``,
``num 1``, ``render_if (True,)``, ``train_img (False,)``), differentiated by
``jax.value_and_grad`` (jitted), then ``make_optimizer``'s optax chain
(clip at 40, Adam at lr 5e-5). The port takes ``make_train_step(model,
cas=...)``: the volume lookup and the MLP in their plain versions under
autograd, the colour lookup through ``fused_row_sample``.

The slice: 32x64, 4 views (plain MVSNeRF builds its volume from the first
3; BoostMVSNeRF folds K=2 of C(4,3)), 8 planes and samples, pad 24, the
published MLP widths, 256 random rays with targets, the target camera
between source frames 1 and 2. Comparisons in float64 on both sides, as in
tests/test_torch_train.py: loss rtol 1e-4; per-tensor gradient relative L2
<= 1e-3 (relative to max(|g|, 1e-5 of the largest tensor's |g|)); the
BatchNorm statistics after the step rtol 1e-4 / atol 1e-6; the parameters
after one Adam step rtol 2e-3 / atol 2e-6 plus Adam's amplification of
their own gradient difference.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import make_cfg
from boostmvsnerfs_torch.models import mvsnerf as tm
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.parallel import train as tt
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.train.schedule import make_optimizer as torch_optimizer
from boostmvsnerfs_torch.utils.port_weights import (
    mvsnerf_state_dict_from_jax,
    mvsnerf_variables_from_state_dict,
    random_state_dict,
)
from boostmvsnerfs_torch.utils.synthetic import (
    look_at_ext,
    make_scene_batch,
    mvsnerf_batch,
    write_free_scene,
)
from boostmvsnerfs_tpu import config as jconfig
from boostmvsnerfs_tpu.models import mvsnerf as jm
from boostmvsnerfs_tpu.models.boost_mvsnerf import BoostMVSNeRF as JaxBoostMVSNeRF
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.ops import cost_volume as jcost_volume
from boostmvsnerfs_tpu.ops import sampling as jsampling
from boostmvsnerfs_tpu.parallel import train as jt
from boostmvsnerfs_tpu.train.loss import enerf_loss as jax_enerf_loss
from boostmvsnerfs_tpu.train.schedule import make_optimizer as jax_optimizer

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
RECIPE = "configs/exps/finetune/mvsnerf_ours/free/base.yaml"
PLAIN_RECIPE = "configs/exps/finetune/mvsnerf/free/base.yaml"
SLICE = dict(num_samples=8, k_best=2)
TRAIN_CFG = {"lr": 5e-5, "optim": "adam", "eps": 1e-8}
EP_ITER = 500
CASES = [("plain", "v0"), ("boost", "v0"), ("boost", "color_fusion")]


def _recipe_cfg(path=RECIPE, *opts, jax_side=False):
    old = os.getcwd()
    os.chdir(REPO)
    try:
        return (jconfig.make_cfg if jax_side else make_cfg)(path, list(opts))
    finally:
        os.chdir(old)


def _walk(t):  # the forward rig's camera path (utils/synthetic.py)
    return np.array([0.15 * np.sin(0.5 * t), 0.04 * np.cos(0.9 * t), 0.25 * t])


def _batch(H=32, W=64, rays=256, seed=0):
    """4 views, K=2 of C(4,3), ``rays`` random rays with targets."""
    b = make_scene_batch(B=1, n_views=4, H=H, W=W, boost=True, seed=seed, rig="forward",
                         render_scales=(1.0,), ray_subsample={0: rays}, with_targets=True)
    out = mvsnerf_batch(b, k_best=(0, 3))
    out["ray_idx_0"], out["rgb_0"] = b["ray_idx_0"], b["rgb_0"]
    out["tar_ext"] = look_at_ext(_walk(1.5), target=_walk(1.5) + np.array([0.0, 0.0, 5.0]))[None]
    return out


def _rel_l2(got, want, floor=0.0):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-300))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this module (as in
    tests/test_torch_train_entry.py): several test processes share the
    machine's cores. The comparisons here are float64, or float32 losses."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cas():
    """The recipe's loss settings, in each package."""
    return (CascadeConfig.from_cfg(_recipe_cfg().enerf),
            JaxCascadeConfig.from_cfg(_recipe_cfg(jax_side=True).enerf))


def _port_model(name, net_type, dtype=torch.float32):
    cls = BoostMVSNeRF if name == "boost" else tm.MVSNeRF
    return cls(tm.MVSNeRFConfig(net_type=net_type, **SLICE), device="cpu").to(dtype)


def _variables(net_type):
    return mvsnerf_variables_from_state_dict(
        {k: torch.from_numpy(v) for k, v in random_state_dict(_port_model("boost", net_type),
                                                              0).items()})


def _port_step(name, net_type, variables, batch, port_cas, dtype=torch.float64):
    """One port step: (stats, gradients as the step applied them (clipped),
    state_dict after the step)."""
    model = _port_model(name, net_type, dtype)
    model.load_state_dict(mvsnerf_state_dict_from_jax(variables), strict=True)
    state = tt.create_train_state(model, torch_optimizer(TRAIN_CFG, EP_ITER))
    stats = tt.make_train_step(model, cas=port_cas)(state, batch)
    return ({k: float(v) for k, v in stats.items()},
            {k: p.grad.double().numpy() for k, p in model.named_parameters()},
            {k: v.double().numpy() for k, v in model.state_dict().items()})


def _exact_warp(src_feat, x, y, window_h, window_w, compute_dtype=None):
    """JAX's exact bilinear warp (zeros padding) in the place of its
    windowed one, which fails under ``jax.enable_x64`` (int32 and int64
    window offsets). Where the window holds the whole feature map (H/4 <=
    32, MVSNeRF's ``window_h``) the two are the same function
    (``test_exact_warp_stands_in_for_the_windowed_one``)."""
    out = jsampling.grid_sample_2d(src_feat, jnp.stack([x, y], -1).reshape(-1, 2), "zeros")
    return out.reshape(*x.shape, src_feat.shape[-1])


def _jax_loss_fn(model, variables, jb, c):
    """The JAX train-mode forward and ``enerf_loss`` as a function of the
    parameters: (loss, (updated batch statistics, stats))."""

    def loss_fn(params):
        out, mutated = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jb, True, mutable=["batch_stats"])
        loss, stats = jax_enerf_loss(out, jb, c.loss_weight, c.num, c.render_if, None, None,
                                     c.train_img)
        return loss, (mutated["batch_stats"], stats)

    return loss_fn


def _jax_step(name, net_type, variables, batch, jax_cas):
    """The reference step in float64: (stats, clipped gradients and the
    variables after the step, both as port state_dicts)."""
    cls = JaxBoostMVSNeRF if name == "boost" else jm.MVSNeRF
    model = cls(jm.MVSNeRFConfig(net_type=net_type, **SLICE))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcost_volume, "windowed_warp_from_coords", _exact_warp)
        jb = {k: jnp.asarray(v, jnp.float64 if np.issubdtype(np.asarray(v).dtype, np.floating)
                             else None) for k, v in batch.items()}
        var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        loss_fn = _jax_loss_fn(model, var, jb, jax_cas)
        (_, (new_stats, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            var["params"])
        tx = jax_optimizer(TRAIN_CFG, EP_ITER)
        updates, _ = tx.update(grads, tx.init(var["params"]), var["params"])
        new_params = optax.apply_updates(var["params"], updates)
        to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
        g_sd = mvsnerf_state_dict_from_jax({"params": to_np(grads),
                                            "batch_stats": to_np(var["batch_stats"])})
        new_sd = mvsnerf_state_dict_from_jax({"params": to_np(new_params),
                                              "batch_stats": to_np(new_stats)})
    return ({k: float(v) for k, v in stats.items()},
            {k: np.clip(v.numpy(), -40.0, 40.0) for k, v in g_sd.items()},
            {k: v.numpy() for k, v in new_sd.items()})


@pytest.fixture(scope="module")
def steps(cas):
    """{(model, net_type): (port result, JAX result)} in float64."""
    batch = _batch()
    out = {}
    for name, net_type in CASES:
        variables = _variables(net_type)
        out[name, net_type] = (_port_step(name, net_type, variables, batch, cas[0]),
                               _jax_step(name, net_type, variables, batch, cas[1]))
    return out


@pytest.mark.parametrize("name,net_type", CASES)
def test_step_loss_matches_jax(steps, name, net_type):
    (got, _, _), (want, _, _) = steps[name, net_type]
    assert got.keys() == want.keys() == {"color_mse_0", "psnr_0", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("name,net_type", CASES)
def test_step_gradients_match_jax(steps, name, net_type, record_property):
    (_, got, _), (_, want, _) = steps[name, net_type]
    assert got.keys() == {k for k in want if "running" not in k and "num_batches" not in k}
    floor = 1e-5 * max(np.linalg.norm(w) for w in want.values())
    errs = {k: _rel_l2(got[k], want[k], floor) for k in got}
    worst = max(errs, key=errs.get)
    record_property("worst_gradient_rel_l2", f"{worst} {errs[worst]:.3e}")
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    for part in ("feature.", "cost_reg_2.", "nerf.nerf.pts_bias", "nerf.nerf.pts_linears.0"):
        assert any(np.abs(g).max() > 0 for k, g in got.items() if k.startswith(part)), part


@pytest.mark.parametrize("name,net_type", CASES)
def test_step_batch_stats_and_params_match_jax(steps, name, net_type):
    """BatchNorm statistics after the step (flax's biased running
    variance), and the parameters after one Adam step (held as in
    tests/test_torch_train.py)."""
    (_, g_got, got), (_, g_want, want) = steps[name, net_type]
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
            continue
        amplified = TRAIN_CFG["lr"] / TRAIN_CFG["eps"] * np.abs(g_got[k] - g_want[k])
        bad = np.abs(got[k] - w) > 2e-6 + 2e-3 * np.abs(w) + amplified
        assert not bad.any(), (k, np.abs(got[k] - w)[bad].max())
    moved = [k for k in got if "running" in k and not np.array_equal(got[k], _start(net_type)[k])]
    assert moved, "train-mode BatchNorm left the running statistics"


def _start(net_type):
    return {k: v.double().numpy() for k, v in mvsnerf_state_dict_from_jax(
        _variables(net_type)).items()}


@pytest.mark.parametrize("hw", [(8, 16), (16, 24), (32, 48)])
def test_exact_warp_stands_in_for_the_windowed_one(hw):
    """In float32, where it runs, JAX's windowed warp as MVSNeRF calls it
    (``window_h`` 32, ``window_w`` the map's width) equals the exact warp
    on feature maps of H/4 <= 32, coordinates in and around the map."""
    h, w = hw
    rng = np.random.default_rng(h)
    img = jnp.asarray(rng.standard_normal((h, w, 32)).astype(np.float32))
    D, hp, wp = 4, h + 48, w + 48
    x = jnp.asarray(rng.uniform(-3, w + 2, (D, hp, wp)).astype(np.float32))
    y = jnp.asarray(rng.uniform(-3, h + 2, (D, hp, wp)).astype(np.float32))
    got = jcost_volume.windowed_warp_from_coords(img, x, y, window_h=32, window_w=w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(_exact_warp(img, x, y, 32, w)),
                               rtol=1e-5, atol=1e-5)


def test_float32_step_loss_matches_jax(cas):
    """The float32 step (the card's precision) against the float64
    reference: the loss."""
    batch = _batch()
    variables = _variables("v0")
    got = _port_step("boost", "v0", variables, batch, cas[0], torch.float32)[0]
    want = _jax_step("boost", "v0", variables, batch, cas[1])[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


# ---------------------------------------------------------------- routing


class _Spy:
    """Counts the calls of a wrapper the model module calls."""

    def __init__(self, fn, raises=False):
        self.fn, self.raises, self.calls = fn, raises, 0

    def __call__(self, *args, **kw):
        if self.raises:
            raise AssertionError(f"{self.fn.__name__} reached in train mode")
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("name", ["plain", "boost"])
def test_train_mode_never_reaches_the_kernels_without_backward(monkeypatch, cas, name):
    """In train mode the render takes the plain volume lookup and MLP: with
    ``fused_tri_sample`` and ``fused_renderer_mlp`` made to raise, a step
    still runs; the colour lookup goes through ``fused_row_sample`` once."""
    row = _Spy(tm.fused_row_sample)
    monkeypatch.setattr(tm, "fused_tri_sample", _Spy(tm.fused_tri_sample, raises=True))
    monkeypatch.setattr(tm, "fused_renderer_mlp", _Spy(tm.fused_renderer_mlp, raises=True))
    monkeypatch.setattr(tm, "fused_row_sample", row)
    model = _port_model(name, "v0")
    model.load_state_dict(mvsnerf_state_dict_from_jax(_variables("v0")))
    state = tt.create_train_state(model, torch_optimizer(TRAIN_CFG, EP_ITER))
    stats = tt.make_train_step(model, cas=cas[0])(state, _batch(32, 64, rays=64))
    assert np.isfinite(float(stats["loss"])) and state.step == 1 and row.calls == 1


@pytest.mark.parametrize("net_type", tm.NET_TYPES)
def test_eval_frame_calls_each_kernel_once(monkeypatch, net_type):
    """An eval frame calls ``fused_tri_sample`` and ``fused_row_sample``
    once each, and ``fused_renderer_mlp`` once for v0 and never for the
    other heads (plain MLPs on every device)."""
    spies = {n: _Spy(getattr(tm, n)) for n in ("fused_tri_sample", "fused_row_sample",
                                               "fused_renderer_mlp")}
    for n, spy in spies.items():
        monkeypatch.setattr(tm, n, spy)
    model = BoostMVSNeRF(tm.MVSNeRFConfig(net_type=net_type, **SLICE), device="cpu")
    out = model(_batch(32, 64, rays=64))
    assert torch.isfinite(out["rgb_level0"]).all()
    assert {n: s.calls for n, s in spies.items()} == {
        "fused_tri_sample": 1, "fused_row_sample": 1,
        "fused_renderer_mlp": int(net_type in tm.KERNEL_HEADS)}


def test_jax_make_train_step_fails_on_mvsnerf():
    """ROADMAP fault 15: JAX's ``make_train_step`` reads ``model.cas``, and
    the flax MVSNeRF has none, so JAX's ``run_train`` raises on every
    MVSNeRF config before its first step. This is why the reference step
    above is assembled in the test."""
    for model in (jm.MVSNeRF(jm.MVSNeRFConfig()), JaxBoostMVSNeRF(jm.MVSNeRFConfig())):
        with pytest.raises(AttributeError, match="cas"):
            jt.make_train_step(model, optax.adam(1e-3))


def test_plain_mvsnerf_draws_raised_to_its_views():
    """ROADMAP fault 16: the recipes' view counts [2, 3, 4] give the plain
    MVSNeRF 2-view batches, which its U-Net (9 + 32 input channels) cannot
    take, in JAX as in the port; the port draws 3 views instead, from the
    same random stream. A 4-view draw takes the first 3 views."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    model = jm.MVSNeRF(jm.MVSNeRFConfig(**SLICE))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, False))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    two = dict(batch, **{k: batch[k][:, :2] for k in ("all_src_inps", "all_src_exts",
                                                      "all_src_ixts", "depth_ranges")})
    with pytest.raises(Exception, match="shape"):
        jax.eval_shape(lambda: model.apply(variables, two, True, mutable=["batch_stats"]))
    cfg = _recipe_cfg(PLAIN_RECIPE, "workspace", "/nonexistent", "scene", "grass")
    assert cfg.train.sampler_meta.input_views_num == [2, 3, 4]
    loader_kw = {}

    class Probe:
        def __init__(self, ds, **kw):
            loader_kw.update(kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "Loader", Probe)
        runner.train_loader(cfg, None)
    assert loader_kw["input_views_num"] == [3, 3, 4]
    assert loader_kw["input_views_prob"] == [0.1, 0.8, 0.1]


def test_view_selection_covers_the_whole_target_on_random_rays():
    """ROADMAP fault 17: the pre-pass over the recipe's train views gets
    batches of random rays. JAX's coverage mask reshapes those rays to the
    image and fails; the port's covers every pixel of the target whatever
    rays the batch renders, so a random-ray batch gives the masks of the
    full-raster one."""
    full = _batch(32, 64, rays=64)
    full["ray_idx_0"] = np.arange(32 * 64, dtype=np.int32)[None]
    rays = _batch(32, 64, rays=64)
    model = BoostMVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    combos = full["combos"]
    assert torch.equal(model.forward_view_selection(rays, combos),
                       model.forward_view_selection(full, combos))
    jmodel = JaxBoostMVSNeRF(jm.MVSNeRFConfig(**SLICE))
    jb = {k: jnp.asarray(v) for k, v in rays.items()}
    with pytest.raises(TypeError, match="reshape"):
        jmodel.apply({}, jb, jnp.asarray(combos), method=JaxBoostMVSNeRF.forward_view_selection)
    want = jmodel.apply({}, {k: jnp.asarray(v) for k, v in full.items()}, jnp.asarray(combos),
                        method=JaxBoostMVSNeRF.forward_view_selection)
    np.testing.assert_allclose(model.forward_view_selection(full, combos).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the entry (YAML)

ENTRY_OPTS = ["train_dataset.input_h_w", "[32, 64]", "test_dataset.input_h_w", "[32, 64]",
              "train.num_workers", "2", "ep_iter", "2", "eval_ep", "1", "log_interval", "1",
              "save_ep", "1", "eval_lpips", "0"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("mvs"))
    write_free_scene(f"{ws}/Free", "grass")
    return ws


def test_recipe_train_batches_match_jax(scene):
    """The random-ray batches of the mvsnerf_ours recipe (``train_img``
    false, 1024 rays per image) from the port's ``train_loader`` equal JAX's
    ``Loader``'s for the same seed: ray ids, their colours, depth ranges
    and every other array."""
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_tpu.data import make_dataset as jax_make_dataset
    from boostmvsnerfs_tpu.data.loader import Loader as JaxLoader

    opts = ["workspace", scene, "scene", "grass", *ENTRY_OPTS, "train.batch_size", "2"]
    cfg, jcfg = _recipe_cfg(RECIPE, *opts), _recipe_cfg(RECIPE, *opts, jax_side=True)
    loader = runner.train_loader(cfg, make_dataset(cfg, "train"))
    meta = jcfg.train.sampler_meta
    jloader = JaxLoader(jax_make_dataset(jcfg, "train"), batch_size=2, shuffle=True, ep_iter=2,
                        input_views_num=runner.boost_views_num(meta.input_views_num, 3),
                        input_views_prob=meta.input_views_prob, num_workers=2)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for got, want in zip(loader, jloader, strict=True):
            assert got["ray_idx_0"].shape == (2, 1024) and "tar_img" not in got
            assert got.keys() == want.keys()
            for k in ("ray_idx_0", "rgb_0", "depth_ranges"):
                assert np.array_equal(got[k], want[k]), k
            for k, v in want.items():
                if k != "meta":
                    assert np.array_equal(got[k], v), k


@pytest.fixture(scope="module")
def entry(scene):
    """``python -m boostmvsnerfs_torch.train --device cpu`` over the
    mvsnerf_ours recipe at 32x64 (batch 4, K=4, 1024 random rays, lr 5e-5):
    one epoch of 2 steps from seeded ``pretrain: mvsnerf`` weights, then a
    second run with ``train.epoch 2`` that resumes."""
    from boostmvsnerfs_torch.train import __main__ as tmain

    argv = ["--device", "cpu", "--cfg_file", RECIPE, "workspace", scene, "scene", "grass",
            *ENTRY_OPTS]
    cfg = _recipe_cfg(RECIPE, *argv[4:])
    sd = random_state_dict(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(f"{scene}/trained_model/pretrain/mvsnerf").save(
        {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, 0)
    records = []

    def on_record(kind, state, r):
        records.append((kind, r))

    old = os.getcwd()
    os.chdir(REPO)
    mp = pytest.MonkeyPatch()
    run_train = runner.run_train
    mp.setattr(runner, "run_train", lambda c, **kw: run_train(c, on_record=on_record, **kw))
    try:
        first = tmain.main([*argv, "train.epoch", "1"])
        resumed = tmain.main([*argv, "train.epoch", "2"])
    finally:
        mp.undo()
        os.chdir(old)
    return {"cfg": cfg, "sd": sd, "records": records, "first": first, "resumed": resumed}


def test_run_train_trains_saves_resumes_and_validates(entry):
    records, cfg = entry["records"], entry["cfg"]
    assert [(kind, r["epoch"]) for kind, r in records] == [
        ("train", 0), ("train", 0), ("val", 0), ("train", 1), ("train", 1), ("val", 1)]
    assert all(np.isfinite(r["loss"]) for kind, r in records if kind == "train")
    assert all(np.isfinite(r["val_psnr"]) for kind, r in records if kind == "val")
    assert entry["first"].step == 2 and entry["resumed"].step == 4
    assert CheckpointManager(cfg.trained_model_dir).numbered_epochs() == [0, 1]
    moved = CheckpointManager(cfg.trained_model_dir).restore()["model"]
    assert all(any(not np.array_equal(moved[k].numpy(), v) for k, v in entry["sd"].items()
                   if k.startswith(part)) for part in ("feature.", "cost_reg_2.", "nerf.nerf."))
    vs = runner.load_view_selection(cfg)
    train_views = [i for i in range(16) if i % 8]
    assert sorted(vs) == sorted(f"grass_{i}" for i in [0, 8] + train_views)
    assert all(vs[f"grass_{i}"] == [0, 0, 0, 0] for i in train_views)  # 3 views: C(3,3) = 1


@pytest.mark.parametrize("net_type", ["v0", "v2"])
def test_plain_mvsnerf_recipe_trains(scene, net_type):
    """The plain MVSNeRF recipe (configs/exps/finetune/mvsnerf/free/base.yaml)
    at 32x64: a step and a validation, warm-started from the pretrain
    weights where names and shapes match."""
    cfg = _recipe_cfg(PLAIN_RECIPE, "workspace", scene, "scene", "grass", *ENTRY_OPTS,
                      "train.batch_size", "2", "ep_iter", "1", "train.epoch", "1",
                      "mvsnerf.net_type", net_type, "exp_name_tag", f"plain_{net_type}")
    records = []
    old = os.getcwd()
    os.chdir(REPO)
    try:
        state = runner.run_train(cfg, device="cpu", on_record=lambda k, s, r: records.append(k))
    finally:
        os.chdir(old)
    assert state.step == 1 and records == ["train", "val"]


@pytest.mark.parametrize("net_type", ["v1", "color_fusion"])
def test_eval_entry_takes_every_head(scene, net_type):
    """``python -m boostmvsnerfs_torch.run --type evaluate`` over the
    mvsnerf_ours eval config with ``mvsnerf.net_type``: the pre-pass and
    both test views."""
    from boostmvsnerfs_torch import run as trun

    old = os.getcwd()
    os.chdir(REPO)
    try:
        out = trun.main(["--type", "evaluate", "--device", "cpu", "--cfg_file",
                         "configs/exps/evaluate/mvsnerf_ours/free_eval.yaml", "workspace", scene,
                         "scene", "grass", "test_dataset.input_h_w", "[32, 64]", "eval_lpips", "0",
                         "mvsnerf.net_type", net_type, "exp_name_tag", f"eval_{net_type}"])
    finally:
        os.chdir(old)
    assert np.isfinite(out["psnr"]) and len(out["frame_ms"]) == 2
