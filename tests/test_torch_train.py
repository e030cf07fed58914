"""The port's training slice against the JAX package, on the CPU.

The slice: BoostENeRF (K=2 of C(4,3)) and plain ENeRF train steps at 64x96,
4 views, volume planes (16, 8), samples (8, 2), both levels rendered on
full images, loss weights (0.1, 1.0), Adam at the fine-tuning recipe's lr
5e-5. The JAX side takes its exact XLA path (gather warp and sampling, XLA
head), ``make_train_step`` and ``make_blocked_train_step``; the port takes
its plain versions (the CPU twins of the CUDA kernels, the autograd
Functions' plain backwards).

Geometry: the forward rig with the target between source frames 1 and 2
(``make_scene_batch`` puts it on frame 2 for 4 views, where the ray
difference to that view is the zero vector and JAX's norm gradient is NaN,
and where border rays project exactly onto the sources' frame edges). Here
no sample lies within rounding of a frame edge, so no viewport mask or
border clamp flips between the packages.

Precision: the comparisons run in float64 on both sides. In float32 the
losses agree to ~1e-7, but the gradients of the cost-volume U-Nets and the
FPN sit ~1% apart: train-mode BatchNorm carries each package's float32
rounding into the sample coordinates, samples cross integer pixel lines,
and bilinear sampling's derivative jumps there (the port's own float32 and
float64 gradients differ as much). The float64 port takes the float32
values JAX uses even in float64 mode: ``jnp.linspace(..., float32)``'s
depth hypotheses and sample positions, and the float32 outputs of the JAX
FPN and U-Nets. Bars: loss rtol 1e-4; per-tensor gradient relative L2
<= 1e-3, relative to max(|g|, 1e-5 of the largest tensor's |g|) (a few
gradients are ~0 by symmetry, e.g. a bias added to every view before the
variance); BatchNorm statistics rtol 1e-4 / atol 1e-6; the parameters after
one Adam step rtol 2e-3 / atol 2e-6 (the bar of
tests/test_parallel.py::test_blocked_train_step_matches_plain). The float32
step is held on the loss and the BatchNorm statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boostmvsnerfs_torch.models.blocks import ConvBnReLU as TorchCBR
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, ENeRF, to_tensors
from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from boostmvsnerfs_torch.parallel import train as tt
from boostmvsnerfs_torch.runner import train_epochs
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager, load_pretrain
from boostmvsnerfs_torch.train.loss import enerf_loss, mse2psnr
from boostmvsnerfs_torch.train.schedule import make_optimizer as torch_optimizer
from boostmvsnerfs_torch.utils.port_weights import (
    enerf_state_dict_from_jax,
    enerf_variables_from_state_dict,
    random_state_dict,
)
from boostmvsnerfs_torch.utils.synthetic import look_at_ext, make_scene_batch
from boostmvsnerfs_tpu.models.blocks import ConvBnReLU as FlaxCBR
from boostmvsnerfs_tpu.models.boost_enerf import BoostENeRF as JaxBoostENeRF
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.models.enerf import ENeRF as JaxENeRF
from boostmvsnerfs_tpu.parallel import train as jt
from boostmvsnerfs_tpu.train.loss import enerf_loss as jax_enerf_loss
from boostmvsnerfs_tpu.train.schedule import make_optimizer as jax_optimizer
from boostmvsnerfs_tpu.utils.port_weights import port_enerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SLICE = dict(k_best=2, volume_planes=(16, 8), num_samples=(8, 2))
TRAIN_CFG = {"lr": 5e-5, "optim": "adam", "eps": 1e-8}
EP_ITER = 500
RAY_BLOCKS = 4


def _walk(t):  # the forward rig's camera path (utils/synthetic.py)
    return np.array([0.15 * np.sin(0.5 * t), 0.04 * np.cos(0.9 * t), 0.25 * t])


def _batch(H=64, W=96, seed=0):
    b = make_scene_batch(B=1, n_views=4, H=H, W=W, boost=True, k_best=2, seed=seed,
                         rig="forward", with_targets=True)
    b["tar_ext"] = look_at_ext(_walk(1.5), target=_walk(1.5) + np.array([0.0, 0.0, 5.0]))[None]
    return b


def _port_model(name, dtype=torch.float32):
    cls = BoostENeRF if name == "boost" else ENeRF
    return cls(CascadeConfig(**SLICE), device="cpu").to(dtype)


def _jax_model(name):
    cas = JaxCascadeConfig(warp_mode="gather", eval_sampling="gather", eval_head="xla",
                           warp_dtype="float32", **SLICE)
    return (JaxBoostENeRF if name == "boost" else JaxENeRF)(cas=cas)


def _rel_l2(got, want, floor=0.0):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-300))


def _jax_float32_linspace(start, stop, num, device=None, dtype=torch.float32):
    """``jnp.linspace``'s own float32 values (XLA rounds a few entries 1-2
    ulps from the formula the port uses, ROADMAP §3); other types by the
    port's formula, as JAX builds its float64 resize matrices."""
    if dtype != torch.float32:
        return _port_linspace(start, stop, num, device, dtype)
    with jax.enable_x64(True):  # the JAX side's float64 run computes it so
        return torch.from_numpy(np.array(jnp.linspace(start, stop, num, dtype=jnp.float32)))


_port_linspace = sampling.linspace


def _round_outputs_like_jax(model):
    """The JAX FeatureNet and cost-regularisation nets cast their outputs to
    float32 (models/feature_net.py:100, models/cost_reg_net.py:61-91), in
    float64 mode too, and with them the cotangents coming back: do the same
    to the port's float64 modules."""
    def f32(out):
        if isinstance(out, dict):
            return {k: f32(v) for k, v in out.items()}
        if isinstance(out, tuple):
            return tuple(f32(v) for v in out)
        return out.float().double()

    for i in range(model.cas.num):
        getattr(model, f"cost_reg_{i}").register_forward_hook(lambda m, args, out: f32(out))
    model.feature_net.register_forward_hook(lambda m, args, out: f32(out))


def _port_step(name, variables, batch, dtype, blocked):
    """One port step from the JAX variables: (stats, gradients (clipped, as
    the step applied them), state_dict after the step). In float64 the
    depth hypotheses and sample positions take JAX's float32 linspace
    values, so float32 constants are the same on both sides."""
    if dtype == torch.float64:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sampling, "linspace", _jax_float32_linspace)
            return _port_step(name, variables, batch, None, blocked)
    model = _port_model(name, dtype or torch.float64)
    model.load_state_dict(enerf_state_dict_from_jax(variables), strict=True)
    if dtype is None:
        _round_outputs_like_jax(model)
    state = tt.create_train_state(model, torch_optimizer(TRAIN_CFG, EP_ITER))
    step = tt.make_blocked_train_step(model, RAY_BLOCKS) if blocked else tt.make_train_step(model)
    stats = step(state, batch)
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in stats.items()}, grads,
            {k: v.double().numpy() for k, v in model.state_dict().items()})


def _jax_step(name, variables, batch, x64, blocked):
    """One JAX step (make_train_step or make_blocked_train_step) and the
    gradients of its loss: (stats, gradients as a port state_dict, the
    variables after the step as a port state_dict, and as the JAX tree)."""
    model = _jax_model(name)
    cas = model.cas
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        jb = {k: jnp.asarray(v, dt if np.issubdtype(np.asarray(v).dtype, np.floating) else None)
              for k, v in batch.items()}
        var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables)
        tx = jax_optimizer(TRAIN_CFG, EP_ITER)
        s0 = jt.create_train_state(model, tx, None, variables=var)
        step = (jt.make_blocked_train_step(model, tx, RAY_BLOCKS) if blocked
                else jt.make_train_step(model, tx))
        s1, stats = step(s0, jb)

        def loss_fn(params):
            out = model.apply({"params": params, "batch_stats": s0.batch_stats}, jb, True,
                              mutable=["batch_stats"])[0]
            return jax_enerf_loss(out, jb, cas.loss_weight, cas.num, cas.render_if, None, None,
                                  cas.train_img)[0]

        grads = jax.jit(jax.grad(loss_fn))(s0.params)
        to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
        g_sd = enerf_state_dict_from_jax({"params": to_np(grads),
                                          "batch_stats": to_np(s0.batch_stats)})
        new_sd = enerf_state_dict_from_jax({"params": to_np(s1.params),
                                            "batch_stats": to_np(s1.batch_stats)})
    return ({k: float(v) for k, v in stats.items()},
            {k: np.clip(v.numpy(), -40.0, 40.0) for k, v in g_sd.items()},
            {k: v.numpy() for k, v in new_sd.items()},
            {"params": to_np(s1.params), "batch_stats": to_np(s1.batch_stats)})


@pytest.fixture(scope="module")
def variables():
    """Seeded reference-named weights, carried into JAX by ``port_enerf``."""
    return port_enerf(random_state_dict(_port_model("boost"), 0))


@pytest.fixture(scope="module")
def steps(variables):
    """{(model, step kind): (port result, JAX result)} in float64."""
    batch = _batch()
    out = {}
    for name in ("boost", "plain"):
        for kind in ("plain", "blocked"):
            blocked = kind == "blocked"
            out[name, kind] = (_port_step(name, variables, batch, torch.float64, blocked),
                               _jax_step(name, variables, batch, True, blocked))
    return out


CASES = [("boost", "plain"), ("boost", "blocked"), ("plain", "plain"), ("plain", "blocked")]


@pytest.mark.parametrize("name,kind", CASES)
def test_step_loss_matches_jax(steps, name, kind):
    (got, _, _), (want, *_) = steps[name, kind]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("name,kind", CASES)
def test_step_gradients_match_jax(steps, name, kind, record_property):
    (_, got, _), (_, want, *_) = steps[name, kind]
    assert got.keys() <= want.keys()
    floor = 1e-5 * max(np.linalg.norm(w) for w in want.values())
    errs = {k: _rel_l2(got[k], want[k], floor) for k in got}
    worst = max(errs, key=errs.get)
    record_property("worst_gradient_rel_l2", f"{worst} {errs[worst]:.3e}")
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    assert all(np.abs(g).max() > 0 for g in got.values())


@pytest.mark.parametrize("name,kind", CASES)
def test_step_batch_stats_and_params_match_jax(steps, name, kind):
    """BatchNorm statistics after the step, and the parameters after one
    Adam step. Adam's first step is -lr * g / (|g| + eps): sign-like where
    |g| >> eps, but where |g| is near eps = 1e-8 it multiplies a gradient
    difference by up to lr / eps = 5000, so each element is held to the bar
    plus that amplification of its own gradient difference (the gradients
    themselves are held above)."""
    (_, g_got, got), (_, g_want, want, _) = steps[name, kind]
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
            continue
        amplified = TRAIN_CFG["lr"] / TRAIN_CFG["eps"] * np.abs(g_got[k] - g_want[k])
        bad = np.abs(got[k] - w) > 2e-6 + 2e-3 * np.abs(w) + amplified
        assert not bad.any(), (k, np.abs(got[k] - w)[bad].max())


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_blocked_step_equals_plain_step(steps, name):
    """The blocks change when activations exist, not the math."""
    (sp, gp, pp), _ = steps[name, "plain"]
    (sb, gb, pb), _ = steps[name, "blocked"]
    np.testing.assert_allclose(sb["loss"], sp["loss"], rtol=1e-5)
    for k in gp:
        assert _rel_l2(gb[k], gp[k]) <= 1e-6, k
    for k in pp:
        np.testing.assert_allclose(pb[k], pp[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_float32_step_loss_and_batch_stats_match_jax(variables):
    """The float32 step (the card's precision): the loss and the updated
    BatchNorm statistics agree; the gradients are held in float64 (see the
    module docstring)."""
    batch = _batch()
    got_stats, _, got = _port_step("boost", variables, batch, torch.float32, True)
    want_stats, _, want, _ = _jax_step("boost", variables, batch, False, True)
    np.testing.assert_allclose(got_stats["loss"], want_stats["loss"], rtol=1e-4)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_weights_carry_both_ways_after_a_jax_step(steps):
    """A JAX TrainState's params and batch_stats after a step load into the
    port, and the port's state_dict carries back to the same tree."""
    trained = steps["boost", "plain"][1][3]
    port = _port_model("boost", torch.float64)
    port.load_state_dict(enerf_state_dict_from_jax(trained), strict=True)
    back = enerf_variables_from_state_dict(port.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(trained)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), path


# ------------------------------------------------------------- pieces


def test_batchnorm_running_var_is_flax_biased_variance():
    """Train-mode ConvBnReLU against flax: outputs, and running statistics
    updated with the *biased* batch variance at momentum 0.9 (torch's own
    BatchNorm would put in n/(n-1) of it: 24/23 here)."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 3, 2, 2, 4)).astype(np.float32)  # NDHWC, n = 24
    sd = random_state_dict(TorchCBR(4, 8, dims=3), 31)
    block = TorchCBR(4, 8, dims=3)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    block.train()
    got = block(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    variables = {
        "params": {"Conv_0": {"kernel": sd["conv.weight"].transpose(2, 3, 4, 1, 0)},
                   "BatchNorm_0": {"scale": sd["bn.weight"], "bias": sd["bn.bias"]}},
        "batch_stats": {"BatchNorm_0": {"mean": sd["bn.running_mean"],
                                        "var": sd["bn.running_var"]}},
    }
    want, mut = FlaxCBR(8, (3, 3, 3), (1, 1, 1)).apply(variables, jnp.asarray(x), True,
                                                       mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(block.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(block.bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-4, atol=1e-6)
    unbiased = torch.nn.BatchNorm3d(8)
    unbiased.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in sd.items()
                              if k.startswith("bn.")})
    unbiased.train()(block.conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)))
    assert not np.allclose(unbiased.running_var.detach().numpy(), np.asarray(stats["var"]),
                           rtol=1e-3)


SCHEDULES = {
    "exponential": {"type": "exponential", "gamma": 0.5, "decay_epochs": 2},
    "multi_step": {"type": "multi_step", "gamma": 0.3, "milestones": [2, 4]},
    "warmup_multi_step": {"type": "warmup_multi_step", "gamma": 0.3, "milestones": [4],
                          "warmup_iters": 3, "warmup_factor": 0.25},
}
OPTIMIZERS = {
    "adam": {"optim": "adam", "eps": 1e-8},
    "adamw": {"optim": "adam", "eps": 1e-8, "weight_decay": 0.1},
    "radam": {"optim": "radam", "eps": 1e-8, "weight_decay": 0.01},
    "sgd": {"optim": "sgd"},
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_optimizer_and_schedule_match_optax(opt, sched):
    """20 steps on a toy parameter (ep_iter 3, so the schedule moves) with
    seeded gradients, some beyond the clip at 40: every step's parameters
    agree with ``make_optimizer``'s optax chain, jitted as the JAX steps run
    it. RAdam crosses its rho >= 5 threshold on the way; its rho_t is so
    sensitive to float32 rounding that one ulp of b2^t moves it by 0.02
    (eager and jitted optax differ so), so the port takes optax's float32
    arithmetic."""
    cfg = {"lr": 0.05, "scheduler": SCHEDULES[sched], **OPTIMIZERS[opt]}
    rng = np.random.default_rng(32)
    p0 = rng.standard_normal(12).astype(np.float32)
    grads = (rng.standard_normal((20, 12)) * 3).astype(np.float32)
    grads[::4, :3] *= 40.0
    tx = jax_optimizer(cfg, 3)
    jp, js = jnp.asarray(p0), None
    js = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt_t, sched_t = torch_optimizer(cfg, 3)([param])
    from boostmvsnerfs_torch.train.schedule import apply_update

    update = jax.jit(tx.update)  # as the JAX train steps run it
    for i, g in enumerate(grads):
        upd, js = update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g.copy())
        apply_update(opt_t, sched_t)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {i}")


def test_loss_matches_jax():
    rng = np.random.default_rng(33)
    out = {f"rgb_level{i}": rng.uniform(0, 1, (2, 40, 3)).astype(np.float32) for i in range(2)}
    batch = {f"rgb_{i}": rng.uniform(0, 1, (2, 40, 3)).astype(np.float32) for i in range(2)}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    perceptual = (lambda a, b: torch.mean(torch.abs(a - b)), lambda a, b: jnp.mean(jnp.abs(a - b)))
    for render_if, use_p in (((True, True), False), ((False, True), True)):
        got = enerf_loss(t(out), t(batch), (0.1, 1.0), 2, render_if,
                         perceptual[0] if use_p else None, ((5, 8), (5, 8)) if use_p else None)[1]
        want = jax_enerf_loss(j(out), j(batch), (0.1, 1.0), 2, render_if,
                              perceptual[1] if use_p else None,
                              ((5, 8), (5, 8)) if use_p else None)[1]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    assert float(mse2psnr(torch.tensor(0.01))) == pytest.approx(20.0)


# ------------------------------------------------------ checkpoints, entry


def _small_setup(seed=0):
    model = BoostENeRF(CascadeConfig(**SLICE), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(model, 0).items()})
    return model, [_batch(32, 64, seed=seed + i) for i in range(2)]


def test_checkpoint_manager_keeps_five_and_round_trips(tmp_path):
    model, batches = _small_setup()
    state = tt.create_train_state(model, torch_optimizer(TRAIN_CFG, 2))
    tt.make_train_step(model)(state, batches[0])
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore() is None
    for epoch in range(7):
        mgr.save(state.state_dict(), epoch)
    assert mgr.numbered_epochs() == [2, 3, 4, 5, 6]
    assert mgr.latest_path().endswith("latest.pt")
    fresh, _ = _small_setup()
    fresh.load_state_dict({k: torch.zeros_like(v) for k, v in fresh.state_dict().items()})
    other = tt.create_train_state(fresh, torch_optimizer(TRAIN_CFG, 2))
    other.load_state_dict(mgr.restore())
    assert other.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert other.optimizer.state_dict()["state"].keys() == state.optimizer.state_dict()["state"].keys()
    assert other.scheduler.last_epoch == state.scheduler.last_epoch == 1
    warm, _ = _small_setup()
    warm.load_state_dict({k: torch.zeros_like(v) for k, v in warm.state_dict().items()})
    assert load_pretrain(str(tmp_path / "ckpt"), warm)
    assert all(torch.equal(warm.state_dict()[k], v) for k, v in model.state_dict().items())
    assert not load_pretrain(str(tmp_path / "none"), warm)


def test_run_train_resumes_and_saves(tmp_path, capsys):
    """Two epochs in one run equal one epoch, a stop, and a resumed second
    epoch, bit for bit (the optimizer moments and schedule travel in the
    checkpoint), on the ray-blocked step. With several intra-op threads the
    CPU's blocked step can differ in the last bit from one run to the next,
    so both runs take one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_resume(tmp_path, capsys)
    finally:
        torch.set_num_threads(threads)


def _check_resume(tmp_path, capsys):
    cfg = {**TRAIN_CFG, "epoch": 2}
    model_a, batches = _small_setup()
    state_a = train_epochs(model_a, batches, cfg, str(tmp_path / "a"), log_interval=1,
                        ray_blocks=2, device="cpu")
    assert state_a.step == 4
    assert CheckpointManager(str(tmp_path / "a")).numbered_epochs() == [0, 1]
    assert "epoch 1 iter 1/2" in capsys.readouterr().out
    model_b, _ = _small_setup()
    train_epochs(model_b, batches, {**cfg, "epoch": 1}, str(tmp_path / "b"), ray_blocks=2,
              device="cpu")
    model_c, _ = _small_setup()
    state_c = train_epochs(model_c, batches, cfg, str(tmp_path / "b"), ray_blocks=2, device="cpu")
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert state_c.step == 4
    for k, v in model_a.state_dict().items():
        assert torch.equal(model_c.state_dict()[k], v), k


def test_run_train_raises_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, batches = _small_setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_epochs(model, batches[:1], {**TRAIN_CFG, "epoch": 1}, str(tmp_path))
    reset_launch_counts()
    state = train_epochs(model, batches[:1], {**TRAIN_CFG, "epoch": 1}, str(tmp_path),
                         device="cpu")
    assert state.step == 1
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_eval_forward_after_training_keeps_running_statistics(variables):
    """After train steps, the eval forward normalises with the running
    statistics (no batch statistics, no gradient)."""
    model, batches = _small_setup()
    state = tt.create_train_state(model, torch_optimizer(TRAIN_CFG, 2))
    tt.make_train_step(model)(state, batches[0])
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    out = tt.make_eval_step(model)(batches[1])
    assert not out["rgb_level1"].requires_grad
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    batch = to_tensors(batches[1], torch.device("cpu"))
    assert all(torch.isfinite(v).all() for v in out.values())
    assert out["rgb_level1"].shape == batch["rgb_1"].shape


def test_chip_smoke_train_phases_rehearse_on_cpu():
    """chip_smoke.py's training pieces at 32x64 on the CPU: the backward
    kernels' inputs from the model's train-mode stages (each wrapper takes
    its plain version here), their work counts, the launches per blocked
    step the code implies (16 blocks: the same counts as at 480x736), the
    smooth card-vs-CPU batch and the gradient comparison."""
    import importlib.util
    from pathlib import Path

    from boostmvsnerfs_torch.ops.cuda.img_sample import row_sample_bwd
    from boostmvsnerfs_torch.ops.cuda.warp_variance import fused_warp_variance, warp_variance_bwd

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = BoostENeRF(CascadeConfig(k_best=2), device="cpu")
    model.load_state_dict(smoke.random_weights(model, 0), strict=True)
    batch = to_tensors(make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, k_best=2,
                                        rig="forward", with_targets=True), torch.device("cpu"))
    with torch.no_grad():
        inputs = smoke.train_kernel_inputs(model, batch)
        (l0, (f0, _, d0, g0)), (l1, (f1, _, d1, g1)) = inputs["warp_variance_bwd"]
        assert (l0, l1) == ("level0", "level1")
        # the training forward (#1's f32 instance) on the same inputs
        assert [(label, a[0], a[2], a[3]) for label, a in inputs["warp_variance"]] == [
            (l0, f0, d0, torch.float32), (l1, f1, d1, torch.float32)]
        assert f0.shape == (2, 3, 8, 16, 32) and d0.shape == (2, 64, 4, 8)
        assert g0.shape == (2, 64, 4, 8, 32) and g1.shape == (2, 8, 16, 32, 16)
        (s0, (i0, x0, _, c0)), (s1, (i1, x1, _, c1)) = inputs["img_sample_bwd"]
        assert (s0, s1) == ("level0", "level1 block 1 of 16")
        assert i0.shape == (6, 8, 16, 35) and x0.shape == (6, 8 * 16 * 8)
        assert i1.shape == (6, 32, 64, 11) and x1.shape == (6, 2 * 64 * 2)
        assert c1.shape == (6, 2 * 64 * 2, 11)
        for name, wrapper in (("warp_variance_bwd", warp_variance_bwd),
                              ("img_sample_bwd", row_sample_bwd)):
            for _, args in inputs[name]:
                assert all(torch.isfinite(o).all() for o in wrapper(*args)), name
                assert min(smoke.TRAIN_KERNELS[name][3](*args)) > 0, name
        for _, args in inputs["warp_variance"]:
            assert torch.isfinite(fused_warp_variance(*args)).all()
            assert min(smoke.TRAIN_KERNELS["warp_variance"][3](*args)) > 0
        assert [label for label, _ in inputs["img_sample"]] == [s0, s1]
        for (_, fwd), (_, bwd) in zip(inputs["img_sample"], inputs["img_sample_bwd"]):
            assert all(a is b for a, b in zip(fwd, bwd[:3]))
            assert min(smoke.TRAIN_KERNELS["img_sample"][3](*fwd)) > 0
    assert smoke.expected_train_launches(model, batch) == dict(
        smoke.NO_LAUNCHES, warp_variance=2, warp_variance_bwd=2, img_sample=33,
        img_sample_bwd=17)
    smooth = smoke.smooth_scene_batch(32, 64, seed=3)
    assert smooth["src_inps"].shape == (1, 4, 32, 64, 3)
    assert np.abs(smooth["src_inps"]).max() <= 1.5
    state = smoke.random_weights(model, 0)
    for dtype, kind in ((torch.float32, "blocked"), (torch.float64, "plain")):
        loss, grads = smoke.train_step_grads(state, smooth, "cpu", dtype, kind)
        assert np.isfinite(loss) and grads.keys() == dict(model.named_parameters()).keys()
        assert all(g.dtype == torch.float64 and torch.isfinite(g).all() for g in grads.values())
    g = {"a": torch.ones(3), "b": torch.zeros(2)}
    assert smoke.grad_rel_errors(g, g) == {"a": 0.0, "b": 0.0}
    assert smoke.global_rel_error(g, {"a": torch.ones(3), "b": torch.ones(2)}) == pytest.approx(
        np.sqrt(2 / 5))


def test_chip_smoke_gradient_bars_separate_float32_from_planted_faults():
    """chip_smoke.py's card-vs-CPU gradient bars at their own size (128x192,
    4 views, K=2) on the CPU port against float64: float32's own steps (on
    the batch and on ulp-perturbed copies) pass them, and each planted
    wiring fault fails them; every planted function is restored after."""
    import importlib
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    originals = {f: getattr(importlib.import_module(f"boostmvsnerfs_torch.ops.{m}"), a)
                 for f, (m, a, _) in smoke.PLANTED_FAULTS.items()}
    state = smoke.random_weights(BoostENeRF(CascadeConfig(k_best=2), device="cpu"), 0)
    batch = smoke.smooth_scene_batch(128, 192, seed=3)
    _, ref = smoke.train_step_grads(state, batch, "cpu", torch.float64, "plain")
    f32 = [smoke.train_step_grads(state, batch, "cpu", torch.float32, k)[1]
           for k in ("plain", "blocked")]
    bars = smoke.cpu_bar_readings(state, batch, ref, f32)
    assert len(bars["spread"]) == 2 + smoke.ULP_PERTURBATIONS
    assert all(smoke.within_bars(r) for r in bars["spread"]), bars["spread"]
    assert bars["faults"].keys() == smoke.PLANTED_FAULTS.keys()
    for fault, r in bars["faults"].items():
        assert not smoke.within_bars(r), (fault, r)
    for f, (m, a, _) in smoke.PLANTED_FAULTS.items():
        assert getattr(importlib.import_module(f"boostmvsnerfs_torch.ops.{m}"), a) is originals[f]
