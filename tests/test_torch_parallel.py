"""The port's parallel layer (``boostmvsnerfs_torch/parallel/mesh.py``, the
distributed steps of ``parallel/train.py``, ``parallel/staged.py``) on gloo
ranks on the CPU, against the JAX package's single-process results.

The ranks are spawned processes (``tests/torch_parallel_ranks.py``: the
``spawn`` context, a ``FileStore`` rendezvous under ``tmp_path``, one
intra-op thread each), 2 of them for the steps, the BatchNorm and the
(cv=2) and (rays=2) frames, 4 for the (data=2, rays=2) batch split and the
(cv=2, rays=2) frame; both sets run while this process computes the JAX
references (8 virtual CPU devices, tests/conftest.py), and every rank is
joined with a timeout that fails the test.

The geometry: 32x64, 4 views, BoostENeRF K=4 of C(4,3), volume planes (16,
8), samples (8, 2), both levels on full images; plain ENeRF on the first 3
views; MVSNeRF (``v0``, 8 planes and samples, 256 random rays, the MVSNeRF
recipe's loss settings); a batch of 2, each target between source frames
(on a source camera JAX's norm gradient is NaN and border rays project
onto the frame edges, ROADMAP faults 4 and 9). Seeded reference-named
weights reach JAX through ``port_enerf`` / ``mvsnerf_variables_from_state_dict``.
JAX takes its exact path (gather warp and sampling, XLA head, float32).

The bars: the ranks' steps (float64) against JAX's step on the whole batch
(float32), JAX's own bars (tests/test_parallel.py:127-137): the loss rtol
1e-4, every parameter after the Adam step rtol 1e-3 / atol 5e-4, the
BatchNorm statistics rtol 1e-4 / atol 1e-6. Adam's first step moves a
parameter by its lr in the direction of its gradient's sign, and JAX's
float32 gradients of the FPN and the U-Nets lie ~1% from float64 ones
(tests/test_torch_train.py): where the port's gradient is within 1% of its
tensor's largest, JAX's sign is noise, and the parameter may differ by the
two steps' difference, 2 lr (plus rtol 1e-3), instead of atol 5e-4 (one
element of 576 in the ENeRF FPN's second convolution). Adam's first step moves every
parameter by about its lr whatever the gradient's scale, so the averaged
gradients are also held against the port's own float64 step on the whole
batch (relative to the largest of each tensor, 1e-9), which a wrong
reduction factor would miss by orders of magnitude, and the ranks must end
bit for bit equal. The cross-rank BatchNorm against flax on the whole
batch: output, input gradient, running mean and biased running variance at
rtol 1e-5 / atol 1e-6 (tests/test_parallel.py:192-197). The frames against
JAX's unsharded ``StagedENeRF`` at rtol 1e-4 / atol 1e-5
(tests/test_staged.py:117-120).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from boostmvsnerfs_torch.parallel import mesh as mesh_lib
from boostmvsnerfs_torch.utils.port_weights import (
    enerf_state_dict_from_jax,
    mvsnerf_state_dict_from_jax,
    mvsnerf_variables_from_state_dict,
    random_state_dict,
)
from boostmvsnerfs_torch.utils.synthetic import look_at_ext, make_scene_batch, mvsnerf_batch
from boostmvsnerfs_tpu.models import mvsnerf as jm
from boostmvsnerfs_tpu.models.blocks import ConvBnReLU as FlaxCBR
from boostmvsnerfs_tpu.models.boost_enerf import BoostENeRF as JaxBoostENeRF
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.models.enerf import ENeRF as JaxENeRF
from boostmvsnerfs_tpu.parallel import mesh as jmesh
from boostmvsnerfs_tpu.parallel import train as jt
from boostmvsnerfs_tpu.parallel.staged import StagedENeRF as JaxStagedENeRF
from boostmvsnerfs_tpu.train.loss import enerf_loss as jax_enerf_loss
from boostmvsnerfs_tpu.train.schedule import make_optimizer as jax_optimizer
from boostmvsnerfs_tpu.utils.port_weights import port_enerf
from tests import torch_parallel_ranks as ranks

TWO_RANKS = ["checkpoint", "bn", "enerf/data2", "boost/data2", "boost/rays2", "blocked/data2",
             "mvsnerf/data2", "staged/cv2", "eval/rays2"]
FOUR_RANKS = ["shards", "staged/cv2rays2"]
STEPS = {"enerf/data2": "enerf", "boost/data2": "boost", "boost/rays2": "boost",
         "blocked/data2": "boost", "mvsnerf/data2": "mvsnerf"}
FRAMES = ["staged/cv2", "staged/cv2rays2", "eval/rays2"]
BATCH_KEYS = ["all_src_inps", "all_src_exts", "all_src_ixts", "tar_ext", "tar_ixt", "near_far",
              "ray_idx_0", "rgb_0", "ray_idx_1", "rgb_1", "msk_1", "combos", "k_best"]
JOIN_TIMEOUT_S = 300


def _walk(t):  # the forward rig's camera path (utils/synthetic.py)
    return np.array([0.15 * np.sin(0.5 * t), 0.04 * np.cos(0.9 * t), 0.25 * t])


def _targets(ts):
    return np.stack([look_at_ext(_walk(t), target=_walk(t) + np.array([0.0, 0.0, 5.0]))
                     for t in ts])


def _inputs() -> dict:
    """The numpy inputs every rank and every reference takes."""
    b = make_scene_batch(B=2, n_views=4, H=32, W=64, boost=True, k_best=4, seed=0,
                         rig="forward", with_targets=True)
    b["tar_ext"] = _targets((1.5, 1.3))
    boost = {k: v for k, v in b.items() if not k.startswith("src_")}
    boost["msk_1"] = np.random.default_rng(1).uniform(size=boost["rgb_1"].shape[:2]) > 0.1
    enerf = {k: v for k, v in b.items() if not k.startswith("all_") and k not in ("combos",
                                                                                   "k_best")}
    enerf.update({k: b[f"all_{k}"][:, :3] for k in ("src_inps", "src_exts", "src_ixts")})
    m = make_scene_batch(B=2, n_views=4, H=32, W=64, boost=True, seed=0, rig="forward",
                         render_scales=(1.0,), ray_subsample={0: 256}, with_targets=True)
    mvs = mvsnerf_batch(m, k_best=(0, 3))
    mvs.update(ray_idx_0=m["ray_idx_0"], rgb_0=m["rgb_0"], tar_ext=b["tar_ext"])
    rng = np.random.default_rng(11)
    return dict(
        boost_batch=boost, enerf_batch=enerf, mvs_batch=mvs,
        frame={k: v if k == "combos" else v[:1] for k, v in boost.items()
               if not k.startswith(("rgb_", "msk_"))},
        boost_state=random_state_dict(ranks.port_model("boost"), 0),
        enerf_state=random_state_dict(ranks.port_model("enerf"), 0),
        mvsnerf_state=random_state_dict(ranks.port_model("mvsnerf"), 0),
        bn_x=rng.standard_normal((8, 6, 6, 3)).astype(np.float32),
        bn_ct=rng.standard_normal((8, 6, 6, 4)).astype(np.float32),
        bn_state=random_state_dict(ranks.ConvBnReLU(3, 4), 3),
    )


# ------------------------------------------------------------ JAX references


def _jax_cas(**kw):
    return JaxCascadeConfig(warp_mode="gather", eval_sampling="gather", eval_head="xla",
                            warp_dtype="float32", volume_planes=(16, 8), num_samples=(8, 2),
                            k_best=4, **kw)


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_enerf_step(kind: str, state: dict, batch: dict) -> dict:
    """JAX ``make_train_step`` (float32) on the whole batch: the stats and
    the state after the step as a port state_dict."""
    model = (JaxBoostENeRF if kind == "boost" else JaxENeRF)(cas=_jax_cas())
    tx = jax_optimizer(ranks.TRAIN_CFG, ranks.EP_ITER)
    s0 = jt.create_train_state(model, tx, None, variables=port_enerf(state))
    s1, stats = jt.make_train_step(model, tx)(s0, {k: jnp.asarray(v) for k, v in batch.items()})
    sd = enerf_state_dict_from_jax({"params": _to_np(s1.params),
                                    "batch_stats": _to_np(s1.batch_stats)})
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": {k: v.numpy() for k, v in sd.items()}}


def _jax_mvsnerf_step(state: dict, batch: dict) -> dict:
    """JAX's step for an MVSNeRF, assembled as ``make_train_step`` would be
    with the recipe's loss settings (JAX's own reads ``model.cas`` and fails
    on every MVSNeRF, ROADMAP fault 15): the train-mode forward, ``enerf_loss``,
    ``value_and_grad``, the optax chain."""
    model = jm.MVSNeRF(jm.MVSNeRFConfig(num_samples=8, k_best=2))
    var = mvsnerf_variables_from_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, mutated = model.apply({"params": params, "batch_stats": var["batch_stats"]}, jb,
                                   True, mutable=["batch_stats"])
        loss, stats = jax_enerf_loss(out, jb, (1.0,), 1, (True,), None, None, (False,))
        return loss, (mutated["batch_stats"], stats)

    (_, (new_stats, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        var["params"])
    tx = jax_optimizer(ranks.TRAIN_CFG, ranks.EP_ITER)
    updates, _ = tx.update(grads, tx.init(var["params"]), var["params"])
    sd = mvsnerf_state_dict_from_jax({"params": _to_np(optax.apply_updates(var["params"],
                                                                           updates)),
                                      "batch_stats": _to_np(new_stats)})
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": {k: v.numpy() for k, v in sd.items()}}


def _jax_bn(inputs: dict) -> dict:
    """flax ConvBnReLU on the whole batch: output, input gradient (the same
    cotangent), running statistics."""
    sd = inputs["bn_state"]
    variables = {
        "params": {"Conv_0": {"kernel": sd["conv.weight"].transpose(2, 3, 1, 0)},
                   "BatchNorm_0": {"scale": sd["bn.weight"], "bias": sd["bn.bias"]}},
        "batch_stats": {"BatchNorm_0": {"mean": sd["bn.running_mean"],
                                        "var": sd["bn.running_var"]}},
    }
    block = FlaxCBR(4, (3, 3), (1, 1))

    def apply(x):
        return block.apply(variables, x, True, mutable=["batch_stats"])

    x = jnp.asarray(inputs["bn_x"])
    y, mut = apply(x)
    _, pull = jax.vjp(lambda x: apply(x)[0], x)
    (dx,) = pull(jnp.asarray(inputs["bn_ct"]))
    stats = mut["batch_stats"]["BatchNorm_0"]
    return {"bn/y": np.asarray(y), "bn/dx": np.asarray(dx), "bn/mean": np.asarray(stats["mean"]),
            "bn/var": np.asarray(stats["var"])}


def _jax_frame(inputs: dict) -> dict:
    """JAX's unsharded ``StagedENeRF`` frame of the BoostENeRF."""
    out = JaxStagedENeRF(JaxBoostENeRF(cas=_jax_cas()))(
        port_enerf(inputs["boost_state"]), {k: jnp.asarray(v) for k, v in inputs["frame"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_shards(batch: dict) -> list:
    """Each of the first 4 devices' shard of every key under JAX's
    ``batch_shardings`` on a (data=2, rays=2) mesh: [{key: array}] by device
    index, which is the rank on the port's mesh."""
    mesh = jmesh.make_mesh(n_data=2, n_rays=2, devices=jax.devices("cpu"))
    order = list(mesh.devices.flat)
    out = [{} for _ in order]
    for k, sharding in jmesh.batch_shardings(mesh, batch).items():
        for shard in jax.device_put(jnp.asarray(batch[k]), sharding).addressable_shards:
            out[order.index(shard.device)][k] = np.asarray(shard.data)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank sets' results, the JAX references and the port's own
    float64 whole-batch steps (a third process, while the ranks run)."""
    inputs = _inputs()
    two = tmp_path_factory.mktemp("two_ranks")
    four = tmp_path_factory.mktemp("four_ranks")
    joins = [ranks.spawn(2, TWO_RANKS, inputs, str(two)),
             ranks.spawn(4, FOUR_RANKS, inputs, str(four)),
             ranks.spawn(1, ["whole"], inputs, str(tmp_path_factory.mktemp("whole")))]
    try:
        jax_ref = {"bn": _jax_bn(inputs), "shards": _jax_shards(inputs["boost_batch"])}
        # XLA compiles the four references' programs in parallel threads
        with ThreadPoolExecutor(4) as pool:
            todo = {kind: pool.submit(_jax_enerf_step, kind, inputs[f"{kind}_state"],
                                      inputs[f"{kind}_batch"]) for kind in ("enerf", "boost")}
            todo["mvsnerf"] = pool.submit(_jax_mvsnerf_step, inputs["mvsnerf_state"],
                                          inputs["mvs_batch"])
            todo["frame"] = pool.submit(_jax_frame, inputs)
            jax_ref.update({k: f.result() for k, f in todo.items()})
    finally:
        two_res, four_res, (whole,) = (join(JOIN_TIMEOUT_S) for join in joins)
    return {"two": two_res, "four": four_res, "jax": jax_ref, "two_dir": two,
            "whole": {kind: _of(whole, "whole", kind) for kind in ("enerf", "boost", "mvsnerf")}}


def _of(res: dict, case: str, part: str) -> dict:
    pre = f"{case}/{part}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


# ------------------------------------------------------------------ meshes

MESH_GRID = [(8, 1, None), (8, 2, None), (8, 2, 4), (8, 4, 2), (8, 8, 1), (4, 2, 2), (4, 1, 4),
             (2, 2, 1), (2, 1, 2), (6, 3, 2), (1, 1, None)]
CV_GRID = [(n, k, b) for n in (1, 2, 3, 4, 6, 8) for k in (2, 3, 4) for b in (1, 2)]


@pytest.mark.parametrize("n, n_data, n_rays", MESH_GRID)
def test_mesh_shape_matches_jax(n, n_data, n_rays):
    want = jmesh.make_mesh(n_data, n_rays, devices=jax.devices("cpu")[:n]).shape
    assert mesh_lib.mesh_shape(n, n_data, n_rays) == (want["data"], want["rays"])


@pytest.mark.parametrize("n, k_best, batch", CV_GRID)
def test_cv_mesh_shape_matches_jax(n, k_best, batch):
    want = jmesh.make_cv_mesh(n, k_best=k_best, batch=batch, devices=jax.devices("cpu")).shape
    assert mesh_lib.cv_mesh_shape(n, k_best, batch) == (want["cv"], want["rays"])


def test_device_meshes_on_four_ranks(runs):
    """``make_mesh(2, 2)`` and ``make_cv_mesh(4, k_best=4)`` as DeviceMeshes
    of 4 gloo ranks: JAX's shapes, and rank r at row-major position r (JAX's
    ``devices.reshape``)."""
    for r, res in enumerate(runs["four"]):
        assert tuple(res["mesh/data_rays"]) == (2, 2)
        assert tuple(res["mesh/cv_rays"]) == mesh_lib.cv_mesh_shape(4, 4) == (4, 1)
        assert tuple(res["mesh/coords"]) == divmod(r, 2)


def test_mesh_needs_the_whole_world():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_lib._device_mesh((2, 2), mesh_lib.MESH_AXES)


def test_init_distributed_raises_without_torchrun_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.init_distributed("cpu")


# --------------------------------------------------------------- the batch


@pytest.mark.parametrize("key", BATCH_KEYS)
def test_shard_batch_matches_jax_shards(runs, key):
    """Each rank's ``shard_batch`` on (data=2, rays=2) against the shard JAX's
    ``batch_shardings`` puts on the device at the same mesh position."""
    want = runs["jax"]["shards"]
    for r, res in enumerate(runs["four"]):
        np.testing.assert_array_equal(res[f"shard/{key}"], want[r][key], err_msg=f"rank {r}")


def test_batch_pspecs_are_jaxs():
    want = jmesh.batch_pspecs(BATCH_KEYS)
    got = mesh_lib.batch_pspecs(BATCH_KEYS)
    assert {k: tuple(v) for k, v in want.items()} == got
    assert want["combos"] == P() and got["combos"] == ()


def test_shard_batch_refuses_uneven_shards():
    with pytest.raises(ValueError, match="equal shards"):
        mesh_lib._split(np.zeros((3, 4)), 0, 2, 0)


def test_rank0_alone_writes_checkpoints(runs):
    """Under a process group ``CheckpointManager.save`` writes on rank 0 only
    and returns on every rank after the write (each rank then reads rank
    0's state); ``Recorder`` opens a writer on rank 0 only (tensorboardX
    permitting)."""
    root = runs["two_dir"] / "ckpt"
    assert sorted(p.name for p in (root / "shared").iterdir()) == ["0.pt", "latest.pt"]
    assert sorted(p.name for p in (root / "own0").iterdir()) == ["0.pt", "latest.pt"]
    assert list((root / "own1").iterdir()) == []
    assert [int(res["ckpt/restored_step"]) for res in runs["two"]] == [0, 0]
    assert not runs["two"][1]["ckpt/recorder_writes"]


# ---------------------------------------------------------- the BatchNorm


@pytest.mark.parametrize("what", ["bn/y", "bn/dx", "bn/mean", "bn/var"])
def test_cross_rank_batchnorm_matches_flax(runs, what):
    """ConvBnReLU on 2 ranks, 4 images each, statistics over both, against
    flax on all 8: the rank's half of the output and of the input gradient,
    the running mean and the biased running variance (fault 8)."""
    want = runs["jax"]["bn"][what]
    for r, res in enumerate(runs["two"]):
        w = want[4 * r:4 * (r + 1)] if what in ("bn/y", "bn/dx") else want
        np.testing.assert_allclose(res[what], w, rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")


# ---------------------------------------------------------------- the steps


@pytest.mark.parametrize("case", list(STEPS))
def test_distributed_step_matches_jax(runs, case):
    """The loss, every parameter after the step and the BatchNorm
    statistics of 2 ranks against JAX's step on the whole batch (the
    parameters' bar as the module docstring says)."""
    want = runs["jax"][STEPS[case]]
    lr = ranks.TRAIN_CFG["lr"]
    for r, res in enumerate(runs["two"]):
        np.testing.assert_allclose(res[f"{case}/stat/loss"], want["stats"]["loss"], rtol=1e-4)
        state, grads = _of(res, case, "state"), _of(res, case, "grad")
        assert state.keys() == want["state"].keys()
        for k, w in want["state"].items():
            if "running_" in k:
                np.testing.assert_allclose(state[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
            elif not k.endswith("num_batches_tracked"):
                g = np.abs(grads[k])
                atol = np.where(g <= 1e-2 * g.max(), 2 * lr, 5e-4)
                diff = np.abs(state[k] - w)
                assert (diff <= atol + 1e-3 * np.abs(w)).all(), (k, r, float(diff.max()))


@pytest.mark.parametrize("case", list(STEPS))
def test_distributed_gradients_match_whole_batch(runs, case):
    """The gradients each rank applied (averaged over the ranks), the stats
    and the state after the step against the port's float64 step on the
    whole batch in one process."""
    want = runs["whole"][STEPS[case]]
    res = runs["two"][0]
    for k, w in want.items():
        got = res[f"{case}/{k}"]
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = 1e-9 if k.startswith(("grad/", "stat/")) else 1e-6
        assert float(np.abs(got - w).max()) <= tol * scale, k


@pytest.mark.parametrize("case", list(STEPS))
def test_ranks_end_with_equal_state(runs, case):
    a, b = (_of(res, case, "state") for res in runs["two"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------- the frames


@pytest.mark.parametrize("case", FRAMES)
def test_sharded_frame_matches_jax(runs, case):
    """The BoostENeRF K=4 frame on (cv=2, rays=1) and (cv=2, rays=2) (the K
    volumes over ``cv``) and on (data=1, rays=2) (ray tiles) against JAX's
    unsharded ``StagedENeRF``: every rank returns the whole frame."""
    want = runs["jax"]["frame"]
    for r, res in enumerate(runs["four" if case == "staged/cv2rays2" else "two"]):
        got = {k[len(case) + 1:]: v for k, v in res.items() if k.startswith(case + "/")}
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=f"{k} rank {r}")
