"""The rank processes of tests/test_torch_parallel.py: gloo ranks on the CPU
that drive the port's parallel layer on numpy inputs and write their
results to ``<out>/rank<r>.npz``. The module imports torch and the port,
never JAX, so that spawned ranks start quickly.

``spawn(world, cases, inputs, workdir)`` starts the ranks (the ``spawn``
context; rendezvous through a ``FileStore`` in ``workdir``; one intra-op
thread each) and returns a ``join(timeout)`` that waits for them, kills
any that outlive the timeout, and returns each rank's results or raises
with the failed ranks' tracebacks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from boostmvsnerfs_torch.models.blocks import ConvBnReLU
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, ENeRF
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, MVSNeRFConfig
from boostmvsnerfs_torch.parallel import mesh as mesh_lib
from boostmvsnerfs_torch.parallel import train as tt
from boostmvsnerfs_torch.parallel.staged import StagedENeRF
from boostmvsnerfs_torch.train.schedule import make_optimizer

TRAIN_CFG = {"lr": 5e-4, "optim": "adam", "eps": 1e-8}
EP_ITER = 100
STEP_DTYPE = torch.float64


def enerf_cas(**kw) -> CascadeConfig:
    return CascadeConfig(volume_planes=(16, 8), num_samples=(8, 2), warp_dtype="float32", **kw)


def port_model(kind: str, dtype=torch.float32, **kw):
    """The test models (``kind`` boost, enerf or mvsnerf) on the CPU."""
    if kind == "mvsnerf":
        return MVSNeRF(MVSNeRFConfig(num_samples=8, k_best=2), device="cpu").to(dtype)
    cls = BoostENeRF if kind == "boost" else ENeRF
    return cls(enerf_cas(k_best=4, **kw), device="cpu").to(dtype)


def _load(model, state: dict):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def train_step(kind: str, state: dict, batch: dict, mesh=None, ray_blocks: int = 0,
               cas=None) -> dict:
    """One step of ``kind`` from ``state`` (float64) on ``batch``: the whole
    batch, or under ``mesh`` this rank's shard of it (``place``). Returns
    the stats, the gradients as the step applied them (averaged over the
    ranks) and the state after the step."""
    model = _load(port_model(kind, STEP_DTYPE), state)
    st = tt.create_train_state(model, make_optimizer(TRAIN_CFG, EP_ITER))
    if mesh is not None:
        st, batch = tt.place(mesh, st, batch)
    if ray_blocks:
        step = tt.make_blocked_train_step(model, ray_blocks, mesh=mesh)
    else:
        step = tt.make_train_step(model, cas=cas, mesh=mesh)
    stats = step(st, batch)
    out = {f"stat/{k}": np.float64(v) for k, v in stats.items()}
    out.update({f"grad/{k}": p.grad.numpy() for k, p in model.named_parameters()})
    out.update({f"state/{k}": v.numpy() for k, v in model.state_dict().items()})
    return out


def mvs_cas() -> CascadeConfig:
    """The MVSNeRF recipe's loss settings (one level, random rays)."""
    return CascadeConfig(num=1, loss_weight=(1.0,), render_if=(True,), train_img=(False,),
                         num_samples=(8,))


# ------------------------------------------------------------------ cases


def case_bn(inputs: dict, world: int) -> dict:
    """ConvBnReLU in train mode on this rank's share of the batch, its
    statistics over the world: the output, the input gradient (a fixed
    cotangent), the running statistics."""
    block = ConvBnReLU(inputs["bn_x"].shape[-1], inputs["bn_ct"].shape[-1])
    _load(block, inputs["bn_state"]).train()
    mesh = mesh_lib.make_mesh(n_data=world, n_rays=1)
    mesh_lib.sync_batchnorm(block, mesh_lib.axis(mesh, "data")[2])
    x = torch.from_numpy(mesh_lib.shard_batch(mesh, {"x": inputs["bn_x"]})["x"])
    ct = torch.from_numpy(mesh_lib.shard_batch(mesh, {"x": inputs["bn_ct"]})["x"])
    x = x.permute(0, 3, 1, 2).requires_grad_()
    y = block(x)
    y.backward(ct.permute(0, 3, 1, 2))
    return {"bn/y": y.detach().permute(0, 2, 3, 1).numpy(),
            "bn/dx": x.grad.permute(0, 2, 3, 1).numpy(),
            "bn/mean": block.bn.running_mean.numpy(), "bn/var": block.bn.running_var.numpy()}


def _step_case(name, kind, n_data, n_rays, batch_key, ray_blocks=0, cas=None):
    def case(inputs: dict, world: int) -> dict:
        mesh = mesh_lib.make_mesh(n_data=n_data, n_rays=n_rays)
        res = train_step(kind, inputs[f"{kind}_state"], inputs[batch_key], mesh, ray_blocks,
                         cas() if cas else None)
        return {f"{name}/{k}": v for k, v in res.items()}

    return case


def case_staged(name: str, mesh_fn):
    def case(inputs: dict, world: int) -> dict:
        model = _load(port_model("boost", render_if=(True, True)), inputs["boost_state"])
        out = StagedENeRF(model, mesh_fn())(inputs["frame"])
        return {f"{name}/{k}": v.numpy() for k, v in out.items()}

    return case


def case_shards(inputs: dict, world: int) -> dict:
    mesh = mesh_lib.make_mesh(n_data=2, n_rays=2)
    shard = mesh_lib.shard_batch(mesh, inputs["boost_batch"])
    out = {f"shard/{k}": np.asarray(v) for k, v in shard.items()}
    cv = mesh_lib.make_cv_mesh(world, k_best=4)
    out["mesh/data_rays"] = np.array(mesh.mesh.shape)
    out["mesh/cv_rays"] = np.array(cv.mesh.shape)
    out["mesh/coords"] = np.array(mesh.get_coordinate())
    return out


def case_whole(inputs: dict, world: int) -> dict:
    """The port's own steps on the whole batches, in one process."""
    out = {}
    for kind, key in (("enerf", "enerf_batch"), ("boost", "boost_batch"),
                      ("mvsnerf", "mvs_batch")):
        res = train_step(kind, inputs[f"{kind}_state"], inputs[key],
                         cas=mvs_cas() if kind == "mvsnerf" else None)
        out.update({f"whole/{kind}/{k}": v for k, v in res.items()})
    return out


def case_checkpoint(inputs: dict, world: int) -> dict:
    """``CheckpointManager.save`` and ``Recorder`` under the process group:
    every rank saves into one directory and into one of its own, and asks
    for a record directory of its own (``<workdir>/ckpt/...``)."""
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
    from boostmvsnerfs_torch.train.recorder import Recorder

    root = os.path.join(inputs["workdir"], "ckpt")
    r = dist.get_rank()
    state = {"step": r, "model": {"w": torch.full((2,), float(r))}}
    CheckpointManager(os.path.join(root, "shared")).save(state, 0)
    after = CheckpointManager(os.path.join(root, "shared")).restore()  # after the barrier
    CheckpointManager(os.path.join(root, f"own{r}")).save(state, 0)
    recorder = Recorder(os.path.join(root, f"records{r}"))
    return {"ckpt/restored_step": np.int64(after["step"]),
            "ckpt/recorder_writes": np.bool_(recorder.writer is not None)}


CASES = {
    "whole": case_whole,
    "checkpoint": case_checkpoint,
    "bn": case_bn,
    "enerf/data2": _step_case("enerf/data2", "enerf", 2, 1, "enerf_batch"),
    "boost/data2": _step_case("boost/data2", "boost", 2, 1, "boost_batch"),
    "boost/rays2": _step_case("boost/rays2", "boost", 1, 2, "boost_batch"),
    "blocked/data2": _step_case("blocked/data2", "boost", 2, 1, "boost_batch", ray_blocks=4),
    "mvsnerf/data2": _step_case("mvsnerf/data2", "mvsnerf", 2, 1, "mvs_batch", cas=mvs_cas),
    "staged/cv2": case_staged("staged/cv2", lambda: mesh_lib.make_cv_mesh(k_best=4)),
    "eval/rays2": case_staged("eval/rays2", lambda: mesh_lib.make_mesh(n_data=1, n_rays=2)),
    # 4 ranks: k_best 2 factors 4 ranks into (cv=2, rays=2); the model folds K=4
    "staged/cv2rays2": case_staged("staged/cv2rays2", lambda: mesh_lib.make_cv_mesh(k_best=2)),
    "shards": case_shards,
}


# ------------------------------------------------------------ the processes


def rank_main(rank: int, world: int, workdir: str, cases: list, inputs: dict) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"),
                                                             world),
                                rank=rank, world_size=world)
        out = {}
        inputs = {**inputs, "workdir": workdir}
        for name in cases:
            out.update(CASES[name](inputs, world))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, cases: list, inputs: dict, workdir: str):
    """Start ``world`` ranks running ``cases`` on ``inputs``; returns
    ``join(timeout) -> [results of rank 0, 1, ...]``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, workdir, cases, inputs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()

    def join(timeout: float) -> list:
        import time

        end = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = {}
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{r}.err")
            if p.exitcode != 0:
                errors[r] = open(err).read() if os.path.exists(err) else f"exit {p.exitcode}"
        if hung or errors:
            raise AssertionError(f"ranks hung past {timeout} s: {hung}; failed: {errors}")
        return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(world)]

    return join
