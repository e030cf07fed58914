"""The fine-tuning entry's steps on random rays, for a recipe whose model
trains unblocked (the MVSNeRF family), on the configuration's ``finetune``
tree. Set-up runs as ``train_steps``' does: the recipe's view-selection
pre-pass over the train and test splits, ``batches`` batches from the
recipe's loader (``runner.train_loader``), the train state, and the first
``checked_steps`` steps recorded for the check; the step is the one
``runner.train_epochs`` builds for such a recipe, ``make_train_step`` with
the tree's loss settings. The window goes on with the same state, one batch
a step, cycled, each step's stats brought to the host. Unit ``key`` of the
check is the ``key``-th batch: the loader's draw of targets, view count and
rays (``ray_idx_0``), whose inputs the reference reads from the scene's
files (``reference/boost_mvsnerf_train.py``).

The cycled batches are held as a PyTorch loader with pinned memory hands
them to a step (``held``): each array a tensor of the type the step casts
it to, in page-locked host memory on a CUDA run. The step's copy of a
batch's 102 MB to the card is then a DMA at the bus's rate (under 4 ms on an
H100), where a pageable copy, staged by the host's own memcpy, took 16-18
ms and moved with the host's load from run to run."""

from __future__ import annotations

import numpy as np
import torch

from portbench.flows.train_steps import NUMBERS, TrainSteps
from portbench.harness import check
from portbench.harness.drive import Context, Flow
from portbench.reference import boost_mvsnerf_train as reference
from portbench.reference.plain import data

__all__ = ["NUMBERS", "RayTrainSteps", "build"]

FAULTS = ("control",) + reference.FAULTS


def held(batch: dict, dtype: torch.dtype, pin: bool) -> dict:
    """``batch`` with each array a tensor of the type the step's
    ``to_tensors`` casts it to (floats ``dtype``, the rest int64), in
    page-locked memory where ``pin``; ``meta`` as it is."""
    out = {}
    for k, v in batch.items():
        if k == "meta":
            out[k] = v
            continue
        t = torch.as_tensor(np.asarray(v))
        t = t.to(dtype if t.is_floating_point() else torch.int64)
        out[k] = t.pin_memory() if pin else t
    return out


class RayTrainSteps(TrainSteps):
    def __init__(self, ctx: Context):
        Flow.__init__(self, ctx, "finetune")
        import itertools

        from boostmvsnerfs_torch.data import make_dataset
        from boostmvsnerfs_torch.data.loader import Loader
        from boostmvsnerfs_torch.models.enerf import CascadeConfig
        from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
        from boostmvsnerfs_torch.train.schedule import make_optimizer

        runner, cfg, tr = self.runner, self.cfg, ctx.traffic
        self.forward = None
        train_ds = make_dataset(cfg, "train")
        vs = runner.run_view_selection(cfg, self.model, [Loader(train_ds, 1),
                                                         Loader(self.dataset, 1)])
        loader = runner.train_loader(cfg, train_ds)
        batches = [runner.attach_boost_inputs(b, vs, cfg)
                   for b in itertools.islice(iter(loader), int(tr["batches"]))]
        self.draws = [([int(m["tar_view"]) for m in b["meta"]], b["all_src_inps"].shape[1],
                       np.array(b["ray_idx_0"])) for b in batches]
        dtype = next(self.model.parameters()).dtype
        self.batches = [held(b, dtype, ctx.device.type == "cuda") for b in batches]
        self.state = create_train_state(self.model, make_optimizer(cfg["train"], len(loader)))
        self.step_fn = make_train_step(self.model, cas=CascadeConfig.from_cfg(cfg["enerf"]))
        self.next_batch = 0
        self.losses = []
        for t in range(int(tr["checked_steps"])):
            self.losses.append(self.unit()["loss"])
            if t == 0:
                self.first_grads = self.adam_first_gradients()
        self.after = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def reference_batch(self, key: int) -> dict:
        """The targets of the ``key``-th step's draw (the batches cycle)
        read from the scene's files, each with the rays the loader drew and
        their colours."""
        H, W = self.tree["train_dataset"]["input_h_w"]
        scales = self.tree["enerf"]["cas_config"]["render_scale"]
        targets, n_views, rays = self.draws[key % len(self.draws)]
        samples = []
        for t, idx in zip(targets, rays):
            s = data.sample(self.scene_dir, t, n_views, H, W, scales, True)
            samples.append({**s, "ray_idx_0": idx, "rgb_0": s["rgb_0"][idx]})
        return data.batch(samples)

    def readings(self, fault: str | None = None) -> dict:
        """``check.train_readings``' numbers against this recipe's reference:
        the program's first steps, or with ``fault`` the reference with it
        planted (``control``: TF32) in the program's place."""
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} in ray fine-tuning steps")
        device = self.ctx.device
        batches = [self.reference_batch(t) for t in range(len(self.losses))]
        p0 = self.weights
        with check.tf32(False):
            ref = reference.train_steps(self.tree, p0, batches, device)
        if fault is None:
            got = {"losses": self.losses, "first_grads": self.first_grads, "params": self.after}
        else:
            with check.tf32(fault == "control"):
                got = reference.train_steps(self.tree, p0, batches, device,
                                            None if fault == "control" else fault)

        def norms(d):
            return {k: float(v.float().norm()) for k, v in d.items()}

        def change(params):
            return {k: float((v.float() - p0[k].float()).norm()) for k, v in params.items()}

        g_ref = norms(ref["first_grads"])
        median = float(np.median(list(g_ref.values())))
        moved = {k for k, v in g_ref.items() if v >= check.ROUNDOFF * median}
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        out = {
            "first_loss_rel_gap": loss_gaps[0],
            "loss_rel_gap": max(loss_gaps),
            "grad_leaf_gap": check._leaf_gap(norms(got["first_grads"]), g_ref),
            "update_leaf_gap": check._leaf_gap(change(got["params"]), change(ref["params"]),
                                               moved),
            "update_median_gap": check._median_gap(change(got["params"]), change(ref["params"]),
                                                   moved),
            "leaves_left_out": float(len(g_ref) - len(moved)),
        }
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def build(ctx: Context) -> RayTrainSteps:
    return RayTrainSteps(ctx)
