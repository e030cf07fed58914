"""The fine-tuning entry's steps, on the configuration's ``finetune`` tree.
Set-up runs the recipe's view-selection pre-pass over the train and test
splits, takes ``batches`` batches from the recipe's loader
(``runner.train_loader``), builds the train state and the ray-blocked step
as ``runner.train_epochs`` does, and runs the first ``checked_steps`` steps
through that step, recording what the check compares; the window goes on
with the same state, one batch a step, cycled, each step's stats brought
to the host. Unit ``key`` of the check is the ``key``-th batch: the
loader's draw of targets and view count, whose inputs the reference reads
from the scene's files."""

from __future__ import annotations

from portbench.harness import check
from portbench.harness.drive import Context, Flow
from portbench.reference.plain import data

NUMBERS = ("first_loss_rel_gap", "loss_rel_gap", "grad_leaf_gap", "update_leaf_gap",
           "update_median_gap", "leaves_left_out")
FAULTS = ("control", "half_batch", "altered")


class TrainSteps(Flow):
    def __init__(self, ctx: Context):
        super().__init__(ctx, "finetune")
        import itertools

        from boostmvsnerfs_torch.data import make_dataset
        from boostmvsnerfs_torch.data.loader import Loader
        from boostmvsnerfs_torch.parallel.train import create_train_state, make_blocked_train_step
        from boostmvsnerfs_torch.train.schedule import make_optimizer

        runner, cfg, tr = self.runner, self.cfg, ctx.traffic
        self.forward = None
        train_ds = make_dataset(cfg, "train")
        vs = runner.run_view_selection(cfg, self.model, [Loader(train_ds, 1),
                                                         Loader(self.dataset, 1)])
        loader = runner.train_loader(cfg, train_ds)
        self.batches = [runner.attach_boost_inputs(b, vs, cfg)
                        for b in itertools.islice(iter(loader), int(tr["batches"]))]
        self.draws = [([int(m["tar_view"]) for m in b["meta"]], b["all_src_inps"].shape[1])
                      for b in self.batches]
        self.state = create_train_state(self.model, make_optimizer(cfg["train"], len(loader)))
        self.step_fn = make_blocked_train_step(self.model, int(tr["ray_blocks"]))
        self.next_batch = 0
        self.losses = []
        for t in range(int(tr["checked_steps"])):
            self.losses.append(self.unit()["loss"])
            if t == 0:
                self.first_grads = self.adam_first_gradients()
        self.after = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def adam_first_gradients(self) -> dict:
        """Each parameter's first gradient as Adam took it, from its state
        after one step: ``exp_avg / (1 - beta1)``."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: opt.state[p]["exp_avg"] / (1.0 - beta1)
                for n, p in self.model.named_parameters() if p in opt.state}

    def unit(self) -> dict:
        batch = self.batches[self.next_batch]
        self.next_batch = (self.next_batch + 1) % len(self.batches)
        batch = {k: v for k, v in batch.items() if k != "meta"}
        return {k: float(v) for k, v in self.step_fn(self.state, batch).items()}

    def reference_batch(self, key: int) -> dict:
        H, W = self.tree["train_dataset"]["input_h_w"]
        targets, n_views = self.draws[key]
        cas = self.tree["enerf"]["cas_config"]
        if not all(cas["train_img"]):
            raise ValueError("the reference reads whole-image targets only")
        scales = cas["render_scale"]
        return data.batch([data.sample(self.scene_dir, t, n_views, H, W, scales, True)
                           for t in targets])

    def readings(self, fault: str | None = None) -> dict:
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} in fine-tuning steps")
        return check.train_readings(self, fault)

    def free_program(self) -> None:
        self.state = self.step_fn = None
        super().free_program()


def build(ctx: Context) -> TrainSteps:
    return TrainSteps(ctx)
