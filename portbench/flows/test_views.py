"""The eval entry's frames over the test split: set-up decodes the test
views' batches once and runs the port's view-selection pre-pass
(``runner.run_view_selection``) for their ``k_best``; each frame moves a
batch to the card (``runner._device_batch``) and renders it through the
frame executor (``runner.make_forward``), over the test views in a seeded
order, cycled. Unit ``key`` renders the ``key``-th test view."""

from __future__ import annotations

from portbench.harness import check
from portbench.harness.drive import Context, Flow
from portbench.reference.plain import data

NUMBERS = ("rgb_mae", "depth_rel_mae", "rgb_max", "rgb_p999", "pick_step_gap",
           "min_pick_margin")


class TestViews(Flow):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        from boostmvsnerfs_torch.data.loader import Loader

        vs = self.runner.run_view_selection(self.cfg, self.model, [Loader(self.dataset, 1)])
        self.batches = [self.runner.attach_boost_inputs(b, vs, self.cfg)
                        for b in Loader(self.dataset, 1)]
        self.order: list[int] = []
        for i in range(len(self.batches)):  # the warm-up: every view's shapes
            self.render(self.batches[i])

    def next_key(self) -> int:
        if not self.order:
            self.order = list(self.order_rng.permutation(len(self.batches)))
        return int(self.order.pop())

    def unit(self) -> None:
        key = self.next_key()
        np_batch = self.batches[key]
        out = self.render(np_batch)
        self.keep(key, np_batch["k_best"][0], out)

    def reference_batch(self, key: int) -> dict:
        H, W = self.tree["test_dataset"]["input_h_w"]
        en = self.tree["enerf"]
        _, test = data.split_ids(len(data.image_names(self.scene_dir)))
        return data.batch([data.sample(self.scene_dir, test[key], int(en["test_input_views"]),
                                       H, W, en["cas_config"]["render_scale"], False)])

    def readings(self, fault: str | None = None) -> dict:
        if fault not in (None, "control"):
            raise ValueError(f"no fault {fault!r} in eval frames")
        return check.frame_readings(self, self.reservoir.kept, control=fault == "control")


def build(ctx: Context) -> TestViews:
    return TestViews(ctx)
