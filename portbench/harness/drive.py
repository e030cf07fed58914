"""The general generator: builds a cell's scene, weights and program from
its configuration and traffic files and drives one unit of work (a frame
or a step) at a time through the port's entry functions, keeping what the
check compares.

A traffic file (``portbench/traffic/<mix>.json``) names its ``flow`` and
the flow's parameters. The flow is the kind of work, one file of its own,
``portbench/flows/<flow>.py``, found by that name: its ``build(ctx)``
returns a ``Flow``, and its ``NUMBERS`` name what its ``readings`` compute
for the check. A later mix of a known flow is a data file alone.

Every unit ends in a card synchronisation, so its latency is the host's
clock from its start to the card's finish. The program is the port; the
scene and the weights are the benchmark's, made from the seed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import shutil
import tempfile

import numpy as np
import torch

from portbench.harness import scene as scene_lib
from portbench.harness.weights import seeded_state_dict

SCENE = "walk"
FLOWS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "flows")


@dataclasses.dataclass
class Context:
    """What a flow is built from: the configuration file (its tree under
    ``cfg``), the traffic's parameters, the seed and the device."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device

    @property
    def cfg(self) -> dict:
        return self.config["cfg"]


@dataclasses.dataclass
class Sample:
    """One frame of the window kept for the check: which frame it was, the
    program's picks and its compared outputs (on the card)."""

    index: int
    key: int
    picks: np.ndarray
    outputs: dict


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``size`` of the window's frames, drawn from the
    seed (reservoir sampling): a frame's outputs are copied only when drawn."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 7])
        self.kept: list[Sample] = []
        self.seen = 0

    def offer(self, make) -> None:
        """``make()`` builds the frame's Sample when the draw keeps it."""
        i = self.seen
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(make(i))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.size:
                self.kept[j] = make(i)


class Flow:
    """Set-up shared by the flows: the scene on disk, the configuration
    tree pointed at it, the port's model holding the seeded weights, and
    its frame executor. A flow adds ``unit()``, one unit of work, and
    what the check reads."""

    def __init__(self, ctx: Context, tree: str = "cfg"):
        from boostmvsnerfs_torch import runner
        from boostmvsnerfs_torch.config import CfgNode, finalize_cfg
        from boostmvsnerfs_torch.data import make_dataset

        self.ctx = ctx
        self.runner = runner
        tr = ctx.traffic
        self.tree = ctx.config[tree]
        self.workdir = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
        H, W = self.tree["test_dataset"]["input_h_w"]
        root = os.path.join(self.workdir, self.tree["test_dataset"]["data_root"])
        scene_lib.write_free_scene(root, SCENE, tr["images"], H, W, ctx.seed)
        self.scene_dir = os.path.join(root, SCENE)
        cfg = CfgNode.from_dict(self.tree)
        cfg.workspace, cfg.scene = self.workdir, SCENE
        finalize_cfg(cfg)
        self.cfg = cfg
        self.dataset = make_dataset(cfg, "test")
        self.model = runner.make_network(cfg, ctx.device)
        self.weights = seeded_state_dict(self.model.state_dict(), ctx.seed, ctx.device)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.eval()
        self.forward = runner.make_forward(cfg, self.model)
        self.compared = tuple(ctx.config["compared"])
        self.reservoir = Reservoir(int(tr.get("checked_frames", 0)), ctx.seed)
        self.order_rng = np.random.default_rng([ctx.seed, 3])
        self.combos = runner.view_combinations(int(cfg["enerf"]["test_input_views"]),
                                               int(cfg["enerf"]["cost_volume_input_views"]))
        self.k = int(cfg["enerf"]["cas_config"]["k_best"])

    def render(self, np_batch: dict) -> dict:
        """The frame: the batch to the card, the executor, a card sync."""
        out = self.forward(self.runner._device_batch(np_batch, self.ctx.device))
        sync(self.ctx.device)
        return out

    def keep(self, key: int, picks, out: dict) -> None:
        self.reservoir.offer(lambda i: Sample(i, key, np.array(picks),
                                              {k: out[k].detach().clone() for k in self.compared}))

    def reference_batch(self, key: int) -> dict:
        """The reference's inputs of unit ``key``, read from the scene's
        files (``reference/plain/data.py``)."""
        raise NotImplementedError

    def readings(self, fault: str | None = None) -> dict:
        """The numbers the check compares (the flow module's ``NUMBERS``):
        the program's against the reference's, or with ``fault``
        (``control``, or a fault the flow plants) that in its place."""
        raise NotImplementedError

    def free_program(self) -> None:
        """Drop the program's model and executor (the check's reference
        runs after them); the seeded weights stay."""
        self.model = self.forward = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def flow_module(name: str):
    """The module of flow ``name``: ``portbench/flows/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench_flow_{name}",
                                                  os.path.join(FLOWS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_flow(ctx: Context) -> Flow:
    return flow_module(ctx.traffic["flow"]).build(ctx)
