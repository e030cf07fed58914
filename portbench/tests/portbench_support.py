"""What the benchmark's CPU tests share: the cells' files at a small size."""

from __future__ import annotations

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config_file(name: str, hw=(64, 96)) -> dict:
    """The configuration file ``name`` with the images of each of its trees
    at ``hw``."""
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        config = copy.deepcopy(json.load(f))
    for tree in ("cfg", "finetune"):
        for split in ("train_dataset", "test_dataset"):
            if tree in config:
                config[tree][split]["input_h_w"] = list(hw)
    return config


def traffic(name: str, images: int = 16, **kw) -> dict:
    """The traffic ``name`` over a scene of ``images`` views (every 8th a
    test view)."""
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return {**json.load(f), "images": images, **kw}


def cell_files(cell: str, hw=(64, 96), images: int = 16, **kw) -> tuple[dict, dict]:
    """(configuration file, traffic) of ``cell`` at a small size."""
    w = next(w for w in manifest()["workloads"] if w["name"] == cell)
    return config_file(w["config"], hw), traffic(w["traffic"], images, **kw)
