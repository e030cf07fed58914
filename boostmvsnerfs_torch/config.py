"""Config system: attribute-access dict tree + recursive YAML inheritance
(counterpart of ``boostmvsnerfs_tpu/config.py``, same trees from the same
files).

``make_cfg`` follows the recursive ``parent_cfg`` chain, then applies CLI
dotted-key overrides up to the ``other_opts`` escape hatch (reference
lib/config/config.py:170-188). ``parent_cfg`` paths and
``configs/default.yaml`` are read relative to the working directory, as in
the JAX package, so the entry runs from the repository root. PyYAML is
imported where a file or override is parsed, so the package imports
without it.
"""

from __future__ import annotations

import copy
import os
from typing import Any


class CfgNode(dict):
    """Dict with attribute access and recursive merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        node = CfgNode()
        for k, v in self.items():
            node[k] = copy.deepcopy(v, memo)
        return node

    @staticmethod
    def from_dict(d: dict) -> "CfgNode":
        node = CfgNode()
        for k, v in d.items():
            node[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()}

    def merge_from(self, other: dict) -> None:
        """Recursively merge ``other`` into self (other wins)."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                sub = self[k]
                if not isinstance(sub, CfgNode):
                    sub = CfgNode.from_dict(sub)
                    self[k] = sub
                sub.merge_from(v)
            else:
                self[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v

    def merge_from_list(self, opts: list) -> None:
        """CLI-style overrides: ["a.b.c", "1", "x", "[1,2]"] pairs, up to
        the literal token ``other_opts``."""
        if "other_opts" in opts:
            opts = opts[: opts.index("other_opts")]
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs: {opts}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _parse_value(raw, node.get(parts[-1]))


def _parse_value(raw: Any, old: Any) -> Any:
    if not isinstance(raw, str):
        return raw
    import yaml

    try:
        val = yaml.safe_load(raw)
    except yaml.YAMLError:
        val = raw
    if isinstance(val, str):
        # YAML 1.1 does not recognise "1e-3"-style floats
        try:
            val = float(val)
        except ValueError:
            pass
    if old is not None and isinstance(old, bool) and isinstance(val, int):
        val = bool(val)
    return val


def default_cfg() -> CfgNode:
    """Every default key of the JAX package's tree, the TPU ones (``mesh``,
    ``precision``) included, so that every YAML merges unchanged; the port
    never reads those two."""
    return CfgNode.from_dict(
        {
            "task": "hello",
            "exp_name": "default",
            "exp_name_tag": "",
            "pretrain": "",
            "workspace": os.environ.get("workspace", "workspace"),
            "scene": "",
            "save_result": False,
            "clear_result": False,
            "save_tag": "default",
            "eval_lpips": True,
            "skip_eval": False,
            "fix_random": False,
            "debug_nans": False,
            "profile_dir": "",
            "resume": True,
            "ep_iter": -1,
            "save_ep": 1,
            "save_latest_ep": 1,
            "eval_ep": 1,
            "log_interval": 20,
            "write_video": False,
            "train_dataset_module": "",
            "test_dataset_module": "",
            "network_module": "",
            "loss_module": "",
            "evaluator_module": "",
            "visualizer_module": "",
            "train_dataset": {},
            "test_dataset": {},
            "train": {
                "epoch": 300,
                "optim": "adam",
                "lr": 5e-4,
                "weight_decay": 0.0,
                "eps": 1e-8,
                "batch_size": 1,
                "shuffle": True,
                "scheduler": {"type": "exponential", "gamma": 0.5, "decay_epochs": 50},
                "batch_sampler": "default",
                "sampler_meta": {},
                "num_workers": 0,
                "collator": "default",
            },
            "test": {
                "batch_size": 1,
                "batch_sampler": "default",
                "sampler_meta": {},
                "collator": "default",
            },
            "mesh": {"data": 1, "rays": 1},
            "precision": {"compute_dtype": "float32", "conv_dtype": "bfloat16"},
        }
    )


def load_cfg_file(path: str, cfg: CfgNode | None = None) -> CfgNode:
    """Load a YAML config following its recursive ``parent_cfg`` chain."""
    import yaml

    if cfg is None:
        cfg = default_cfg()
    with open(path) as f:
        current = yaml.safe_load(f) or {}
    if "parent_cfg" in current:
        cfg = load_cfg_file(current["parent_cfg"], cfg)
        current = {k: v for k, v in current.items() if k != "parent_cfg"}
    cfg.merge_from(current)
    return cfg


def make_cfg(cfg_file: str, opts: list | None = None) -> CfgNode:
    """The defaults, then ``configs/default.yaml`` (the site hook), then
    ``cfg_file``'s chain, then ``opts``; ``finalize_cfg`` last."""
    cfg = default_cfg()
    site_default = os.path.join("configs", "default.yaml")
    if os.path.exists(site_default) and os.path.abspath(site_default) != os.path.abspath(cfg_file):
        cfg = load_cfg_file(site_default, cfg)
    cfg = load_cfg_file(cfg_file, cfg)
    if opts:
        cfg.merge_from_list(list(opts))
    finalize_cfg(cfg)
    return cfg


def finalize_cfg(cfg: CfgNode) -> None:
    """Derive the model, record and result dirs (reference
    lib/config/config.py:157-168)."""
    if cfg.get("exp_name_tag"):
        cfg.exp_name = f"{cfg.exp_name}_{cfg.exp_name_tag}"
    ws = cfg.workspace
    cfg.trained_model_dir = os.path.join(ws, "trained_model", cfg.task, cfg.exp_name)
    cfg.record_dir = os.path.join(ws, "record", cfg.task, cfg.exp_name)
    cfg.result_dir = os.path.join(ws, "result", cfg.task, cfg.exp_name,
                                  cfg.get("save_tag", "default"))
