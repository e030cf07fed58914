"""Checkpoint I/O with the reference's retention policy (counterpart of
``boostmvsnerfs_tpu/train/checkpoint.py``, which writes orbax trees).

Reference lib/utils/net_utils.py:390-412 (``save_model``): numbered
checkpoints plus a rolling ``latest``, pruned to the 5 most recent;
:350-387 (``load_model``) resume; :495-515 (``load_pretrain``) cross-task
warm start. Each checkpoint is one ``torch.save`` file of a train state's
``state_dict()`` (model, optimizer, scheduler, step), ``<epoch>.pt`` or
``latest.pt`` in the model directory.
"""

from __future__ import annotations

import os

import torch
from torch import nn


class CheckpointManager:
    def __init__(self, model_dir: str, keep: int = 5):
        self.model_dir = os.path.abspath(model_dir)
        self.keep = keep
        os.makedirs(self.model_dir, exist_ok=True)

    def _path(self, name) -> str:
        return os.path.join(self.model_dir, f"{name}.pt")

    # -- save -----------------------------------------------------------
    def save(self, state: dict, epoch: int, latest: bool = True) -> None:
        """Write ``state`` (a ``state_dict()``) as checkpoint ``epoch`` and,
        with ``latest``, as the rolling latest; keep the newest ``keep``
        numbered ones. Each file is written under a temporary name and
        renamed, so a crash never leaves half a checkpoint."""
        names = [epoch, "latest"] if latest else [epoch]
        for name in names:
            tmp = self._path(f"{name}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, self._path(name))
        for e in self.numbered_epochs()[: -self.keep]:
            os.remove(self._path(e))

    def numbered_epochs(self) -> list[int]:
        if not os.path.isdir(self.model_dir):
            return []
        return sorted(int(f[:-3]) for f in os.listdir(self.model_dir)
                      if f.endswith(".pt") and f[:-3].isdigit())

    # -- load -----------------------------------------------------------
    def latest_path(self) -> str | None:
        if os.path.isfile(self._path("latest")):
            return self._path("latest")
        epochs = self.numbered_epochs()
        return self._path(epochs[-1]) if epochs else None

    def restore(self, path: str | None = None) -> dict | None:
        """The state saved at ``path`` (default: the latest), loaded onto
        the CPU, or None when there is none."""
        path = path or self.latest_path()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrain(pretrain_dir: str, model: nn.Module) -> bool:
    """Warm-start ``model`` from another task's latest checkpoint: only the
    entries whose names and shapes match are loaded. Returns whether a
    checkpoint was found."""
    state = CheckpointManager(pretrain_dir).restore()
    if state is None:
        return False
    own = model.state_dict()
    matching = {k: v for k, v in state["model"].items()
                if k in own and own[k].shape == v.shape}
    model.load_state_dict(matching, strict=False)
    return True
