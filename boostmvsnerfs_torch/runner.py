"""Training entry point (counterpart of ``boostmvsnerfs_tpu/runner.py::
run_train``).

The JAX entry builds its dataset and loader from a YAML config; until the
port has its own ``config.py`` and ``data/``, ``run_train`` takes the model
and an epoch of numpy batches (the JAX batch convention; BoostENeRF batches
carry ``combos`` and ``k_best`` from a view selection).
"""

from __future__ import annotations

import os
import time
from typing import Sequence

from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.parallel.train import (
    TrainState,
    create_train_state,
    make_blocked_train_step,
    make_train_step,
)
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager, load_pretrain
from boostmvsnerfs_torch.train.recorder import Recorder
from boostmvsnerfs_torch.train.schedule import make_optimizer


def run_train(
    model: nn.Module,
    batches: Sequence[dict],
    train_cfg: dict,
    model_dir: str,
    *,
    record_dir: str | None = None,
    log_interval: int = 20,
    save_ep: int = 1,
    save_latest_ep: int = 1,
    resume: bool = True,
    pretrain_dir: str | None = None,
    ray_blocks: int = 0,
    device=None,
) -> TrainState:
    """Train ``model`` for ``train_cfg['epoch']`` epochs over ``batches``
    (one epoch; ``train_cfg`` also holds ``lr``, ``optim``, ``eps``,
    ``weight_decay`` and ``scheduler`` as the reference configs'
    ``train`` node does). Logs the windowed statistics every
    ``log_interval`` steps, saves a numbered and the latest checkpoint into
    ``model_dir`` every ``save_ep`` / ``save_latest_ep`` epochs, and resumes
    from the latest one there (or warm-starts from ``pretrain_dir``).
    ``ray_blocks > 1`` takes the ray-blocked step (``make_blocked_train_step``).
    Runs on CUDA unless ``device`` says otherwise; returns the final state."""
    model.to(resolve_device(device))
    ep_iter = len(batches)
    state = create_train_state(model, make_optimizer(train_cfg, ep_iter))
    mgr = CheckpointManager(model_dir)
    recorder = Recorder(record_dir)
    begin_epoch = 0
    restored = mgr.restore() if resume else None
    if restored is not None:
        state.load_state_dict(restored)
        begin_epoch = state.step // max(ep_iter, 1)
        print(f"resumed at epoch {begin_epoch}", flush=True)
    elif pretrain_dir and load_pretrain(pretrain_dir, model):
        print(f"warm start from {os.path.abspath(pretrain_dir)}", flush=True)

    step_fn = (make_blocked_train_step(model, ray_blocks) if ray_blocks > 1
               else make_train_step(model))
    for epoch in range(begin_epoch, int(train_cfg["epoch"])):
        t_ep = time.time()
        for it, batch in enumerate(batches):
            stats = step_fn(state, batch)
            recorder.step += 1
            if it % log_interval == 0:
                recorder.update({k: float(v) for k, v in stats.items()})
                recorder.record("train")
                print(f"epoch {epoch} iter {it}/{ep_iter} {recorder}", flush=True)
        if (epoch + 1) % save_ep == 0 or (epoch + 1) % save_latest_ep == 0:
            mgr.save(state.state_dict(), epoch, latest=True)
        print(f"epoch {epoch} done in {time.time() - t_ep:.1f}s", flush=True)
    recorder.close()
    return state
