"""Experiment runner: network factory, view-selection pre-pass, evaluation,
and the training loop (counterpart of ``boostmvsnerfs_tpu/runner.py``).

``run_evaluate`` is the eval entry over a YAML config: the dataset and
loader from ``make_dataset``, the view-selection pre-pass writing
``view_selection.json`` when a boost model finds none (reference
run.py:39-69), every test view rendered, and PSNR/SSIM/LPIPS per scene plus
the frame rate (reference run.py:87-129). ``run_train`` takes the model and
an epoch of numpy batches (the JAX batch convention; BoostENeRF batches
carry ``combos`` and ``k_best`` from a view selection); its YAML
counterpart is queue 1 item 3 of ROADMAP.md.

Not carried from the JAX runner: ``autotune_model`` and the
``host_sync`` / ``frame_sync`` calls (TPU machinery), ``make_forward``'s
staged executors, the device mesh and ``device_trace``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from boostmvsnerfs_torch import resolve_device
from boostmvsnerfs_torch.data import make_dataset
from boostmvsnerfs_torch.data.loader import Loader
from boostmvsnerfs_torch.eval.evaluator import Evaluator
from boostmvsnerfs_torch.eval.lpips import fixture_lpips, load_lpips
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF, search_k_best, view_combinations
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, ENeRF, to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, MVSNeRFConfig
from boostmvsnerfs_torch.parallel.train import (
    TrainState,
    create_train_state,
    make_blocked_train_step,
    make_train_step,
)
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager, load_pretrain
from boostmvsnerfs_torch.train.recorder import Recorder
from boostmvsnerfs_torch.train.schedule import make_optimizer
from boostmvsnerfs_torch.utils.port_weights import random_state_dict

# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def make_network(cfg, device=None) -> nn.Module:
    """Model from cfg.network_module's last component, in eval mode, on
    CUDA unless ``device`` says otherwise."""
    name = cfg["network_module"].rsplit(".", 1)[-1]
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    if name == "boost_enerf":
        return BoostENeRF(cas, device=device)
    if name == "enerf":
        return ENeRF(cas, device=device)
    if name in ("boost_mvsnerf", "mvsnerf"):
        cls = BoostMVSNeRF if name == "boost_mvsnerf" else MVSNeRF
        return cls(MVSNeRFConfig.from_cfg(cfg), device=device)
    if name in ("enerf_composite", "enerf_human"):
        raise NotImplementedError(
            f"network {name!r} is not in the port yet (ROADMAP queue 1 item 7, the variants)")
    raise ValueError(f"unknown network module: {cfg['network_module']}")


def requires_view_selection(cfg) -> bool:
    name = cfg.get("network_module", "").rsplit(".", 1)[-1]
    return bool(cfg.get("enerf", {}).get("require_view_selection", False)) or \
        name.startswith("boost_")


def _device_batch(np_batch: dict, device) -> dict:
    return to_tensors({k: v for k, v in np_batch.items() if k != "meta"}, device)


# ---------------------------------------------------------------------------
# view selection (pre-pass -> view_selection.json)
# ---------------------------------------------------------------------------


def view_selection_path(cfg) -> str:
    return os.path.join(cfg["result_dir"], "view_selection.json")


def greedy_select(model, batch: dict, combos: np.ndarray, k: int) -> np.ndarray:
    """Greedy coverage selection for one batch: (B, k) combination ids,
    padded with repeats to exactly k entries. The coverage masks of every
    combination (``model.forward_view_selection``) come to the host once."""
    masks = model.forward_view_selection(batch, combos).cpu().numpy()  # (n_combos, B, H, W)
    out = []
    for b in range(masks.shape[1]):
        picks = search_k_best(masks[:, b], k)
        while len(picks) < k:
            picks.append(picks[-1])
        out.append(picks)
    return np.asarray(out, np.int32)


def run_view_selection(cfg, model, loaders) -> dict:
    """Greedy per-target-view combination selection over the loaders'
    batches, written to ``view_selection.json`` keyed
    ``f"{scene}_{tar_view}"`` (reference run.py:39-69 +
    boost_enerf/network.py:97-121). Combination tables are built per batch
    view count: train loaders can carry fewer views than test ones."""
    n_input = int(cfg["enerf"].get("cost_volume_input_views", 3))
    k = int(cfg["enerf"]["cas_config"]["k_best"])
    combo_cache: dict[int, np.ndarray] = {}
    results = {}
    for loader in loaders:
        for np_batch in loader:
            n_views = int(np_batch["all_src_inps"].shape[1])
            if n_views not in combo_cache:
                combo_cache[n_views] = view_combinations(n_views, n_input)
            picks = greedy_select(model, _device_batch(np_batch, model.device),
                                  combo_cache[n_views], k)
            for b, meta in enumerate(np_batch["meta"]):
                results[f"{meta['scene']}_{meta['tar_view']}"] = [int(i) for i in picks[b]]
    os.makedirs(cfg["result_dir"], exist_ok=True)
    with open(view_selection_path(cfg), "w") as f:
        json.dump(results, f)
    return results


def load_view_selection(cfg) -> dict:
    with open(view_selection_path(cfg)) as f:
        return json.load(f)


def attach_boost_inputs(np_batch: dict, view_selection: dict, cfg) -> dict:
    """Add the combination table and each sample's k_best ids to a batch.
    Selections made over a larger table than this batch's (train batches
    may carry fewer views than the pre-pass saw) clamp into this batch's
    table."""
    n_views = np_batch["all_src_inps"].shape[1]
    n_input = int(cfg["enerf"].get("cost_volume_input_views", 3))
    combos = view_combinations(n_views, n_input)
    np_batch["combos"] = combos
    k_best = [view_selection[f"{m['scene']}_{m['tar_view']}"] for m in np_batch["meta"]]
    np_batch["k_best"] = np.minimum(np.asarray(k_best, np.int32), len(combos) - 1)
    return np_batch


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _init_or_load(cfg, model: nn.Module) -> None:
    """Load ``latest.pt``'s ``"model"`` from ``cfg.trained_model_dir``
    (``train/checkpoint.CheckpointManager``); without one, warn and take
    seeded random weights (``utils/port_weights.random_state_dict(model,
    0)``)."""
    mgr = CheckpointManager(cfg["trained_model_dir"])
    state = mgr.restore()
    if state is not None:
        model.load_state_dict(state["model"], strict=True)
        print(f"loaded weights from {mgr.latest_path()}", flush=True)
        return
    print("WARNING: no trained weights found; using random init", flush=True)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_state_dict(model, 0).items()}, strict=True)


def _load_lpips(cfg, device):
    """LPIPS metric and its report key. With converted official weights
    (``cfg.lpips_weights.vgg`` / ``.lin``) the calibrated LPIPS of the
    reference evaluator (lib/evaluators/enerf.py:25,81-87); without them
    the fixture weights, reported as 'lpips_uncalibrated' so the numbers
    are never mistaken for published LPIPS."""
    if not cfg.get("eval_lpips", False):
        return None, "lpips"
    w = cfg.get("lpips_weights", {})
    if w and os.path.exists(w.get("vgg", "")) and os.path.exists(w.get("lin", "")):
        return load_lpips(w["vgg"], w["lin"], device), "lpips"
    return fixture_lpips(device=device), "lpips_uncalibrated"


def run_evaluate(cfg, model: nn.Module | None = None, device=None) -> dict:
    """Evaluate on the config's test split: returns the evaluator's summary
    (``psnr``, ``ssim``, the LPIPS key, depth metrics when asked for), the
    frame rate over the frames after the first (``fps``) and every frame's
    time (``frame_ms``). Without ``model``, the network comes from
    ``make_network`` with ``_init_or_load``'s weights; a given model keeps
    its own weights. Runs on CUDA unless ``device`` says otherwise. A frame
    is timed as the JAX entry times it: the batch lands on the device
    first, then the forward runs to a device synchronisation."""
    device = resolve_device(device)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    if model is None:
        model = make_network(cfg, device)
        _init_or_load(cfg, model)
    model.to(device).eval()
    loader = Loader(make_dataset(cfg, "test"), batch_size=int(cfg["test"]["batch_size"]))

    boost = requires_view_selection(cfg)
    vs = None
    if boost:
        if not os.path.exists(view_selection_path(cfg)):
            run_view_selection(cfg, model, [loader])
        vs = load_view_selection(cfg)

    lpips_fn, lpips_key = _load_lpips(cfg, device)
    evaluator = Evaluator(
        cas,
        lpips_fn=lpips_fn,
        lpips_key=lpips_key,
        eval_depth=bool(cfg["enerf"].get("eval_depth", False)),
        eval_center=bool(cfg["enerf"].get("eval_center", False)),
        save_result=bool(cfg.get("save_result", False)),
        result_dir=cfg.get("result_dir"),
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    net_times = []
    for np_batch in loader:
        if boost:
            np_batch = attach_boost_inputs(np_batch, vs, cfg)
        batch = _device_batch(np_batch, device)
        sync()
        t0 = time.perf_counter()
        out = model(batch)
        sync()
        net_times.append(time.perf_counter() - t0)
        evaluator.evaluate(out, np_batch)
    ret = evaluator.summarize()
    ret["frame_ms"] = [t * 1e3 for t in net_times]
    if len(net_times) > 1:
        fps = 1.0 / float(np.mean(net_times[1:]))
        print(f"FPS: {fps:.3f}")
        ret["fps"] = fps
    return ret


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


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
