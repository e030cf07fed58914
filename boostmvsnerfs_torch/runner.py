"""Experiment runner: network factory, view-selection pre-pass, evaluation,
and the training loop (counterpart of ``boostmvsnerfs_tpu/runner.py``).

``run_evaluate`` is the eval entry over a YAML config: the dataset and
loader from ``make_dataset``, the view-selection pre-pass writing
``view_selection.json`` when a boost model finds none (reference
run.py:39-69), every test view rendered, and PSNR/SSIM/LPIPS per scene plus
the frame rate (reference run.py:87-129). ``render_novel_path`` renders a
camera path through the test views to video. ``run_train`` is the training
entry over a YAML config; its loop, ``train_epochs``, takes the model and
an epoch of numpy batches (the JAX batch convention; BoostENeRF batches
carry ``combos`` and ``k_best`` from a view selection).

Not carried from the JAX runner: ``autotune_model`` and the
``host_sync`` / ``frame_sync`` calls (TPU machinery), ``make_forward``'s
staged executors, the device mesh and ``device_trace``.
"""

from __future__ import annotations

import json
import os
import time

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


def _network_name(cfg) -> str:
    return cfg["network_module"].rsplit(".", 1)[-1]


def make_network(cfg, device=None) -> nn.Module:
    """Model from cfg.network_module's last component, in eval mode, on
    CUDA unless ``device`` says otherwise. MVSNeRF models take their
    renderer head from ``cfg.mvsnerf.net_type``."""
    name = _network_name(cfg)
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
# novel camera paths
# ---------------------------------------------------------------------------


def novel_path_batches(cfg, dataset, n_frames: int, path_type: str = "interpolate"):
    """The batches of a camera path (``render_novel_path``), numpy, one
    frame each, from ``dataset`` (the test split): cameras interpolated
    through, or spiralled around, the first scene's test views; each
    frame's source views the ``test_input_views`` nearest its camera, its
    target image the nearest view's, its ``tar_ext`` the path's."""
    from boostmvsnerfs_torch.data.base import collate, nearest_src_views
    from boostmvsnerfs_torch.utils import camera_paths

    scene = next(iter(dataset.scene_infos))
    c2ws = np.asarray(dataset.scene_infos[scene]["c2ws"])
    anchors = c2ws[sorted({m[1] for m in dataset.metas if m[0] == scene})]
    if path_type == "spiral":
        path = camera_paths.spiral_path(anchors, n_frames)
    else:
        path = camera_paths.interpolate_path(anchors, n_frames)
    n_views = int(cfg["enerf"]["test_input_views"])
    for c2w in path:
        order = [int(i) for i in nearest_src_views(c2ws, c2w, n_views, exclude_self=False)]
        dataset.metas = [(scene, order[0], order)]  # a crafted meta per frame
        sample = dataset.get_sample(0)
        sample["tar_ext"] = np.linalg.inv(c2w).astype(np.float32)
        yield collate([sample])


def render_novel_path(cfg, n_frames: int = 60, path_type: str = "interpolate",
                      device=None) -> dict:
    """Render a novel camera trajectory (JAX ``runner.render_novel_path``,
    the reference's cfg.render_path flow): the frames of
    ``novel_path_batches``, for boost models each with the greedy coverage
    selection of its combinations (``greedy_select``), through the model
    into the ``Visualizer``. The weights come from ``_init_or_load``.
    Returns the visualizer's summary with, per frame, the selection's and
    the forward's times (ms, to a device synchronisation) and the
    ``k_best`` picks. Runs on CUDA unless ``device`` says otherwise."""
    from boostmvsnerfs_torch.eval.visualizer import Visualizer

    device = resolve_device(device)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    model = make_network(cfg, device)
    _init_or_load(cfg, model)
    dataset = make_dataset(cfg, "test")
    boost = requires_view_selection(cfg)

    if boost:
        combos = view_combinations(int(cfg["enerf"]["test_input_views"]),
                                   int(cfg["enerf"].get("cost_volume_input_views", 3)))
        k = int(cfg["enerf"]["cas_config"]["k_best"])
    vis = Visualizer(cas, cfg["result_dir"], write_video=cfg.get("write_video", True),
                     fps=int(cfg.get("fps", 10)))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    frames = []
    for fi, np_batch in enumerate(novel_path_batches(cfg, dataset, n_frames, path_type)):
        t0 = time.perf_counter()
        if boost:
            np_batch["combos"] = combos
            np_batch["k_best"] = greedy_select(model, _device_batch(np_batch, device), combos, k)
        batch = _device_batch(np_batch, device)
        sync()
        t1 = time.perf_counter()
        out = model(batch)
        sync()
        t2 = time.perf_counter()
        np_batch["meta"][0]["tar_view"] = fi
        vis.visualize(out, np_batch)
        frames.append({"select_ms": (t1 - t0) * 1e3, "frame_ms": (t2 - t1) * 1e3,
                       "k_best": np_batch["k_best"][0].tolist() if boost else None})
    return {**vis.summarize(), "path_type": path_type, "per_frame": frames}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_epochs(
    model: nn.Module,
    batches,
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
    perceptual_fn=None,
    image_hw: tuple | None = None,
    prepare=None,
    eval_ep: int = 0,
    validate=None,
    on_record=None,
    device=None,
    cas: CascadeConfig | None = None,
) -> TrainState:
    """Train ``model`` for ``train_cfg['epoch']`` epochs over ``batches``,
    one epoch: a list of batches, or a ``Loader`` (``set_epoch`` before
    each epoch). ``train_cfg`` holds ``lr``, ``optim``, ``eps``,
    ``weight_decay`` and ``scheduler`` as the reference configs' ``train``
    node does. ``prepare(batch)`` completes each batch before the step
    (``attach_boost_inputs``); ``meta`` never reaches the step. Logs the
    windowed statistics every ``log_interval`` steps, saves a numbered and
    the latest checkpoint into ``model_dir`` every ``save_ep`` /
    ``save_latest_ep`` epochs, and resumes from the latest one there (or
    warm-starts from ``pretrain_dir``). Every ``eval_ep`` epochs
    ``validate()`` returns a summary whose scalars are recorded as
    ``val_*``; a validation that raises is printed and training goes on.
    ``on_record(kind, state, scalars)`` sees every record ('train', with
    ``epoch`` and ``iter``, or 'val'). ``ray_blocks > 1`` takes the
    ray-blocked step (``make_blocked_train_step``); ``perceptual_fn`` and
    ``image_hw`` add the perceptual term (``train.loss.enerf_loss``).
    ``cas`` gives the loss settings where the model has none (MVSNeRF;
    ``make_train_step``). Runs on CUDA unless ``device`` says otherwise;
    returns the final state."""
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

    step_fn = (make_blocked_train_step(model, ray_blocks, perceptual_fn, image_hw)
               if ray_blocks > 1 else make_train_step(model, perceptual_fn, image_hw, cas))

    def record(kind, scalars, **where):
        recorder.update(scalars)
        recorder.record(kind)
        if on_record is not None:
            on_record(kind, state, {**where, **scalars})

    for epoch in range(begin_epoch, int(train_cfg["epoch"])):
        if hasattr(batches, "set_epoch"):
            batches.set_epoch(epoch)
        t_ep = time.time()
        for it, batch in enumerate(batches):
            if prepare is not None:
                batch = prepare(batch)
            stats = step_fn(state, {k: v for k, v in batch.items() if k != "meta"})
            recorder.step += 1
            if it % log_interval == 0:
                record("train", {k: float(v) for k, v in stats.items()}, epoch=epoch, iter=it)
                print(f"epoch {epoch} iter {it}/{ep_iter} {recorder}", flush=True)
        if (epoch + 1) % save_ep == 0 or (epoch + 1) % save_latest_ep == 0:
            mgr.save(state.state_dict(), epoch, latest=True)
        if validate is not None and eval_ep > 0 and (epoch + 1) % eval_ep == 0:
            try:
                ret = validate()
            except Exception as e:  # validation must not kill training
                print(f"validation failed: {e!r}", flush=True)
            else:
                record("val", {f"val_{k}": v for k, v in ret.items() if np.isscalar(v)},
                       epoch=epoch)
                print(f"epoch {epoch} validation {ret}", flush=True)
        print(f"epoch {epoch} done in {time.time() - t_ep:.1f}s", flush=True)
    recorder.close()
    return state


def boost_views_num(views_num, n_input: int):
    """The sampler's view counts raised to at least ``n_input``: a boost
    model's batch needs ``n_input`` views for one combination (ROADMAP
    fault 13), and a plain MVSNeRF builds its volume from exactly its
    ``n_views`` (fault 16: JAX's U-Net, built for 9 + 32 input channels,
    refuses a 2-view batch). The counts' probabilities, and so the random
    stream, stay."""
    return None if views_num is None else [max(int(n), n_input) for n in views_num]


def train_loader(cfg, train_ds) -> Loader:
    """The training ``Loader`` of JAX's ``run_train``: shuffled, ``ep_iter``
    batches an epoch, the view counts of ``train.sampler_meta`` (raised for
    boost models, ``boost_views_num``), per-batch image sizes under the
    ``image_size`` batch sampler."""
    train = cfg["train"]
    meta = train.get("sampler_meta", {})
    views_num = meta.get("input_views_num")
    if requires_view_selection(cfg):
        views_num = boost_views_num(views_num, int(cfg["enerf"].get("cost_volume_input_views", 3)))
    elif _network_name(cfg) == "mvsnerf":
        views_num = boost_views_num(views_num, MVSNeRFConfig.from_cfg(cfg).n_views)
    return Loader(
        train_ds,
        batch_size=int(train["batch_size"]),
        shuffle=True,
        ep_iter=int(cfg.get("ep_iter", -1)),
        input_views_num=views_num,
        input_views_prob=meta.get("input_views_prob"),
        num_workers=int(train.get("num_workers", 4)),
        image_size_meta=dict(meta) if train.get("batch_sampler") == "image_size" else None,
    )


def run_train(cfg, device=None, ray_blocks: int = 0, on_record=None) -> TrainState:
    """Train from a YAML config (JAX ``runner.run_train``, the root
    ``train.py``), in JAX's order: the network, the train split's
    ``Loader`` (shuffled, ``ep_iter`` steps an epoch, the view counts of
    ``train.sampler_meta``, per-batch image sizes under the
    ``image_size`` batch sampler), the optimizer; for boost models the
    view-selection pre-pass over the train and test splits when
    ``view_selection.json`` is missing (weights from ``_init_or_load``);
    resume from ``trained_model_dir`` or a warm start from
    ``<workspace>/trained_model/pretrain/<cfg.pretrain>``; the perceptual
    term when ``cfg.vgg_weights`` names converted VGG16 weights and a level
    trains on full images; then ``train_epochs`` with JAX's unblocked step
    (``ray_blocks`` > 1 takes the ray-blocked one, for batches whose
    unblocked step outgrows the card) and validation through
    ``run_evaluate`` every ``eval_ep`` epochs. ``cfg.debug_nans`` turns on
    autograd's anomaly detection (reference
    lib/networks/enerf/network.py:110-111). ``on_record`` as in
    ``train_epochs``. MVSNeRF models train unblocked on the recipes'
    random rays, with the loss settings of ``cfg.enerf.cas_config`` (JAX's
    step reads them from the model, which has none: ROADMAP fault 15).
    Runs on CUDA unless ``device`` says otherwise."""
    from boostmvsnerfs_torch.eval.vgg import load_vgg, perceptual_loss_fn

    name = _network_name(cfg)
    if "mvsnerf" in name and ray_blocks > 1:
        raise ValueError(f"ray_blocks {ray_blocks}: the ray-blocked step renders ENeRF cascade "
                         f"levels; {name} trains unblocked")
    device = resolve_device(device)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    model = make_network(cfg, device)
    train_ds = make_dataset(cfg, "train")
    loader = train_loader(cfg, train_ds)

    prepare = None
    if requires_view_selection(cfg):
        if not os.path.exists(view_selection_path(cfg)):
            _init_or_load(cfg, model)
            run_view_selection(cfg, model, [Loader(train_ds, 1),
                                            Loader(make_dataset(cfg, "test"), 1)])
        vs = load_view_selection(cfg)
        prepare = lambda b: attach_boost_inputs(b, vs, cfg)  # noqa: E731

    perceptual_fn, image_hw = None, None
    vgg_npz = cfg.get("vgg_weights", "")
    if vgg_npz and os.path.exists(vgg_npz) and any(cas.train_img[: cas.num]):
        perceptual_fn = perceptual_loss_fn(load_vgg(vgg_npz, device))
        H, W = train_ds.get_sample(0)["src_inps"].shape[1:3]
        image_hw = tuple((int(H * cas.render_scale[i]), int(W * cas.render_scale[i]))
                         for i in range(cas.num))
        print(f"perceptual loss enabled (VGG16 weights: {vgg_npz})", flush=True)

    pretrain_dir = (os.path.join(cfg["workspace"], "trained_model", "pretrain", cfg["pretrain"])
                    if cfg.get("pretrain") else None)
    with torch.autograd.set_detect_anomaly(bool(cfg.get("debug_nans", False))):
        return train_epochs(
            model, loader, cfg["train"], cfg["trained_model_dir"],
            record_dir=cfg.get("record_dir"),
            log_interval=int(cfg.get("log_interval", 20)),
            save_ep=int(cfg.get("save_ep", 1)),
            save_latest_ep=int(cfg.get("save_latest_ep", 1)),
            resume=bool(cfg.get("resume", True)),
            pretrain_dir=pretrain_dir,
            ray_blocks=ray_blocks,
            perceptual_fn=perceptual_fn,
            image_hw=image_hw,
            prepare=prepare,
            eval_ep=0 if cfg.get("skip_eval", False) else int(cfg.get("eval_ep", 0)),
            validate=lambda: run_evaluate(cfg, model=model, device=device),
            on_record=on_record,
            device=device,
            cas=cas,
        )
