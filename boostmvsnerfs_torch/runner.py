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

Under a process group (``parallel/mesh.init_distributed``, the entries'
``--distributed``) the ranks form a (data, rays) mesh of ``cfg.mesh.rays``
ray tiles: each ``data`` rank's loader takes its share of the batches or
views, rank 0 runs the view-selection pre-pass while the others wait,
trains with the distributed step and alone records, saves and validates;
the evaluation pools the ranks' views before its summary.

``make_forward`` gives the eval entry, the path entry and the viewer their
frame executor: ``StagedENeRF`` for the ENeRF family, ``StagedMVSNeRF``'s
row blocks for the MVSNeRF family (``parallel/staged.py``).

Not carried from the JAX runner: ``autotune_model``, ``make_mask_fn`` and the
``host_sync`` / ``frame_sync`` calls (TPU machinery).
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
from boostmvsnerfs_torch.models.variants import CompositeENeRF, HumanENeRF
from boostmvsnerfs_torch.parallel import mesh as mesh_lib
from boostmvsnerfs_torch.parallel.staged import StagedENeRF, StagedMVSNeRF
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
    renderer head from ``cfg.mvsnerf.net_type``; the layered composite its
    layers from ``cfg.composite`` (``num_fg_layers``, ``fg_hw``,
    ``bg_planes``) and ``cfg.enerf.white_bkgd``, with JAX's defaults."""
    name = _network_name(cfg)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    if name == "boost_enerf":
        return BoostENeRF(cas, device=device)
    if name == "enerf":
        return ENeRF(cas, device=device)
    if name in ("boost_mvsnerf", "mvsnerf"):
        cls = BoostMVSNeRF if name == "boost_mvsnerf" else MVSNeRF
        return cls(MVSNeRFConfig.from_cfg(cfg), device=device)
    if name == "enerf_composite":
        node = cfg.get("composite", {})
        return CompositeENeRF(
            cas, num_fg_layers=int(node.get("num_fg_layers", 1)),
            fg_hw=tuple(node.get("fg_hw", (64, 64))),
            bg_planes=tuple(node.get("bg_planes", (16, 4))),
            white_bkgd=bool(cfg["enerf"].get("white_bkgd", False)), device=device)
    if name == "enerf_human":
        return HumanENeRF(cas, device=device)
    raise ValueError(f"unknown network module: {cfg['network_module']}")


def make_forward(cfg, model: nn.Module):
    """The eval forward of ``model`` (JAX ``runner.make_forward``): with
    ``execution`` ``staged`` (the default), an ENeRF-family model's
    ``StagedENeRF`` (the model's forward, without a mesh) and an
    MVSNeRF-family model's ``StagedMVSNeRF`` (blocks of 32 raster rows);
    otherwise the model itself."""
    if cfg.get("execution", "staged") == "staged":
        if isinstance(model, ENeRF):
            return StagedENeRF(model)
        if isinstance(model, MVSNeRF):
            return StagedMVSNeRF(model)
    return model


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


def entry_mesh(cfg):
    """The world as the (data, rays) mesh of ``cfg.mesh.rays`` ray tiles
    (1 by default), or None without a process group."""
    if not mesh_lib.distributed():
        return None
    n_rays = int((cfg.get("mesh") or {}).get("rays", 1))
    return mesh_lib.make_mesh(n_data=mesh_lib.world_size() // n_rays, n_rays=n_rays)


def rank0_first(path: str, make, distributed: bool = True) -> None:
    """``make()`` writes ``path`` when it is missing: under a process group
    (``distributed``) on rank 0 while the other ranks wait, else here."""
    if (mesh_lib.rank() == 0 or not distributed) and not os.path.exists(path):
        make()
    if distributed:
        mesh_lib.barrier()


def run_evaluate(cfg, model: nn.Module | None = None, device=None,
                 distributed: bool | None = None) -> dict:
    """Evaluate on the config's test split: returns the evaluator's summary
    (``psnr``, ``ssim``, the LPIPS key, depth metrics when asked for), the
    frame rate over the frames after the first (``fps``) and every frame's
    time (``frame_ms``). Without ``model``, the network comes from
    ``make_network`` with ``_init_or_load``'s weights; a given model keeps
    its own weights. Runs on CUDA unless ``device`` says otherwise. A frame
    is timed as the JAX entry times it: the batch lands on the device
    first, then the forward runs to a device synchronisation. With
    ``cfg.profile_dir`` set, the frames run under ``utils/profiling.
    device_trace``, which writes their trace there.

    Under a process group (``distributed``, by default whether one is
    set up) the target views are split over the (data, rays) mesh's
    ``data`` ranks (JAX runner.py:250-255), each frame renders in
    ``cfg.mesh.rays`` ray tiles gathered over ``rays`` (JAX
    runner.py:291-316), and the ranks' per-view records are pooled before
    the summary, which every rank returns and rank 0 prints; frame times
    are each rank's own."""
    from boostmvsnerfs_torch.utils.profiling import device_trace

    device = resolve_device(device)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    if model is None:
        model = make_network(cfg, device)
        _init_or_load(cfg, model)
    model.to(device).eval()
    distributed = mesh_lib.distributed() if distributed is None else distributed
    mesh = entry_mesh(cfg) if distributed else None
    main = mesh_lib.rank() == 0 or not distributed
    n_data, i_data, _ = mesh_lib.axis(mesh, "data")
    n_rays, i_rays, _ = mesh_lib.axis(mesh, "rays")
    dataset = make_dataset(cfg, "test")
    batch_size = int(cfg["test"]["batch_size"])
    loader = Loader(dataset, batch_size=batch_size, num_processes=n_data, process_index=i_data)

    boost = requires_view_selection(cfg)
    vs = None
    if boost:
        rank0_first(view_selection_path(cfg),
                    lambda: run_view_selection(cfg, model, [Loader(dataset, batch_size)]),
                    distributed)
        vs = load_view_selection(cfg)

    fwd = make_forward(cfg, model)

    def forward(batch):
        if n_rays == 1:
            return fwd(batch)
        tile = mesh_lib.shard_batch(mesh, batch, ("rays",))
        return mesh_lib.gather_rays(mesh, model(tile), ("rays",))

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
    with device_trace(cfg.get("profile_dir")):
        for np_batch in loader:
            if boost:
                np_batch = attach_boost_inputs(np_batch, vs, cfg)
            batch = _device_batch(np_batch, device)
            sync()
            t0 = time.perf_counter()
            out = forward(batch)
            sync()
            net_times.append(time.perf_counter() - t0)
            if i_rays == 0:
                evaluator.evaluate(out, np_batch)
    if distributed:
        evaluator.merge()
    ret = evaluator.summarize(verbose=main)
    ret["frame_ms"] = [t * 1e3 for t in net_times]
    if len(net_times) > 1:
        fps = 1.0 / float(np.mean(net_times[1:]))
        if main:
            print(f"FPS: {fps:.3f}")
        ret["fps"] = fps
    return ret


# ---------------------------------------------------------------------------
# novel camera paths
# ---------------------------------------------------------------------------


def path_anchors(dataset) -> tuple[str, np.ndarray]:
    """The first scene of ``dataset`` (the test split) and the cameras of
    its test views (c2w, (N, 4, 4)), which camera paths pass through."""
    scene = next(iter(dataset.scene_infos))
    c2ws = np.asarray(dataset.scene_infos[scene]["c2ws"])
    return scene, c2ws[sorted({m[1] for m in dataset.metas if m[0] == scene})]


def pose_batch(cfg, dataset, scene: str, c2w: np.ndarray) -> dict:
    """The numpy batch of one camera ``c2w`` of ``scene``: its source views
    the ``test_input_views`` nearest the camera, its target image the
    nearest view's, its ``tar_ext`` the camera's. Rewrites
    ``dataset.metas`` (a crafted meta per pose)."""
    from boostmvsnerfs_torch.data.base import collate, nearest_src_views

    c2ws = np.asarray(dataset.scene_infos[scene]["c2ws"])
    n_views = int(cfg["enerf"]["test_input_views"])
    order = [int(i) for i in nearest_src_views(c2ws, c2w, n_views, exclude_self=False)]
    dataset.metas = [(scene, order[0], order)]
    sample = dataset.get_sample(0)
    sample["tar_ext"] = np.linalg.inv(c2w).astype(np.float32)
    return collate([sample])


def novel_path_batches(cfg, dataset, n_frames: int, path_type: str = "interpolate"):
    """The batches of a camera path (``render_novel_path``), numpy, one
    frame each (``pose_batch``), from ``dataset`` (the test split): cameras
    interpolated through, or spiralled around, the first scene's test
    views."""
    from boostmvsnerfs_torch.utils import camera_paths

    scene, anchors = path_anchors(dataset)
    if path_type == "spiral":
        path = camera_paths.spiral_path(anchors, n_frames)
    else:
        path = camera_paths.interpolate_path(anchors, n_frames)
    for c2w in path:
        yield pose_batch(cfg, dataset, scene, c2w)


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
    fwd = make_forward(cfg, model)
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
        out = fwd(batch)
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
    mesh=None,
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
    returns the final state.

    With a (data, rays) ``mesh`` (``parallel/mesh.make_mesh``) every rank
    runs this loop over its own share of the batches: the step is the
    distributed one on each batch's ``rays`` tile; the model starts as
    rank 0's (a resumed run checks that every rank read the same state),
    and every epoch ends with the check that the ranks still hold the same
    model; rank 0 alone records, prints, saves (``CheckpointManager``) and
    validates, and the other ranks wait for it. ``on_record`` sees every
    rank's records."""
    model.to(resolve_device(device))
    main = mesh_lib.rank() == 0
    ep_iter = len(batches)
    state = create_train_state(model, make_optimizer(train_cfg, ep_iter))
    mgr = CheckpointManager(model_dir)
    recorder = Recorder(record_dir)
    begin_epoch = 0
    restored = mgr.restore() if resume else None
    log = print if main else (lambda *a, **k: None)
    if restored is not None:
        state.load_state_dict(restored)
        begin_epoch = state.step // max(ep_iter, 1)
        log(f"resumed at epoch {begin_epoch}", flush=True)
    elif pretrain_dir and load_pretrain(pretrain_dir, model):
        log(f"warm start from {os.path.abspath(pretrain_dir)}", flush=True)
    if mesh is not None:
        (mesh_lib.assert_replicated if restored is not None else mesh_lib.broadcast_state)(model)

    step_fn = (make_blocked_train_step(model, ray_blocks, perceptual_fn, image_hw, mesh)
               if ray_blocks > 1 else make_train_step(model, perceptual_fn, image_hw, cas, mesh))

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
            batch = {k: v for k, v in batch.items() if k != "meta"}
            if mesh is not None:
                batch = mesh_lib.shard_batch(mesh, batch, ("rays",))
            stats = step_fn(state, batch)
            recorder.step += 1
            if it % log_interval == 0:
                record("train", {k: float(v) for k, v in stats.items()}, epoch=epoch, iter=it)
                log(f"epoch {epoch} iter {it}/{ep_iter} {recorder}", flush=True)
        if mesh is not None:  # what rank 0 saves, every rank holds
            mesh_lib.assert_replicated(model)
        if (epoch + 1) % save_ep == 0 or (epoch + 1) % save_latest_ep == 0:
            mgr.save(state.state_dict(), epoch, latest=True)
        if validate is not None and eval_ep > 0 and (epoch + 1) % eval_ep == 0 and main:
            try:
                ret = validate()
            except Exception as e:  # validation must not kill training
                print(f"validation failed: {e!r}", flush=True)
            else:
                record("val", {f"val_{k}": v for k, v in ret.items() if np.isscalar(v)},
                       epoch=epoch)
                print(f"epoch {epoch} validation {ret}", flush=True)
        mesh_lib.barrier()
        log(f"epoch {epoch} done in {time.time() - t_ep:.1f}s", flush=True)
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


def train_loader(cfg, train_ds, num_processes: int = 1, process_index: int = 0) -> Loader:
    """The training ``Loader`` of JAX's ``run_train``: shuffled, ``ep_iter``
    batches an epoch, the view counts of ``train.sampler_meta`` (raised for
    boost models, ``boost_views_num``), per-batch image sizes under the
    ``image_size`` batch sampler; the share of process ``process_index``
    of ``num_processes`` (each takes ``train.batch_size`` a batch, the
    reference's per-GPU batch)."""
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
        num_processes=num_processes,
        process_index=process_index,
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
    Runs on CUDA unless ``device`` says otherwise. Under a process group
    the ranks train together on the (data, rays) mesh of ``cfg.mesh.rays``
    (``train_epochs``): each ``data`` rank's loader takes its share of the
    batches, rank 0 runs the pre-pass while the others wait, and every rank
    resumes or warm-starts from the same files. Unlike JAX's multi-process
    ``run_train``, which steps each process on its own batch without
    reducing the gradients (ROADMAP fault 22), the ranks average them."""
    from boostmvsnerfs_torch.eval.vgg import load_vgg, perceptual_loss_fn

    name = _network_name(cfg)
    if "mvsnerf" in name and ray_blocks > 1:
        raise ValueError(f"ray_blocks {ray_blocks}: the ray-blocked step renders ENeRF cascade "
                         f"levels; {name} trains unblocked")
    device = resolve_device(device)
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    model = make_network(cfg, device)
    train_ds = make_dataset(cfg, "train")
    mesh = entry_mesh(cfg)
    n_data, i_data, _ = mesh_lib.axis(mesh, "data")
    loader = train_loader(cfg, train_ds, n_data, i_data)

    prepare = None
    if requires_view_selection(cfg):
        def prepass():
            _init_or_load(cfg, model)
            run_view_selection(cfg, model, [Loader(train_ds, 1),
                                            Loader(make_dataset(cfg, "test"), 1)])

        rank0_first(view_selection_path(cfg), prepass)
        vs = load_view_selection(cfg)
        prepare = lambda b: attach_boost_inputs(b, vs, cfg)  # noqa: E731

    perceptual_fn, image_hw = None, None
    vgg_npz = cfg.get("vgg_weights", "")
    if vgg_npz and os.path.exists(vgg_npz) and any(cas.train_img[: cas.num]):
        perceptual_fn = perceptual_loss_fn(load_vgg(vgg_npz, device))
        H, W = train_ds.get_sample(0)["src_inps"].shape[1:3]
        image_hw = tuple((int(H * cas.render_scale[i]), int(W * cas.render_scale[i]))
                         for i in range(cas.num))
        if mesh_lib.rank() == 0:
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
            validate=lambda: run_evaluate(cfg, model=model, device=device, distributed=False),
            on_record=on_record,
            device=device,
            cas=cas,
            mesh=mesh,
        )
