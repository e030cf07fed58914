"""Smoke run of the PyTorch/CUDA port (boostmvsnerfs_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ and prints one JSON line per
phase. Three main paths are driven, each with its kernels checked first:

1. device  - the card, from torch and nvidia-smi.
2. build   - nvcc of every kernel (all sources in parallel) and
   its register report.
3. kernels - each kernel against its plain PyTorch version on its main
   path's real inputs at full width (taken from the model's own stages):
   max abs error, median time of one call, the plain version's time, the
   time of one PyTorch call computing the same function where one exists,
   the device time of the kernel and of that call (torch.profiler: the
   event time also counts the host's share of a call), and the bound
   (bytes over 3.35 TB/s, or bf16 tensor-core operations over 989 TFLOP/s
   plus f32 operations over 67 TFLOP/s, the H100 SXM's published peaks,
   whichever is larger: ``boostmvsnerfs_torch/utils/roofline.py``, whose
   work functions count what the inputs need, and print the data's share:
   the warps' live taps, the samplers' touched pixels and voxels). The
   bf16 kernels (the eval warp, the volume sampler, renderer MLP, ENeRF
   head) are held against their plain versions at bf16, and their error against the f32 plain version must
   be bf16 rounding and nothing else; the volume sampler's f32 instance
   is held against the f32 plain version. The head is also checked at 2, 4 and 8 views (HEAD_VIEWS).
4. frame   - a reduced-geometry BoostENeRF frame on the card against the
   port on the CPU (plain versions): rgb PSNR must exceed 45 dB.
5. main    - the first main path, bench.py's workload: BoostENeRF K=4 of
   C(6,3), 480x736, planes (64, 8), only level 1 rendered, seeded random
   weights, f32 with TF32 off. Three batches checked, launches per frame
   counted, then frame times over back-to-back frames, and the frame's
   bound and MFU (``utils/roofline.py``; main_mvsnerf too).
6. profile - where a main-path frame's device time goes (torch.profiler):
   device-busy share, cuDNN convolutions, the ported kernels, top kernels.
7. kernels, frame_mvsnerf, main_mvsnerf, profile_mvsnerf - the same for
   the second main path, scripts/bench_mvsnerf.py's workload: BoostMVSNeRF
   K=4 of C(6,3) (combinations 0, 5, 9, 14), 224x352, 32 samples per ray,
   the published widths (pad 24, 8-ch volume, MLP 6x128), every pixel.
8. evaluate, evaluate_mvsnerf - the eval entry from YAML, as a user runs
   it (``boostmvsnerfs_torch.runner.run_evaluate``, what ``python -m
   boostmvsnerfs_torch.run --type evaluate`` calls), on scenes written to
   a temporary workspace with seeded random weights saved as the port's
   ``latest.pt``. BoostENeRF from
   configs/exps/evaluate/enerf_ours/free_eval.yaml on a Free scene of 16
   images at 480x736 (test views 0 and 8, 6 source views, K=4 of 20; the
   fixture LPIPS on), BoostMVSNeRF from
   configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml on a ScanNet
   scene of 16 images at 224x352; each camera of both scenes turned its
   own way, so that every combination of views covers a target
   differently. The view-selection pre-pass, every test frame and the
   metrics; launches of the whole run against the design's count; each
   kernel against its plain version on the entry's first test batch; the
   pre-pass per target view (and its launches, per chunk of K
   combinations), LPIPS per image and the peak memory; then the same
   scene at 128x192 on the card against the CPU port: coverage masks
   within limits that a fault planted in the CPU port must fail, picks
   equal on at least the first two greedy steps of every view, rendered
   rgb over 45 dB and the psnr within 0.05 dB. The MVSNeRF frames go through
   ``runner.make_forward``'s ``StagedMVSNeRF``: 7 row blocks of 32 rows at
   224x352, each launching #6, #3 and #8 once. Then staged_mvsnerf: the
   MVSNeRF family's Free recipe
   (configs/exps/evaluate/mvsnerf_ours/free_eval.yaml, BoostMVSNeRF v0,
   K=4 of 20, 32 samples) at 480x736 on a Free scene of 16 images, in 15
   row blocks: the eval entry (launches against the design, psnr, frame
   times, peak memory); under deterministic cuDNN the frame through
   ``StagedMVSNeRF`` against the model whole (equal; frame time and peak
   memory of each); #6, #3 and #8 at one block's shapes; the frame's bound
   and MFU; the v1 head's staged frame against its monolithic frame at
   224x352, and its staged frame at 480x736 with its peak memory (the
   monolithic one would outgrow the card).
9. visualize, path - the novel-view entries over
   configs/exps/evaluate/enerf_ours/free_eval.yaml on the same Free scene
   with seeded weights as ``latest.pt``: ``python -m boostmvsnerfs_torch.run
   --type visualize`` (the pre-pass, every test view, the videos written
   through the first writer that works), then
   ``runner.render_novel_path`` (3 interpolated frames and 1 spiral one):
   per frame the greedy selection's time, the frame's and the picks,
   launches per frame against the design (the pre-pass's 5 chunks, then
   the frame), the peak memory and the files; the kernels on the first
   frame's inputs; the middle frame at 128x192 on the card against the CPU port
   (masks within the limits, a planted fault outside them, picks, rgb over
   45 dB). Then, on the same scene and weights, convert and gui: the
   weights written in the paper's ``.pth`` layout (and a v1 MVSNeRF one with
   tied ``pts_linears``), converted by ``python -m
   boostmvsnerfs_torch.convert_ckpt``, the converted ``latest.pt`` through
   ``run_evaluate`` (the psnr equal to the direct file's to the last bit);
   the browser viewer (``interactive.server``) built from the converted
   weights, served on 127.0.0.1 in a thread and driven over HTTP (the page,
   ``/meta``, seven events: a JPEG of the frame's size each; level 0 of the
   level-1 config answers 500): per served frame the batch, selection,
   forward and encode times, the peak memory and the launches against a
   path frame's design; the kernels on the first served frame's inputs;
   reruns of that frame under cuDNN's default and deterministic algorithms;
   ``render_fn`` against ``render_novel_path``'s frames; the middle pose at
   128x192 on the card against the CPU port.
10. train_entry - the training entry from YAML (``runner.run_train``, what
   ``python -m boostmvsnerfs_torch.train`` calls) over
   configs/exps/finetune/enerf_ours/free/base.yaml with seeded weights as
   the ``pretrain: enerf`` checkpoint, shortened only (one epoch of 2
   steps, a log line, a checkpoint and a validation per epoch): batches
   of 4 at 480x736, BoostENeRF K=4, both levels on full images, lr 5e-5,
   in TRAIN_ENTRY_RAY_BLOCKS ray blocks (the unblocked step of 4 images
   does not fit the card). The pre-pass over the train and test views,
   the steps (times, launches per step against the design, stats), the
   validation record, the checkpoint; then the run resumed with
   ``train.epoch 2``: it begins at epoch 1 and takes 2 more steps. The
   kernels on the first batch; one validation frame with the
   convolutions at bf16 (``conv_dtype``) against float32; ``run_train``
   at 128x192 for 2 steps on the card against the CPU port (the first
   step's loss and the parameters' change, with a skipped Adam step as
   the control).
11. mvsnerf_heads - BoostMVSNeRF at the second main path's workload with
   each of its other renderer heads (net_type v1, v2, color_fusion, whose
   MLPs run plainly on every device): the volume and colour lookups
   against their plain versions, then per head the reduced frame on the
   card against the CPU port (rgb PSNR over 45 dB), launches per frame
   (#6 and #3 once, the MLP kernel never), frame times and peak memory.
12. train_entry_mvsnerf, train_step_check_mvsnerf, profile_train_mvsnerf -
   MVSNeRF training from YAML: ``runner.run_train`` over
   configs/exps/finetune/mvsnerf_ours/free/base.yaml (BoostMVSNeRF, batch
   4 of 1024 random rays at 480x736, K=4, 8 samples, lr 5e-5) with seeded
   weights as the ``pretrain: mvsnerf`` checkpoint, shortened only as in
   item 10 and unblocked, then resumed; launches per step (the colour
   lookup only: the volume lookup and the MLP run plainly under autograd)
   and per validation frame (#6, #3, #8 per row block: 15 at 480x736, 16 at
   512x512), the pre-pass (geometry, no
   launches), the kernels on the step's and the validation's inputs; the
   plain MVSNeRF recipe (configs/exps/finetune/mvsnerf/free/base.yaml,
   512x512) for 2 steps and a validation. One BoostMVSNeRF step at 128x192
   on the card against the float64 CPU port, with faults planted in the
   CPU port outside the bars, and ``run_train`` at 128x192 card vs CPU.
   One profiled step of the recipe, and its plain volume lookup and MLP
   alone, forward and backward.
13. kernels_train, train_step_check, train, profile_train - the third main
   path, the BoostENeRF fine-tuning step of scripts/bench_train.py
   (--modes fast --ray-blocks 16): K=4 of C(6,3), 480x736, forward rig,
   both levels rendered on full images, Adam (lr 5e-5, ep_iter 500) after
   the clip at 40, the ray-blocked step with 16 blocks. The f32 warp, the
   sampler and the backward kernels against their plain versions on the
   step's own inputs; one plain and one blocked step at 128x192 on the
   card against the CPU port, with faults planted in the CPU port to show
   the bars catch them; launches per step, step times over three batches;
   one profiled step.
14. kernels (path composite), composite, profile_composite,
   composite_train, human - the ENeRF variants. ``CompositeENeRF`` from
   YAML (configs/exps/evaluate/enerf/base_eval.yaml, the eval cascade:
   planes (64, 8), samples (8, 2), level 1 rendered; ``network_module``
   enerf_composite, 2 foreground layers of 224x320 at origins (96, 64) and
   (384, 192), background planes (16, 4)) at 480x736, 3 views: #1, #3 and
   the head's image-feature-only instance (C = 11 and 35) on the first
   layer's crop against their plain versions; the reduced frame (128x192,
   64x64 crops) on the card against the CPU port (rgb over 45 dB); launches
   per frame (#1 6, #3 3, #5 3, 2 of them without voxel features), frame
   times, peak memory; one profiled frame. One train step of the 2-layer
   composite at 128x192 on the card against the float64 CPU port (the
   BoostENeRF gradient bars, float32's spread and two planted faults on
   both sides). ``HumanENeRF`` through the eval entry
   (configs/exps/evaluate/enerf/free_eval.yaml) and the training entry
   (configs/exps/finetune/enerf/free/base.yaml, shortened as item 10, on
   random rays drawn on the mask with two 32x32 patches at level 1) on
   the Free scene: launches against the design, steps, peak memory;
   ``run_train`` at 128x192 on the card against the CPU port.
15. distributed_train, distributed_eval - multi-GPU through
   torch.distributed: ranks launched by ``python -m torch.distributed.run``
   (each launch killed, with its ranks, past DIST_TIMEOUT_S), on a Free scene
   of 16 images at 480x736. distributed_train: the fine-tuning recipe of item
   10 (two steps a launch) through the training entry's ``main`` with
   ``--distributed`` and the step recorded (``rank_worker``), under
   deterministic cuDNN: (a) a world of 1 over NCCL, its first step against
   the one-process step on the same batch of 4 (loss, gradients, running
   statistics, parameters: the fault-6 bars); (b) a world of 2 over gloo on
   the one card, 2 + 2 images, its first step against the one-process step
   on both ranks' batches together (the gradients within 3 times float32's
   spread, measured on the same batch moved by one ulp; the gradients summed
   instead of averaged must fail), both ranks' states equal after every
   step, rank 0 alone saving and validating, then ``python -m
   boostmvsnerfs_torch.train --distributed`` resuming the run; the step
   times, the collectives' time and a profiled step, peak memory per rank.
   distributed_eval: the BoostENeRF frame of item 5 through
   ``parallel/staged.StagedENeRF`` on (cv=2, rays=1), 2 gloo ranks, under
   deterministic cuDNN, within DIST_FRAME_TOL of the unsharded frame (its
   target moved off the source cameras); then ``python -m
   boostmvsnerfs_torch.run --type evaluate --distributed`` with 2 gloo
   ranks on the eval scene of item 8: rank 0's summary covers both test
   views and equals one process's. The kernels at a rank's shapes.
Then the per-kernel summary line, the card's name and power limit as
nvidia-smi prints them, and a last status line. Any failed check raises,
and the script exits non-zero; it also exits non-zero, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T_IMPORT = time.perf_counter()  # the script's clock starts before torch loads

import numpy as np
import torch

from boostmvsnerfs_torch.utils.roofline import (
    bound,
    head_work,
    live_tap_share,
    mlp_work,
    sample_bwd_work,
    sample_work,
    touched_pixels,
    touched_voxels,
    tri_work,
    warp_bwd_work,
    warp_work,
)

# Kernel vs plain version: both f32; the kernels sum in another order, so
# the largest error allowed is 1e-4 of the output's largest magnitude (at
# least 1).
KERNEL_RTOL = 1e-4
# bf16 kernel vs the plain version at bf16: the products are exact in f32
# on both sides, but the sums run in another order, and where two sums
# straddle a bf16 rounding boundary the next layer's operand moves by one
# bf16 ulp (2^-8 relative) and carries through the remaining layers. So
# the largest error allowed is 1e-2 of the output's largest magnitude (at
# least 1). Against the f32 plain version the kernel's mean error may be
# at most BF16_MEAN_RATIO times the bf16 plain version's own: its error is
# bf16 rounding and nothing else.
KERNEL_BF16_RTOL = 1e-2
BF16_MEAN_RATIO = 1.5
MAIN_RAYS = 480 * 736
MVS_HW = (224, 352)
MVS_K_BEST = (0, 5, 9, 14)
# an MVSNeRF frame's launches: one of each of its kernels per row block
# (``StagedMVSNeRF``, behind ``runner.make_forward``) or per frame (the
# model whole)
MVS_FRAME = {"tri_sample": 1, "img_sample": 1, "renderer_mlp": 1}
MVS_ROW_CHUNK = 32  # StagedMVSNeRF's raster rows a block (JAX's row_chunk)
# view counts of the head kernel checked beside the main path's 3
HEAD_VIEWS = (2, 4, 8)
NO_LAUNCHES = {"warp_variance": 0, "img_sample": 0, "enerf_head": 0, "tri_sample": 0,
               "renderer_mlp": 0, "warp_variance_bwd": 0, "img_sample_bwd": 0}
FREE_EVAL = "configs/exps/evaluate/enerf_ours/free_eval.yaml"
SCANNET_EVAL = "configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml"
EVAL_IMAGES = 16  # a Free scene's test views are every 8th: 0 and 8
SCANNET_TEST_IDS = (3, 11)
EVAL_CHECK_HW = (128, 192)  # the card-vs-CPU check of the eval entry
EVAL_PSNR_TOL_DB = 0.05
# The card's coverage masks against the CPU port's (``compare_masks``), per
# combination and relative to the masks' largest value: the mean absolute
# difference, and the share of pixels that differ by more than 1e-3. On the
# H100 at 128x192 the card read at most 7.3e-6 and 4.1e-5 on both eval
# scenes, and the controls (the CPU port with a fault of MASK_FAULTS
# planted) at least 1.4e-3 and 7.0e-3 (PERF.md, section 6): the limits lie
# between, near the geometric means, and every run checks both sides.
MASK_MEAN_DIFF_TOL = 1e-4
MASK_PIXEL_SHARE_TOL = 5e-4
# greedy steps that the card-vs-CPU check must compare on every target view
EVAL_STEPS_COMPARED = 2
TRAIN_HW = (480, 736)
TRAIN_RAYS = 120 * 184 + 480 * 736  # both levels' full images
TRAIN_CFG = {"lr": 5e-5, "optim": "adam", "eps": 1e-8}
TRAIN_EP_ITER = 500
RAY_BLOCKS = 16


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class LostRecords(AssertionError):
    """torch.profiler kept no device record of a kernel launched in a
    ``complete_profile`` block (ROADMAP fault 12)."""


@contextlib.contextmanager
def complete_profile():
    """torch.profiler over the block, after the primer of
    ``boostmvsnerfs_torch.utils.profiling.primed_profile`` (spin kernels and
    idle time before the block: torch.profiler on the H100 machines drops a
    profile's first device records, ROADMAP fault 12); raises
    ``LostRecords`` when a kernel launched in the block has no device
    record."""
    from boostmvsnerfs_torch.utils.profiling import primed_profile

    with primed_profile(cuda=True) as prof:
        yield prof
    lost = lost_launches(prof)
    if lost:
        raise LostRecords(f"torch.profiler lost the device records of {lost} kernel launches")


# A profile that lost a record (fault 12: late in a long run the primer
# does not always keep them) is taken again, up to this many profiles in
# all: every time reported still comes from a profile that kept them all.
PROFILE_TRIES = 3


def profiled(block) -> tuple:
    """``block()`` under ``complete_profile``, taken again when torch.profiler
    loses a record of it (each loss noted in a ``profile_retaken`` line; up
    to PROFILE_TRIES profiles): (the complete profile, the last run's
    value)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            with complete_profile() as prof:
                value = block()
            return prof, value
        except LostRecords as e:
            emit(phase="profile_retaken", attempt=attempt, reason=str(e))
            if attempt == PROFILE_TRIES:
                raise


def __getattr__(name: str):
    """``PRIMER_KERNELS``, the primer's launch count, from the package
    (scripts/torch_profile_probe.py reads it here)."""
    if name == "PRIMER_KERNELS":
        from boostmvsnerfs_torch.utils.profiling import PRIMER_KERNELS

        return PRIMER_KERNELS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def lost_launches(prof) -> int:
    """Kernel launches of a ``complete_profile`` block (those after the
    primer's) whose kernel has no device record: launches and kernels pair
    by their correlation ids."""
    from boostmvsnerfs_torch.utils.profiling import PRIMER_KERNELS

    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = sorted(e.correlation_id() for e in events
                      if e.device_type() == torch.autograd.DeviceType.CPU
                      and e.name().startswith(("cudaLaunch", "cuLaunch")))
    return sum(c not in recorded for c in launches[PRIMER_KERNELS:])


def block_kernels(prof) -> list:
    """The kernels of a ``complete_profile``'s block (the primer's spin
    kernels left out), from ``key_averages``."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]


def device_ms(fn, iters: int = 5) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches (``complete_profile``), without the host's share of the call,
    which ``median_ms`` counts and which rivals a small grid's kernel time."""
    fn()
    prof, _ = profiled(lambda: [fn() for _ in range(iters)])
    return sum(e.device_time_total for e in block_kernels(prof)) / iters / 1e3


def timings(run, library=None) -> dict:
    """Times of a kernel's wrapper ``run`` and of its library yardstick (a
    zero-argument call, or None): one call's event time (median of 20, and
    of 10 for the library) and its device time (``device_ms``)."""
    out = {"ms": median_ms(run, 20), "device_ms": device_ms(run),
           "library_ms": None, "library_device_ms": None}
    if library is not None:
        out["library_ms"], out["library_device_ms"] = median_ms(library, 10), device_ms(library)
    return out


SHARE_NAMES = {"ms": "roofline_share", "device_ms": "device_roofline_share",
               "library_ms": "library_roofline_share",
               "library_device_ms": "library_device_roofline_share"}


def shares(bms: float, t: dict) -> dict:
    """The bound's share of each time in ``t`` (``timings``)."""
    return {SHARE_NAMES[k]: None if v is None else bms / v for k, v in t.items()}


def data_shares(name: str, args) -> dict:
    """The data-dependent parts of a kernel's work on ``args``
    (``utils/roofline.py``): the warps' share of live taps, the samplers'
    touched map pixels and voxels."""
    if name.startswith("warp_variance"):
        return {"live_tap_share": live_tap_share(*args[:3])}
    if name == "tri_sample":
        return {"touched_voxels": touched_voxels(*args[:2])}
    if name.startswith("img_sample"):
        mode = args[3] if len(args) > 3 and isinstance(args[3], str) else "border"
        return {"touched_pixels": touched_pixels(*args[:3], mode)}
    return {}


def random_weights(model, seed: int) -> dict:
    from boostmvsnerfs_torch.utils.port_weights import random_state_dict

    return {k: torch.from_numpy(v) for k, v in random_state_dict(model, seed).items()}


def main_path_kernel_inputs(model, batch) -> dict:
    """Each kernel's inputs on the main path, from the model's own stages:
    {name: [(label, args), ...]}."""
    from boostmvsnerfs_torch.ops.cuda.img_sample import fused_row_sample

    feats, sub = model.fold_combinations(batch)
    stage = (sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"], sub["near_far"])
    warp, prev = [], None
    for level in range(model.cas.num):
        dv, _, pm = model.volume_inputs(level, feats, *stage, prev)
        warp.append((f"level{level}", (feats[f"level_{level}"], pm, dv)))
        feat_vol, *prev = model.build_level_volume(level, feats, *stage, prev)
    depth, std, nf_map = prev
    H, W = sub["src_inps"].shape[2:4]
    bounds_map, maps = model.level_maps(1, feats, depth, std, nf_map, sub["src_inps"])
    world_xyz, uvd, _ = model.sample_rays(1, bounds_map, sub, sub["ray_idx_1"])
    BK = world_xyz.shape[0]
    vox = model.voxel_features(feat_vol, uvd, H, W)
    S, C = maps.shape[1], maps.shape[-1]
    pts = world_xyz.reshape(BK, -1, 3)
    x, y = model.project_to_views(pts, sub, 1.0)
    sample_args = (maps.reshape(BK * S, H, W, C), x.reshape(BK * S, -1), y.reshape(BK * S, -1))
    feat = fused_row_sample(*sample_args).reshape(BK, S, -1, C)
    dirs = model.ray_diff_dirs(pts, sub)
    head = (model.nerf_1.head_params(), vox, feat, dirs)
    return {
        "warp_variance": warp,
        "img_sample": [("level1", sample_args)],
        "enerf_head": [("level1", head)],
        **{f"enerf_head/S{n}": [("level1", head_views(*head, n))] for n in HEAD_VIEWS},
    }


def head_views(params, vox, feat, dirs, n: int):
    """The head's inputs with ``n`` views: the path's views, cycled."""
    views = [i % feat.shape[1] for i in range(n)]
    return params, vox, feat[:, views].contiguous(), dirs[:, views].contiguous()


def mvs_stages(model, batch, ray_idx=None):
    """A BoostMVSNeRF's render up to its head (``render_stages``) on the
    rays ``ray_idx`` (B, R) of ``batch`` (all of its ``ray_idx_0`` by
    default), each repeated for the K volumes, as ``render_rays`` does."""
    sub, volume, near, far = model.frame_volume(batch)
    ids = batch["ray_idx_0"] if ray_idx is None else ray_idx
    return model.render_stages(sub, volume, ids.repeat_interleave(model.cfg.k_best, 0), near, far)


def mvs_kernel_inputs(model, batch, ray_idx=None) -> dict:
    """Each kernel's inputs on the MVSNeRF main path, from the model's own
    stages (``mvs_stages``, on the rays ``ray_idx``): {entry: [(label,
    args), ...]}. The MLP's encoded instance takes the raw-coordinate
    instance's samples, encoded by the port's positional_encoding."""
    from boostmvsnerfs_torch.ops.cuda.renderer_mlp import positional_encoding

    from boostmvsnerfs_torch.models.mvsnerf import KERNEL_HEADS

    calls, (uvd, feat, dirs), _, _ = mvs_stages(model, batch, ray_idx)
    lookups = {
        "tri_sample": [("render", calls["tri_sample"])],
        "tri_sample/f32": [("render", (*calls["tri_sample"], torch.float32))],
        "img_sample": [("render", calls["img_sample"])],
    }
    if model.cfg.net_type not in KERNEL_HEADS:  # the head's MLP runs plainly
        return lookups
    params, freqs = model.nerf.nerf.mlp_params(), model.cfg.pos_freqs
    calls["renderer_mlp"] = (params, uvd, feat, dirs, freqs)
    return {
        **lookups,
        "renderer_mlp": [("render", calls["renderer_mlp"])],
        "renderer_mlp/encoded": [("render", (params, positional_encoding(uvd, freqs), feat,
                                             dirs, 0))],
        "renderer_mlp/f32": [("render", (*calls["renderer_mlp"], torch.float32))],
    }


# Library yardsticks: each returns one PyTorch call computing the same
# function on the same work, for scale; the port never calls them.
def grid_sample_library(imgs, x, y):
    """``F.grid_sample`` (bilinear, border, align-corners, NCHW)."""
    import torch.nn.functional as F

    V, H, W, C = imgs.shape
    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], -1)[:, None]  # (V, 1, P, 2)
    return lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)


def grid_sample_3d_library(vol, xyz):
    """5-D ``F.grid_sample`` (trilinear, zeros, align-corners, NCDHW)."""
    import torch.nn.functional as F

    B, D, H, W, C = vol.shape
    ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    scale = torch.tensor([W - 1, H - 1, D - 1], dtype=torch.float32, device=xyz.device)
    grid = (xyz / scale * 2 - 1)[:, None, None]  # (B, 1, 1, P, 3)
    return lambda: F.grid_sample(ncdhw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


# entry -> (kernel name, instance or None, its Pallas kernel, work, library
# yardstick or None, the kernel's compute dtype)
F32, BF16 = torch.float32, torch.bfloat16
ENERF_KERNELS = {
    "warp_variance": ("warp_variance", "bf16 features (eval, warp_dtype bfloat16)",
                      "boostmvsnerfs_tpu/ops/pallas/warp_variance.py:38", warp_work, None, BF16),
    "img_sample": ("img_sample", None, "boostmvsnerfs_tpu/ops/pallas/img_sample.py:106",
                   sample_work, grid_sample_library, F32),
    "enerf_head": ("enerf_head", None, "boostmvsnerfs_tpu/ops/pallas/enerf_head.py:45",
                   head_work, None, BF16),
    **{f"enerf_head/S{n}": ("enerf_head", f"{n} views (the path's 3, cycled)",
                            "boostmvsnerfs_tpu/ops/pallas/enerf_head.py:45", head_work, None,
                            BF16) for n in HEAD_VIEWS},
}
MVS_KERNELS = {
    "tri_sample": ("tri_sample", None, "boostmvsnerfs_tpu/ops/pallas/tri_sample.py:37",
                   tri_work, grid_sample_3d_library, BF16),
    "tri_sample/f32": ("tri_sample", "compute_dtype float32",
                       "boostmvsnerfs_tpu/ops/pallas/tri_sample.py:37", tri_work,
                       grid_sample_3d_library, F32),
    "img_sample": ("img_sample", None, "boostmvsnerfs_tpu/ops/pallas/img_sample.py:106",
                   sample_work, grid_sample_library, F32),
    "renderer_mlp": ("renderer_mlp", "raw coordinates, encoded in the kernel",
                     "boostmvsnerfs_tpu/ops/pallas/mlp.py:169", mlp_work, None, BF16),
    "renderer_mlp/encoded": ("renderer_mlp", "encoded input",
                             "boostmvsnerfs_tpu/ops/pallas/mlp.py:37", mlp_work, None, BF16),
    "renderer_mlp/f32": ("renderer_mlp", "raw coordinates, compute_dtype float32",
                         "boostmvsnerfs_tpu/ops/pallas/mlp.py:169", mlp_work, None, F32),
}


def kernel_pair(name):
    """(wrapper, plain version) of a kernel."""
    from boostmvsnerfs_torch.ops.cuda import (
        enerf_head,
        img_sample,
        renderer_mlp,
        tri_sample,
        warp_variance,
    )

    return {
        "warp_variance": (warp_variance.fused_warp_variance, warp_variance.warp_variance_plain),
        "warp_variance_bwd": (warp_variance.warp_variance_bwd,
                              warp_variance.warp_variance_bwd_plain),
        "img_sample": (img_sample.fused_row_sample, img_sample.row_sample_plain),
        "img_sample_bwd": (img_sample.row_sample_bwd, img_sample.row_sample_bwd_plain),
        "enerf_head": (enerf_head.fused_nerf_head, enerf_head.nerf_head_plain),
        "tri_sample": (tri_sample.fused_tri_sample, tri_sample.tri_sample_plain),
        "renderer_mlp": (renderer_mlp.fused_renderer_mlp, renderer_mlp.renderer_mlp_plain),
    }[name]


def bf16_errors(got, want, want_f32) -> dict:
    """A bf16 kernel's output ``got`` against the plain version at bf16
    (``want``) and at f32: the mean errors that show the kernel's error is
    bf16 rounding (the kernel's against f32, at most BF16_MEAN_RATIO times
    the bf16 plain version's own)."""
    return {"max_abs_err_vs_f32": float((got - want_f32).abs().max()),
            "mean_abs_err_vs_f32": float((got - want_f32).abs().mean()),
            "plain_bf16_mean_abs_err_vs_f32": float((want - want_f32).abs().mean())}


def phase_kernels(table: dict, inputs: dict, path: str) -> dict:
    """Every kernel of ``table`` against its plain version at the kernel's
    compute dtype on ``inputs`` (a bf16 kernel also against the f32 plain
    version); returns the summary record of each entry."""
    summary = {}
    for entry, (name, instance, replaces, work, library, dtype) in table.items():
        kernel, plain = kernel_pair(name)
        bf16 = dtype == BF16
        plain_at = functools.partial(plain, compute_dtype=BF16) if bf16 else plain
        rtol = KERNEL_BF16_RTOL if bf16 else KERNEL_RTOL
        rec = {"name": name, "route": "cuda", "source": f"boostmvsnerfs_torch/csrc/{name}.cu",
               "replaces": replaces, "path": path, "compute_dtype": str(dtype).split(".")[-1],
               "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": None}
        if instance:
            rec["instance"] = instance
        totals = [0.0, 0.0, 0.0]  # bytes, f32 operations, tensor-core operations
        for label, args in inputs[entry]:
            got, want = kernel(*args), plain_at(*args)
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            vs_f32 = bf16_errors(got, want, plain(*args)) if bf16 else {}
            del got, want
            tensors = [a for a in args if torch.is_tensor(a)]
            t = timings(lambda: kernel(*args), library(*tensors) if library else None)
            plain_ms = median_ms(lambda: plain_at(*args), 3, warmup=1)
            counts = (*work(*args), 0.0)[:3]
            bms, by = bound(*counts)
            emit(phase="kernels", path=path, kernel=name, instance=instance, at=label,
                 compute_dtype=rec["compute_dtype"], shapes=[list(a.shape) for a in tensors],
                 max_abs_err=err, tolerance=rtol * scale, **vs_f32, **t, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, bytes=counts[0], ops=counts[1], tc_ops=counts[2],
                 **data_shares(name, args), **shares(bms, t))
            require(err <= rtol * scale, f"{name} at {label}: max abs error {err} vs plain")
            if bf16:
                require(vs_f32["mean_abs_err_vs_f32"]
                        <= BF16_MEAN_RATIO * vs_f32["plain_bf16_mean_abs_err_vs_f32"],
                        f"{name} at {label}: mean error vs f32 {vs_f32}")
                rec.update(vs_f32)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["ms"] += t["ms"]
            rec["device_ms"] += t["device_ms"]
            rec["plain_ms"] += plain_ms
            if t["library_ms"] is not None:
                rec["library_ms"] = t["library_ms"]
            totals = [a + b for a, b in zip(totals, counts)]
        rec["bound_ms"], rec["bound_by"] = bound(*totals)
        summary[entry] = rec
    return summary


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    return float(-10 * np.log10(np.mean((a - b) ** 2)))


def phase_frame(state: dict) -> None:
    """Reduced geometry: the port on the card (kernels) against the port
    on the CPU (plain versions), same weights and batch."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    cas = CascadeConfig(k_best=2, render_if=(False, True))
    batch = make_scene_batch(B=1, n_views=4, H=128, W=192, boost=True, k_best=2, seed=3,
                             rig="forward")
    outs = {}
    for device in ("cuda", "cpu"):
        model = BoostENeRF(cas, device=device)
        model.load_state_dict(state, strict=True)
        outs[device] = {k: v.cpu().numpy() for k, v in model(batch).items()}
    g, c = outs["cuda"], outs["cpu"]
    require(g.keys() == c.keys(), "output keys differ between card and CPU")
    psnr = psnr_db(g["rgb_level1"], c["rgb_level1"])
    depth_err = float(np.abs(g["depth_mvs_level1"] - c["depth_mvs_level1"]).max())
    emit(phase="frame", geometry=[128, 192], views=4, k_best=2, rgb_psnr_db=psnr,
         depth_mvs_max_abs_err=depth_err)
    require(psnr > 45.0, f"card vs CPU rgb PSNR {psnr} dB <= 45")


def phase_frame_mvsnerf(state: dict, net_type: str = "v0", phase: str = "frame_mvsnerf") -> None:
    """Reduced geometry (128x192, 4 views, K=2 of C(4,3), 32 samples): the
    port on the card against the port on the CPU, same weights and batch,
    with the ``net_type`` head."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    batch = mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=128, W=192, boost=True, seed=3,
                                           rig="forward", render_scales=(1.0,)), k_best=(0, 3))
    outs = {}
    for device in ("cuda", "cpu"):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, net_type=net_type), device=device)
        model.load_state_dict(state, strict=True)
        outs[device] = {k: v.cpu().numpy() for k, v in model(batch).items()}
    g, c = outs["cuda"], outs["cpu"]
    require(g.keys() == c.keys(), "output keys differ between card and CPU")
    psnr = psnr_db(g["rgb_level0"], c["rgb_level0"])
    depth_err = float(np.abs(g["depth_level0"] - c["depth_level0"]).max())
    emit(phase=phase, geometry=[128, 192], views=4, k_best=2, samples=32, net_type=net_type,
         rgb_psnr_db=psnr, depth_max_abs_err=depth_err)
    require(psnr > 45.0, f"card vs CPU rgb PSNR {psnr} dB <= 45")


def phase_main(model, batches, phase: str, expect: dict, rgb_key: str, n_rays: int,
               rgb_max: float = 1.0, costs=None, frames: int = 10, **describe) -> dict:
    """Launches per frame (counts reset just before, read just after one
    frame), three batches checked (rgb finite, in [0, ``rgb_max``]), then
    frame times over ``frames`` back-to-back frames; with ``costs`` (the
    frame's ``utils/roofline`` total) its bound and MFU at the median
    frame."""
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts
    from boostmvsnerfs_torch.utils import roofline

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = model(batches[0])
    torch.cuda.synchronize()
    launches = launch_counts()
    require(launches == {**NO_LAUNCHES, **expect}, f"{phase}: launches per frame {launches}")
    for seed, b in enumerate(batches):
        if seed:
            out = model(b)
        rgb = out[rgb_key]
        require(tuple(rgb.shape) == (1, n_rays, 3), f"rgb shape {tuple(rgb.shape)}")
        for k, v in out.items():
            require(bool(torch.isfinite(v).all()), f"non-finite {k} (seed {seed})")
        require(float(rgb.min()) >= 0.0 and float(rgb.max()) <= rgb_max,
                f"rgb outside [0, {rgb_max}] (seed {seed})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for _ in range(2):
        model(batches[0])
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(frames)]
    t0 = time.perf_counter()
    for start, end in events:  # back to back: no host sync between frames
        start.record()
        model(batches[0])
        end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / frames
    frame_ms = [s.elapsed_time(e) for s, e in events]
    med = statistics.median(frame_ms)
    bounds = {} if costs is None else {"frame_bound": roofline.frame_speed_of_light(
        costs, med / 1e3, roofline.peaks())}
    emit(phase=phase, **describe, launches_per_frame=launches, frame_ms_median=med,
         frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms),
         host_wall_ms_per_frame=wall * 1e3, rays_per_s=n_rays / (med / 1e3),
         peak_mem_gib=peak_gib, frames=frames, **bounds)
    return launches


def phase_profile(run, phase: str, kernels, frames: int = 2, unit: str = "frame") -> None:
    """Where the device time of ``run()`` (one frame or train step) goes,
    from torch.profiler: per run, the device-busy time (sum of kernel times;
    one stream, so they do not overlap) against the run's CUDA-event time,
    the busy time under cuDNN convolutions and batch norm (forward and
    backward), under each ported kernel and in the rest (the glue), the
    top kernels by time and, in a train step, autograd's top backward
    functions by the device time of their kernels."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def block():
        start.record()
        for _ in range(frames):
            run()
        end.record()

    prof, _ = profiled(block)
    events = prof.key_averages()
    kernel_events = block_kernels(prof)
    per_run = lambda us: us / 1e3 / frames  # noqa: E731
    busy = per_run(sum(e.device_time_total for e in kernel_events))
    wall = start.elapsed_time(end) / frames
    by_op = {e.key: per_run(e.device_time_total) for e in events}
    ported = {name: per_run(sum(e.device_time_total for e in kernel_events
                                if f"{name}_kernel" in e.key))
              for name in kernels}
    parts = {"convolution_ms": by_op.get("aten::convolution", 0.0),
             "convolution_backward_ms": by_op.get("aten::convolution_backward", 0.0),
             "batch_norm_ms": by_op.get("aten::batch_norm", 0.0),
             "batch_norm_backward_ms": sum(v for k, v in by_op.items()
                                           if k.endswith("batch_norm_backward"))}
    top = sorted(kernel_events, key=lambda e: -e.device_time_total)[:12]
    backward = sorted((e for e in events if e.key.startswith("autograd::engine::evaluate_function")),
                      key=lambda e: -e.device_time_total)[:8]
    extra = {"backward_functions_ms": {e.key.split(": ", 1)[-1]: per_run(e.device_time_total)
                                       for e in backward}} if backward else {}
    emit(phase=phase, **{f"{unit}s": frames, f"{unit}_ms": wall}, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall, **parts, ported_kernels_ms=ported,
         glue_ms=busy - sum(parts.values()) - sum(ported.values()),
         top_kernels=[{"kernel": e.key[:120], "device_ms": per_run(e.device_time_total),
                       "calls": e.count / frames} for e in top], **extra)


def run_enerf() -> list:
    """The first main path: BoostENeRF at 480x736. Returns its summary
    records."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.utils import roofline
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    model = BoostENeRF(CascadeConfig(k_best=4, render_if=(False, True)))
    state = random_weights(model, 0)
    model.load_state_dict(state, strict=True)

    def make_batch(seed):
        return to_tensors(make_scene_batch(B=1, n_views=6, H=480, W=736, boost=True, k_best=4,
                                           seed=seed, rig="forward"), model.device)

    with torch.no_grad():
        summary = phase_kernels(ENERF_KERNELS, main_path_kernel_inputs(model, make_batch(0)),
                                "boost_enerf")
    torch.cuda.empty_cache()
    phase_frame(state)
    launches = phase_main(model, [make_batch(s) for s in (0, 1, 2)], "main",
                          {"warp_variance": 2, "img_sample": 1, "enerf_head": 1}, "rgb_level1",
                          MAIN_RAYS, costs=roofline.flagship_render_costs(
                              480, 736, cas=model.cas)["total"],
                          geometry=[480, 736], views=6, k_best=4, planes=[64, 8])
    batch = make_batch(0)
    phase_profile(lambda: model(batch), "profile", ("warp_variance", "img_sample", "enerf_head"))
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def run_mvsnerf() -> list:
    """The second main path: BoostMVSNeRF at 224x352. Returns its summary
    records."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.utils import roofline
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    model = BoostMVSNeRF(MVSNeRFConfig(k_best=len(MVS_K_BEST)))
    state = random_weights(model, 0)
    model.load_state_dict(state, strict=True)
    H, W = MVS_HW

    def make_batch(seed):
        batch = make_scene_batch(B=1, n_views=6, H=H, W=W, boost=True, seed=seed, rig="forward",
                                 render_scales=(1.0,))
        return to_tensors(mvsnerf_batch(batch, k_best=MVS_K_BEST), model.device)

    with torch.no_grad():
        summary = phase_kernels(MVS_KERNELS, mvs_kernel_inputs(model, make_batch(0)),
                                "boost_mvsnerf")
    torch.cuda.empty_cache()
    phase_frame_mvsnerf(state)
    kernels = {"tri_sample": 1, "img_sample": 1, "renderer_mlp": 1}
    launches = phase_main(model, [make_batch(s) for s in (0, 1, 2)], "main_mvsnerf", kernels,
                          "rgb_level0", H * W,
                          costs=roofline.mvsnerf_render_costs(H, W, k_best=len(MVS_K_BEST))["total"],
                          geometry=[H, W], views=6,
                          k_best=list(MVS_K_BEST), samples=model.cfg.num_samples)
    batch = make_batch(0)
    phase_profile(lambda: model(batch), "profile_mvsnerf", tuple(kernels))
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


# ------------------------------------------------------------ eval entry


def eval_cfg(cfg_file: str, ws: str, scene: str, *opts):
    """The port's config from ``cfg_file`` with the workspace, scene and
    further key/value overrides, as the CLI's trailing options give them."""
    from boostmvsnerfs_torch.config import make_cfg

    return make_cfg(cfg_file, ["workspace", ws, "scene", scene, *opts])


def save_seeded_weights(cfg) -> None:
    """Seeded random weights (``random_weights``) as the port's
    ``latest.pt`` in ``cfg.trained_model_dir``."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    model = runner.make_network(cfg, "cpu")
    CheckpointManager(cfg.trained_model_dir).save({"model": random_weights(model, 0)}, 0)


def expected_eval_launches(views: int, combos: int, chunk: int, per_chunk: dict,
                           per_frame: dict) -> dict:
    """Launches of an eval run of ``views`` target views, one per batch:
    each view's pre-pass in ceil(combos / chunk) chunks, then its frame."""
    chunks = math.ceil(combos / chunk)
    return {k: views * (chunks * per_chunk.get(k, 0) + per_frame.get(k, 0))
            for k in {**per_chunk, **per_frame}}


def compare_masks(masks: np.ndarray, ref: np.ndarray, k: int) -> dict:
    """Coverage masks (n_combos, H, W) against ``ref``: their differences
    (``MASK_*_TOL``) and the greedy picks over each (``greedy_steps``), as
    far as the margin rule allows. With e the largest mean absolute
    difference of one combination's masks, a covered share moves by at
    most e through its own mask and e per earlier pick through the
    coverage so far; so a step after t picks is compared when its margin
    exceeds 2 (t + 1) e and every earlier step was."""
    from boostmvsnerfs_torch.models.boost_enerf import greedy_steps

    diff = np.abs(masks - ref)
    scale = float(np.abs(ref).max())
    e = float(diff.mean(axis=(1, 2)).max())
    (got, margins), want = greedy_steps(masks, k), greedy_steps(ref, k)[0]
    compared = 0
    for t, margin in enumerate(margins):
        if margin <= 2 * (t + 1) * e:
            break
        compared += 1
    return {"picks": got, "ref_picks": want, "steps_compared": compared, "margins": margins,
            "mask_max_abs_diff": float(diff.max()), "mask_mean_abs_diff": e,
            "mask_mean_rel_diff": e / scale,
            "mask_pixel_share": float((diff > 1e-3 * scale).mean(axis=(1, 2)).max())}


def masks_within_limits(r: dict) -> bool:
    return (r["mask_mean_rel_diff"] <= MASK_MEAN_DIFF_TOL
            and r["mask_pixel_share"] <= MASK_PIXEL_SHARE_TOL)


def first_test_batch(cfg, view_selection, device):
    """The entry's first test batch with its k_best attached, on ``device``."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader

    np_batch = next(iter(Loader(make_dataset(cfg, "test"), batch_size=1)))
    return runner._device_batch(runner.attach_boost_inputs(np_batch, view_selection, cfg),
                                device)


def prepass_per_view(cfg, model) -> dict:
    """The pre-pass of each target view alone (``greedy_select``, masks to
    the host and the greedy search): its time and launches, and the
    per-combination cost (``combo_coverage_mask`` of the first 4
    combinations, the FPN on each combination's views) scaled to all."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader
    from boostmvsnerfs_torch.models.boost_enerf import view_combinations
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    k = int(cfg.enerf.cas_config.k_best)
    ms, launches, per_combo = [], [], []
    for np_batch in Loader(make_dataset(cfg, "test"), batch_size=1):
        batch = runner._device_batch(np_batch, model.device)
        combos = view_combinations(batch["all_src_inps"].shape[1],
                                   int(cfg.enerf.cost_volume_input_views))
        runner.greedy_select(model, batch, combos, k)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        runner.greedy_select(model, batch, combos, k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({n: c for n, c in launch_counts().items() if c})
        for c in combos[:4]:
            per_combo.append(median_ms(lambda: model.combo_coverage_mask(batch, c), 3, 1))
    return {"prepass_ms_per_view": ms, "prepass_launches_per_view": launches,
            "per_combination_ms_x_combinations": statistics.mean(per_combo) * len(combos)}


def check_selection(models: dict, np_batch: dict, cfg, mask_fault: str, render: bool):
    """One target view (batch of one) of the card-vs-CPU check
    (``models``: 'cuda' and 'cpu', the same weights): the coverage masks
    of every combination (``compare_masks``) within the MASK_*_TOL limits,
    which the CPU port with ``mask_fault`` of MASK_FAULTS planted must
    fail, and the greedy picks equal on at least EVAL_STEPS_COMPARED steps.
    With ``render``, the frame rendered on both with the card's picks.
    Returns (the masks' report, the rgb PSNR in dB or None)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.boost_enerf import search_k_best, view_combinations

    k = int(cfg.enerf.cas_config.k_best)
    arrays = {k_: v for k_, v in np_batch.items() if k_ != "meta"}
    combos = view_combinations(np_batch["all_src_inps"].shape[1],
                               int(cfg.enerf.cost_volume_input_views))
    masks = {d: m.forward_view_selection(arrays, combos).cpu().numpy()[:, 0]
             for d, m in models.items()}
    with planted(mask_fault, MASK_FAULTS):
        control = models["cpu"].forward_view_selection(arrays, combos).numpy()[:, 0]
    rep, ctl = compare_masks(masks["cuda"], masks["cpu"], k), compare_masks(
        control, masks["cpu"], k)
    rep["control"] = {key: ctl[key] for key in ("mask_mean_rel_diff", "mask_pixel_share")}
    n = rep["steps_compared"]
    require(masks_within_limits(rep), f"card vs CPU coverage masks {rep}")
    require(not masks_within_limits(ctl), f"control {mask_fault!r} within the limits {ctl}")
    require(n >= EVAL_STEPS_COMPARED and rep["picks"][:n] == rep["ref_picks"][:n],
            f"card vs CPU picks {rep}")
    if not render:
        return rep, None
    picks = search_k_best(masks["cuda"], k)
    sel = {f"{m['scene']}_{m['tar_view']}": (picks + picks[-1:] * k)[:k] for m in np_batch["meta"]}
    b = runner.attach_boost_inputs(dict(np_batch), sel, cfg)
    outs = {d: m({k_: v for k_, v in b.items() if k_ != "meta"}) for d, m in models.items()}
    key = max(k_ for k_ in outs["cpu"] if k_.startswith("rgb_level"))
    return rep, psnr_db(outs["cuda"][key].cpu().numpy(), outs["cpu"][key].numpy())


def eval_check(cfg_file: str, ws: str, scene: str, mask_fault: str) -> dict:
    """The entry at EVAL_CHECK_HW on the card against the CPU port, same
    weights. For each test view the coverage masks (``compare_masks``):
    within the MASK_*_TOL limits, which the CPU port with ``mask_fault``
    of MASK_FAULTS planted must fail, and the greedy picks equal on at
    least EVAL_STEPS_COMPARED steps. The first view's frame rendered with
    the card's picks (rgb PSNR over 45 dB), and ``run_evaluate``'s psnr
    (the CPU run reads the card run's view selection, so that both render
    the same combinations)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader

    hw = "[{}, {}]".format(*EVAL_CHECK_HW)
    cfgs = {d: eval_cfg(cfg_file, ws, scene, "test_dataset.input_h_w", hw, "save_tag",
                        f"check_{d}") for d in ("cuda", "cpu")}
    models = {}
    for d, c in cfgs.items():
        models[d] = runner.make_network(c, d)
        runner._init_or_load(c, models[d])
    cfg = cfgs["cuda"]
    views, rgb_psnr = [], []
    for np_batch in Loader(make_dataset(cfg, "test"), batch_size=1):
        rep, psnr = check_selection(models, np_batch, cfg, mask_fault, render=not rgb_psnr)
        views.append(rep)
        rgb_psnr += [psnr] if psnr is not None else []
    ret_card = runner.run_evaluate(cfgs["cuda"])
    os.makedirs(cfgs["cpu"].result_dir, exist_ok=True)
    shutil.copy(runner.view_selection_path(cfgs["cuda"]),
                runner.view_selection_path(cfgs["cpu"]))
    ret_cpu = runner.run_evaluate(cfgs["cpu"], device="cpu")
    out = {"geometry": list(EVAL_CHECK_HW), "views": views, "rgb_psnr_db": rgb_psnr,
           "psnr_card": ret_card["psnr"], "psnr_cpu": ret_cpu["psnr"],
           "psnr_diff_db": abs(ret_card["psnr"] - ret_cpu["psnr"]),
           "ssim_diff": abs(ret_card["ssim"] - ret_cpu["ssim"])}
    require(min(rgb_psnr) > 45.0, f"card vs CPU rgb PSNR {rgb_psnr} dB <= 45")
    require(out["psnr_diff_db"] < EVAL_PSNR_TOL_DB, f"card vs CPU psnr {out}")
    return out


def drive_eval_entry(cfg_file: str, phase: str, write_scene, scene: str, table: dict,
                     kernel_inputs, per_chunk: dict, per_frame: dict, mask_fault: str) -> list:
    """One eval-entry phase (module docstring, item 8): returns its kernels'
    summary records, with the launches of the entry's run."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.eval.lpips import fixture_lpips
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        write_scene(ws)
        cfg = eval_cfg(cfg_file, ws, scene)
        save_seeded_weights(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        ret = runner.run_evaluate(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        vs = runner.load_view_selection(cfg)
        views = len(ret["frame_ms"])
        n_views = int(cfg.enerf.test_input_views)
        combos = math.comb(n_views, int(cfg.enerf.cost_volume_input_views))
        k = int(cfg.enerf.cas_config.k_best)
        expect = expected_eval_launches(views, combos, k, per_chunk, per_frame)
        require(launches == {**NO_LAUNCHES, **expect}, f"{phase}: launches {launches}")
        require(len(vs) == views == 2 and all(len(v) == k and all(0 <= i < combos for i in v)
                                              for v in vs.values()), f"view selection {vs}")
        for key in ("psnr", "ssim", "lpips_uncalibrated"):
            require(math.isfinite(ret[key]), f"{phase}: {key} {ret.get(key)}")

        model = runner.make_network(cfg)
        runner._init_or_load(cfg, model)
        batch = first_test_batch(cfg, vs, model.device)
        with torch.no_grad():
            summary = phase_kernels(table, kernel_inputs(model, batch), phase)
        prepass = prepass_per_view(cfg, model)
        per_view = {n: math.ceil(combos / k) * c for n, c in per_chunk.items()}
        for got in prepass["prepass_launches_per_view"]:
            require(got == per_view, f"{phase}: pre-pass launches per view {got}")
        H, W = batch["all_src_inps"].shape[2:4]
        lp = fixture_lpips()
        a, b = (torch.rand(1, H, W, 3, device="cuda") * 2 - 1 for _ in range(2))
        lpips_ms = median_ms(lambda: lp(a, b), 5)
        del model, batch, lp
        torch.cuda.empty_cache()
        check = eval_check(cfg_file, ws, scene, mask_fault)
    frame_ms = ret["frame_ms"]
    emit(phase=phase, config=cfg_file, geometry=[int(H), int(W)], views=n_views,
         combinations=combos, k_best=k, target_views=views, view_selection=vs,
         summary={k_: v for k_, v in ret.items() if k_ != "frame_ms"},
         launches=launches, frame_ms=frame_ms, frame_ms_median=statistics.median(frame_ms),
         frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms), entry_seconds=seconds,
         **prepass, lpips_ms_per_image=lpips_ms, peak_mem_gib=peak_gib, check=check,
         phase_seconds=time.perf_counter() - t_phase)
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def run_evaluate_path() -> list:
    """The eval entry over BoostENeRF at 480x736 (phase ``evaluate``); its
    pre-pass launches the warp at both levels per chunk of combinations."""
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    per = {"warp_variance": 2, "img_sample": 1, "enerf_head": 1}
    return drive_eval_entry(
        FREE_EVAL, "evaluate",
        lambda ws: write_free_scene(os.path.join(ws, "Free"), "grass", EVAL_IMAGES, 480, 736,
                                    rig="varied"),
        "grass", {k: ENERF_KERNELS[k] for k in per}, main_path_kernel_inputs,
        {"warp_variance": 2}, per, "warp_variance: the first view's features lost")


def run_evaluate_mvsnerf_path() -> list:
    """The eval entry over BoostMVSNeRF at 224x352 (phase
    ``evaluate_mvsnerf``); its pre-pass is geometry and launches none, its
    frames go through ``StagedMVSNeRF``'s 7 row blocks."""
    from boostmvsnerfs_torch.utils.synthetic import write_scannet_scene

    per = scaled(MVS_FRAME, mvs_row_blocks(MVS_HW[0]))
    return drive_eval_entry(
        SCANNET_EVAL, "evaluate_mvsnerf",
        lambda ws: write_scannet_scene(os.path.join(ws, "scannet_plus"), "scene0000_01",
                                       EVAL_IMAGES, *MVS_HW, test_ids=SCANNET_TEST_IDS,
                                       rig="varied"),
        "scene0000_01", {k: MVS_KERNELS[k] for k in per}, mvs_kernel_inputs, {}, per,
        "viewport_visibility: the first view sees nothing")


def mvs_row_blocks(H: int) -> int:
    """Row blocks of an MVSNeRF frame of ``H`` raster rows through
    ``StagedMVSNeRF``: H / MVS_ROW_CHUNK where H is a multiple of it above
    it, else one (JAX's rule)."""
    return H // MVS_ROW_CHUNK if H > MVS_ROW_CHUNK and H % MVS_ROW_CHUNK == 0 else 1


MVS_FREE_EVAL = "configs/exps/evaluate/mvsnerf_ours/free_eval.yaml"
MVS_FREE_HW = (480, 736)
STAGED_FRAMES = 3  # timed frames of each executor, after the measured one


def frame_run(fn, batch, frames: int = STAGED_FRAMES) -> tuple:
    """One frame of ``fn(batch)``: its outputs and, on the card, its peak
    memory (from a reset) and the median CUDA-event time of ``frames``
    more."""
    if not batch["all_src_inps"].is_cuda:
        return fn(batch), {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    return out, {"peak_mem_gib": peak, "frame_ms": median_ms(lambda: fn(batch), frames, 0)}


# The staged frame against the monolithic one, under deterministic cuDNN:
# the volume is built once by the same call and every later step works per
# ray or per sample, so with the v0 head, whose MLP is kernel #8, the two
# are equal. The other heads run their layers plainly through cuBLAS, which
# picks its kernels, and with them the order of a product's sums, by the
# number of rows: 1.8e-7 in rgb for the v1 head at 224x352 on the NVIDIA
# H100 80GB HBM3 (PERF.md, section 6). Those are held to 1e-5 of
# each output's largest magnitude (at least 1).
STAGED_PLAIN_HEAD_RTOL = 1e-5


def staged_frames(model, batch, what: str, monolithic: bool = True,
                  frames: int = STAGED_FRAMES) -> dict:
    """``batch``'s frame through ``StagedMVSNeRF`` and, with ``monolithic``,
    through the model whole, under deterministic cuDNN: every output finite,
    rgb of the target's shape, the two frames equal (within
    STAGED_PLAIN_HEAD_RTOL for a head without the MLP kernel). Returns each
    executor's ``frame_run`` record and the errors."""
    from boostmvsnerfs_torch.models.mvsnerf import KERNEL_HEADS
    from boostmvsnerfs_torch.parallel.staged import StagedMVSNeRF

    H, W = batch["all_src_inps"].shape[2:4]
    rec = {"row_blocks": mvs_row_blocks(H)}
    with deterministic_cudnn():
        staged, rec["staged"] = frame_run(StagedMVSNeRF(model), batch, frames)
        require(all(bool(torch.isfinite(v).all()) for v in staged.values())
                and tuple(staged["rgb_level0"].shape) == (1, H * W, 3),
                f"{what}: staged frame outputs")
        if monolithic:
            whole, rec["monolithic"] = frame_run(model, batch, frames)
            require(staged.keys() == whole.keys(), f"{what}: output keys")
            rec["max_abs_err"] = {k: float((staged[k] - whole[k]).abs().max()) for k in whole}
            rtol = 0.0 if model.cfg.net_type in KERNEL_HEADS else STAGED_PLAIN_HEAD_RTOL
            rec["tolerance"] = {k: rtol * max(1.0, float(v.abs().max())) for k, v in whole.items()}
            require(all(rec["max_abs_err"][k] <= rec["tolerance"][k] for k in whole),
                    f"{what}: staged vs monolithic {rec['max_abs_err']}")
    return rec


def staged_v1_frames(ws: str, vs: dict, sizes=(MVS_HW, MVS_FREE_HW), device=None,
                     *opts) -> dict:
    """The v1 head (``mvsnerf.net_type v1``, seeded weights) from the Free
    eval config (and ``opts``): its staged frame against its monolithic
    frame at the first size (224x352), then its staged frame alone at the
    second (480x736), whose monolithic frame would outgrow the card, with
    peak memory."""
    from boostmvsnerfs_torch import runner

    out = {}
    for i, hw in enumerate(sizes):
        cfg = eval_cfg(MVS_FREE_EVAL, ws, "grass", "mvsnerf.net_type", "v1",
                       "test_dataset.input_h_w", "[{}, {}]".format(*hw), *opts)
        model = runner.make_network(cfg, device)
        model.load_state_dict(random_weights(model, 0), strict=True)
        batch = first_test_batch(cfg, vs, model.device)
        out["x".join(map(str, hw))] = staged_frames(model, batch, f"staged_mvsnerf v1 at {hw}",
                                                    monolithic=i == 0, frames=1)
        del model, batch
        if model_on_card(device):
            torch.cuda.empty_cache()
    return out


def model_on_card(device) -> bool:
    return device is None or torch.device(device).type == "cuda"


def staged_entry(cfg, device=None) -> tuple:
    """``run_evaluate(cfg)`` with its launches counted (reset just before,
    read just after), held to the design: no launch in the pre-pass
    (geometry), MVS_FRAME per row block and test view. Returns (its
    summary, its launches)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    ret = runner.run_evaluate(cfg, device=device)
    if model_on_card(device):
        torch.cuda.synchronize()
    launches = launch_counts()
    views = len(ret["frame_ms"])
    H = int(cfg.test_dataset.input_h_w[0])
    combos = math.comb(int(cfg.enerf.test_input_views), int(cfg.enerf.cost_volume_input_views))
    expect = expected_eval_launches(views, combos, int(cfg.enerf.cas_config.k_best), {},
                                    scaled(MVS_FRAME, mvs_row_blocks(H)))
    require(views == 2 and launches == {**NO_LAUNCHES, **expect},
            f"staged_mvsnerf: launches {launches}, expected {expect}")
    for key in ("psnr", "ssim"):
        require(math.isfinite(ret[key]), f"staged_mvsnerf: {key} {ret.get(key)}")
    return ret, launches


def run_staged_mvsnerf() -> list:
    """Phase ``staged_mvsnerf`` (module docstring, item 8): the MVSNeRF
    family's Free eval recipe at 480x736 through ``runner.make_forward``'s
    ``StagedMVSNeRF``. Returns the kernels' summary records, with the
    launches of the entry's run."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.parallel.staged import ray_blocks
    from boostmvsnerfs_torch.utils import roofline

    t_phase = time.perf_counter()
    H, W = MVS_FREE_HW
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws, H, W)
        cfg = eval_cfg(MVS_FREE_EVAL, ws, "grass")
        save_seeded_weights(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ret, launches = staged_entry(cfg)
        entry_peak = torch.cuda.max_memory_allocated() / 2**30

        model = runner.make_network(cfg)
        runner._init_or_load(cfg, model)
        vs = runner.load_view_selection(cfg)
        batch = first_test_batch(cfg, vs, model.device)
        frames = staged_frames(model, batch, "staged_mvsnerf")
        ids = ray_blocks(batch["ray_idx_0"], W, MVS_ROW_CHUNK)
        with torch.no_grad():
            summary = phase_kernels({k: MVS_KERNELS[k] for k in MVS_FRAME},
                                    mvs_kernel_inputs(model, batch, ids[0]), "staged_mvsnerf")
        del model, batch
        torch.cuda.empty_cache()
        v1 = staged_v1_frames(ws, vs)
    k_best = int(cfg.enerf.cas_config.k_best)
    costs = roofline.mvsnerf_render_costs(H, W, k_best=k_best)["total"]
    emit(phase="staged_mvsnerf", config=MVS_FREE_EVAL, geometry=[H, W], row_chunk=MVS_ROW_CHUNK,
         k_best=k_best, summary={k: v for k, v in ret.items() if k != "frame_ms"},
         launches=launches, entry_frame_ms=ret["frame_ms"], entry_peak_mem_gib=entry_peak,
         frames=frames, staged_bound=roofline.frame_speed_of_light(
             costs, frames["staged"]["frame_ms"] / 1e3, roofline.peaks()),
         v1=v1, phase_seconds=time.perf_counter() - t_phase)
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


# ----------------------------------------------------------------- training


def train_kernel_inputs(model, batch, seed: int = 7, ray_blocks: int = RAY_BLOCKS) -> dict:
    """The training path's sampler inputs and the backward kernels' inputs,
    from the model's own train-mode stages, each backward with a seeded
    normal cotangent of its output's shape: #2 at both levels, #3 and #4 at
    level 0 (all rays, C=35) and at the first level-1 ray block of the
    blocked step (C=11); #1's f32 instance (the training forward) at both
    levels. {name: [(label, args)]}."""
    from boostmvsnerfs_torch.parallel.train import level_ray_blocks

    gen = torch.Generator(device=batch["all_src_inps"].device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    cas = model.cas
    model.train()
    feats, sub = model.fold_combinations(batch)
    stage = (sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"], sub["near_far"])
    H, W = batch["all_src_inps"].shape[2:4]
    n_max = max(batch[f"ray_idx_{i}"].shape[1] for i in range(cas.num))
    warp, warp_bwd, sample, sample_bwd, prev = [], [], [], [], None
    for level in range(cas.num):
        dv, _, pm = model.volume_inputs(level, feats, *stage, prev)
        f = feats[f"level_{level}"]
        warp_bwd.append((f"level{level}", (f, pm, dv, normal(*dv.shape, f.shape[-1]))))
        warp.append((f"level{level}", (f, pm, dv, torch.float32)))
        _, depth, std, nf_map = model.build_level_volume(level, feats, *stage, prev)
        prev = (depth, std, nf_map)
        rs = cas.render_scale[level]
        H_r, W_r = int(H * rs), int(W * rs)
        ray_idx = sub[f"ray_idx_{level}"]
        nb = level_ray_blocks(max(ray_blocks, 1), ray_idx.shape[1], n_max, H_r, True)
        ridx = ray_idx[:, : ray_idx.shape[1] // nb]
        bounds_map, maps = model.level_maps(level, feats, depth, std, nf_map, sub["src_inps"])
        world_xyz, _, _ = model.sample_rays(level, bounds_map, sub, ridx)
        BK, S = maps.shape[:2]
        x, y = model.project_to_views(world_xyz.reshape(BK, -1, 3), sub, rs)
        imgs = maps.reshape(BK * S, H_r, W_r, maps.shape[-1])
        x, y = x.reshape(BK * S, -1), y.reshape(BK * S, -1)
        label = f"level{level}" + (f" block 1 of {nb}" if nb > 1 else "")
        sample.append((label, (imgs, x, y)))
        sample_bwd.append((label, (imgs, x, y, normal(*x.shape, imgs.shape[-1]))))
    return {"warp_variance": warp, "warp_variance_bwd": warp_bwd, "img_sample": sample,
            "img_sample_bwd": sample_bwd}


def grid_sample_bwd_library(imgs, x, y, g):
    """The backward of ``F.grid_sample`` (bilinear, border, align-corners,
    NCHW) for the same cotangent: gradients of the maps and of the grid."""
    import torch.nn.functional as F

    V, H, W, C = imgs.shape
    nchw = imgs.permute(0, 3, 1, 2).contiguous().requires_grad_()
    grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], -1)[:, None].requires_grad_()
    with torch.enable_grad():
        out = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                            align_corners=True)
    g_nchw = g.permute(0, 2, 1)[:, :, None].contiguous()  # (V, C, 1, P)

    def backward():
        with torch.enable_grad():
            return torch.autograd.grad(out, (nchw, grid), g_nchw, retain_graph=True)

    return backward


# The f32 warp rounds its coordinates as the plain version does (every tap
# the same) and its tap sums with one rounding per term (FMAs): it is held
# at 1e-5 of its output's magnitude.
WARP_F32_RTOL = 1e-5
# entry -> (kernel, instance or None, its Pallas kernel, work, library
# yardstick or None, tolerance relative to each output's largest magnitude)
TRAIN_KERNELS = {
    "warp_variance": ("warp_variance", "f32 features (the training forward)",
                      "boostmvsnerfs_tpu/ops/pallas/warp_variance.py:38", warp_work, None,
                      WARP_F32_RTOL),
    "warp_variance_bwd": ("warp_variance_bwd", None,
                          "boostmvsnerfs_tpu/ops/pallas/warp_variance.py:244", warp_bwd_work, None,
                          KERNEL_RTOL),
    "img_sample": ("img_sample", "forward on the training path",
                   "boostmvsnerfs_tpu/ops/pallas/img_sample.py:106", sample_work,
                   grid_sample_library, KERNEL_RTOL),
    "img_sample_bwd": ("img_sample_bwd", None, "boostmvsnerfs_tpu/ops/pallas/img_sample.py:458",
                       sample_bwd_work, grid_sample_bwd_library, KERNEL_RTOL),
}


def phase_kernels_train(inputs: dict, phase: str = "kernels_train", path: str = "train") -> dict:
    """Each kernel of TRAIN_KERNELS against its plain version on the
    training path's inputs: every output's max abs error within the
    entry's tolerance of that output's largest magnitude (KERNEL_RTOL for
    the backward kernels, whose scatters are atomic, in an order that
    changes from run to run); the times and bounds as in
    ``phase_kernels``. Returns the summary record of each entry."""
    summary = {}
    for entry, (name, instance, replaces, work, library, rtol) in TRAIN_KERNELS.items():
        kernel, plain = kernel_pair(name)
        rec = {"name": name, "route": "cuda", "source": f"boostmvsnerfs_torch/csrc/{name}.cu",
               "replaces": replaces, "path": path, "compute_dtype": "float32",
               "max_abs_err": 0.0, "ms": 0.0,
               "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
        if instance:
            rec["instance"] = instance
        ops_total = bytes_total = 0.0
        for label, args in inputs[entry]:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if torch.is_tensor(got):
                got, want = (got,), (want,)
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            scales = [float(b.abs().max()) for b in want]
            del got, want
            t = timings(lambda: kernel(*args), library(*args) if library else None)
            plain_ms = median_ms(lambda: plain(*args), 3, warmup=1)
            nbytes, ops = work(*args)
            bms, by = bound(nbytes, ops)
            emit(phase=phase, kernel=name, instance=instance, at=label,
                 shapes=[list(a.shape) for a in args if torch.is_tensor(a)], max_abs_err=errs,
                 largest=scales, relative_err=[e / max(c, 1e-30) for e, c in zip(errs, scales)],
                 tolerance=rtol, **t, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 bytes=nbytes, ops=ops, **data_shares(name, args), **shares(bms, t))
            for e, c in zip(errs, scales):
                require(e <= rtol * c, f"{name} at {label}: error {e} vs largest {c}")
            rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
            rec["ms"] += t["ms"]
            rec["device_ms"] += t["device_ms"]
            rec["plain_ms"] += plain_ms
            if t["library_ms"] is not None:
                rec["library_ms"] = (rec["library_ms"] or 0.0) + t["library_ms"]
            bytes_total += nbytes
            ops_total += ops
        rec["bound_ms"], rec["bound_by"] = bound(bytes_total, ops_total)
        summary[entry] = rec
    return summary


def smooth_scene_batch(H: int, W: int, seed: int) -> dict:
    """A forward-rig batch (4 views, K=2) whose target sits between source
    frames 1 and 2 (not on frame 2, where the ray difference to that view is
    the zero vector) and whose source images are smooth (a few seeded
    sinusoids), as photographs are and the synthetic noise images are not."""
    from boostmvsnerfs_torch.utils.synthetic import look_at_ext, make_scene_batch

    batch = make_scene_batch(B=1, n_views=4, H=H, W=W, boost=True, k_best=2, seed=seed,
                             rig="forward", with_targets=True)
    pos = np.array([0.15 * np.sin(0.75), 0.04 * np.cos(1.35), 0.375])  # the rig's path at 1.5
    batch["tar_ext"] = look_at_ext(pos, target=pos + np.array([0.0, 0.0, 5.0]))[None]
    batch["src_inps"] = batch["all_src_inps"] = smooth_images(batch["src_inps"].shape, seed)
    return batch


def smooth_images(shape: tuple, seed: int) -> np.ndarray:
    """Source images (B, S, H, W, 3) in [-1, 1] made of a few seeded
    sinusoids."""
    H, W = shape[2:4]
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H) / H, np.arange(W) / W, indexing="ij")
    img = np.zeros(shape)
    for _ in range(6):
        fx, fy, phase = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)[None, None, :, :, None]
        img += rng.uniform(-0.25, 0.25, (*img.shape[:2], 1, 1, 3)) * wave
    return img.astype(np.float32)


def grad_rel_errors(got: dict, want: dict, floor: float = 1e-5) -> dict:
    """Per tensor |g - w| / max(|w|, floor * the largest |w|) (L2 norms):
    a few gradients are ~0 by symmetry, and there the relative error is
    rounding noise."""
    top = max(float(torch.linalg.norm(w)) for w in want.values())
    return {k: float(torch.linalg.norm(got[k] - w)) / max(float(torch.linalg.norm(w)), floor * top)
            for k, w in want.items()}


def train_step_grads(state: dict, batch: dict, device: str, dtype, kind: str):
    """One plain or blocked Adam step of BoostENeRF (K=2) from ``state``:
    (loss, gradients as float64 CPU tensors)."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.parallel.train import (
        create_train_state,
        make_blocked_train_step,
        make_train_step,
    )
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = BoostENeRF(CascadeConfig(k_best=2), device=device).to(dtype)
    model.load_state_dict(state, strict=True)
    train_state = create_train_state(model, make_optimizer(TRAIN_CFG, TRAIN_EP_ITER))
    step = make_blocked_train_step(model, 4) if kind == "blocked" else make_train_step(model)
    loss = float(step(train_state, batch)["loss"])
    return loss, {k: p.grad.double().cpu() for k, p in model.named_parameters()}


def global_rel_error(got: dict, want: dict) -> float:
    """Relative L2 error of all gradients together."""
    flat = lambda g: {"all": torch.cat([v.flatten() for v in g.values()])}  # noqa: E731
    return grad_rel_errors(flat(got), flat(want))["all"]


# Card gradients against the float64 CPU port, relative L2. Float32 alone
# moves them by several 1e-3 at 128x192, on the CPU as on the card: a ulp of
# the inputs flips a few ReLUs and moves a few samples across pixel lines,
# where the sampler's coordinate derivative jumps, and through the FPN's and
# the U-Nets' batch-statistics BatchNorms (whose innermost levels hold few
# voxels) each flip moves a whole channel's gradient. Every run measures
# both sides of the bars on the CPU port, against float64: float32's spread
# (its steps on the batch and on copies whose images moved by ~1 ulp) must
# pass them, and each fault of PLANTED_FAULTS must fail them.
GRAD_RTOL_TENSOR = 2e-2
GRAD_RTOL_GLOBAL = 2.5e-3
ULP_PERTURBATIONS = 4


def _outputs_changed(change):
    """A fault: the function, with ``change`` applied to its outputs."""
    return lambda fn: lambda *args, **kw: change(*fn(*args, **kw))


def _first_zeroed(t, dim: int):
    """``t`` with its first entry along ``dim`` set to 0 (a lost scatter)."""
    t = t.clone()
    t.select(dim, 0).zero_()
    return t


def _near_far_with_gradient(fn):
    """A fault: ``depth_values_near_far`` without its stop-gradient."""

    def near_far(depth_values, inverse):
        nf = depth_values[:, [0, -1]]
        return 1.0 / nf.clamp_min(1e-6) if inverse else nf

    return near_far


# Faults planted, one at a time, into the CPU port's float32 step, each a
# wiring fault the card check exists to catch: name -> (module, under
# boostmvsnerfs_torch.ops unless it names the package, function,
# replacement of the function).
PLANTED_FAULTS = {
    "img_sample_bwd: d x = d y = 0": (
        "cuda.img_sample", "row_sample_bwd_plain",
        _outputs_changed(lambda di, dx, dy: (di, torch.zeros_like(dx), torch.zeros_like(dy)))),
    "img_sample_bwd: the first map's d imgs lost": (
        "cuda.img_sample", "row_sample_bwd_plain",
        _outputs_changed(lambda di, dx, dy: (_first_zeroed(di, 0), dx, dy))),
    "warp_variance_bwd: d depth = 0": (
        "cuda.warp_variance", "warp_variance_bwd_plain",
        _outputs_changed(lambda df, dd: (df, torch.zeros_like(dd)))),
    "warp_variance_bwd: the first view's d feats lost": (
        "cuda.warp_variance", "warp_variance_bwd_plain",
        _outputs_changed(lambda df, dd: (_first_zeroed(df, 1), dd))),
    "depth_values_near_far: no stop-gradient": (
        "cost_volume", "depth_values_near_far", _near_far_with_gradient),
}


# Faults planted into the CPU port's view-selection pre-pass, the controls
# of its card-vs-CPU check (``eval_check``): name -> as PLANTED_FAULTS.
MASK_FAULTS = {
    "warp_variance: the first view's features lost": (
        "cuda.warp_variance", "warp_variance_plain",
        lambda fn: lambda feats, *args: fn(_first_zeroed(feats, 1), *args)),
    "viewport_visibility: the first view sees nothing": (
        "render", "viewport_visibility", lambda fn: lambda *args: _first_zeroed(fn(*args), 1)),
}


@contextlib.contextmanager
def planted(fault: str, faults: dict = PLANTED_FAULTS):
    """Run the block with ``fault`` of ``faults`` in place."""
    import importlib

    module, attr, replace = faults[fault]
    if not module.startswith("boostmvsnerfs_torch."):
        module = f"boostmvsnerfs_torch.ops.{module}"
    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    setattr(mod, attr, replace(original))
    try:
        yield
    finally:
        setattr(mod, attr, original)


def grad_readings(grads: dict, ref: dict) -> dict:
    """The worst tensor's and all tensors' relative L2 errors against ``ref``."""
    return {"worst": max(grad_rel_errors(grads, ref).values()),
            "global": global_rel_error(grads, ref)}


def within_bars(r: dict, bars: tuple = (GRAD_RTOL_TENSOR, GRAD_RTOL_GLOBAL)) -> bool:
    return r["worst"] <= bars[0] and r["global"] <= bars[1]


def cpu_bar_readings(state: dict, batch: dict, ref: dict, float32: list, grads=None,
                     faults: dict = PLANTED_FAULTS) -> dict:
    """Both sides of the gradient bars on the CPU port against the float64
    gradients ``ref``: 'spread', float32's own errors (the ``float32``
    gradients already taken, then steps on ULP_PERTURBATIONS copies of the
    batch whose images moved by ~1 ulp), and 'faults', the float32 step
    with each fault of ``faults`` planted. ``grads(batch)`` takes the CPU
    port's float32 step (default: BoostENeRF's plain step from
    ``state``)."""
    if grads is None:
        grads = lambda b: train_step_grads(state, b, "cpu", torch.float32, "plain")[1]  # noqa: E731
    spread = list(float32)
    rng = np.random.default_rng(11)
    for _ in range(ULP_PERTURBATIONS):
        moved = dict(batch)
        imgs = batch["src_inps"] * (1 + 2**-23 * rng.standard_normal(batch["src_inps"].shape))
        moved["src_inps"] = moved["all_src_inps"] = imgs.astype(np.float32)
        spread.append(grads(moved))
    readings = {}
    for fault in faults:
        with planted(fault, faults):
            readings[fault] = grad_readings(grads(batch), ref)
    return {"spread": [grad_readings(g, ref) for g in spread], "faults": readings}


def phase_train_step_check(state: dict) -> None:
    """One plain and one blocked Adam step at 128x192 (4 views, K=2) with
    the same weights and batch on the card (kernels, float32) and on the
    CPU port (plain versions, float32, and float64 as the reference).

    The losses must agree to 1e-4 and the card's blocked and plain losses
    to 1e-5. Each card gradient must lie within GRAD_RTOL_TENSOR of the
    float64 one, and all of them together within GRAD_RTOL_GLOBAL. The
    bars are tested in the same run (``cpu_bar_readings``): float32's own
    spread must pass them, and every planted fault must fail them."""
    batch = smooth_scene_batch(128, 192, seed=3)
    runs = {(dev, kind): train_step_grads(state, batch, dev, torch.float32, kind)
            for dev in ("cuda", "cpu") for kind in ("plain", "blocked")}
    ref_loss, ref = train_step_grads(state, batch, "cpu", torch.float64, "plain")
    bars = cpu_bar_readings(state, batch, ref, [runs["cpu", k][1] for k in ("plain", "blocked")])
    record = {"geometry": [128, 192], "views": 4, "k_best": 2, "loss_cpu_float64": ref_loss,
              "bars": {"tensor": GRAD_RTOL_TENSOR, "global": GRAD_RTOL_GLOBAL},
              "cpu_float32_vs_float64": bars["spread"], "cpu_planted_faults": bars["faults"]}
    for kind in ("plain", "blocked"):
        (lg, gg), (lc, gc) = runs["cuda", kind], runs["cpu", kind]
        vs_ref = grad_rel_errors(gg, ref)
        worst = sorted(vs_ref, key=vs_ref.get, reverse=True)[:3]
        record[kind] = {"loss_card": lg, "loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
                        "card_vs_float64_worst": {k: vs_ref[k] for k in worst},
                        "card_vs_float64_global": global_rel_error(gg, ref),
                        "card_vs_cpu_worst": max(grad_rel_errors(gg, gc).values()),
                        "card_vs_cpu_global": global_rel_error(gg, gc)}
    lb, lp = runs["cuda", "blocked"][0], runs["cuda", "plain"][0]
    record["card_blocked_vs_plain_loss_rel_err"] = abs(lb - lp) / abs(lp)
    emit(phase="train_step_check", **record)
    require(all(within_bars(r) for r in bars["spread"]), "float32's own spread fails the bars")
    for fault, r in bars["faults"].items():
        require(not within_bars(r), f"planted fault {fault!r} passes the bars: {r}")
    for kind in ("plain", "blocked"):
        r = record[kind]
        require(r["loss_rel_err"] <= 1e-4, f"{kind} step: card vs CPU loss")
        require(max(r["card_vs_float64_worst"].values()) <= GRAD_RTOL_TENSOR,
                f"{kind} step: card gradients {r['card_vs_float64_worst']}")
        require(r["card_vs_float64_global"] <= GRAD_RTOL_GLOBAL,
                f"{kind} step: card gradients together {r['card_vs_float64_global']}")
    require(record["card_blocked_vs_plain_loss_rel_err"] <= 1e-5, "card: blocked vs plain loss")


def expected_train_launches(model, batch, ray_blocks: int = RAY_BLOCKS) -> dict:
    """Launches of one step with ``ray_blocks`` (0: unblocked), from the
    code: per level one warp and its backward; per rendered level one
    sampler launch per ray block, one more per block for the checkpoint's
    recomputation when the level has more than one block, and one backward
    per block."""
    from boostmvsnerfs_torch.parallel.train import level_ray_blocks

    cas = model.cas
    H, W = batch["all_src_inps"].shape[2:4]
    n_max = max(batch[f"ray_idx_{i}"].shape[1] for i in range(cas.num) if cas.render_if[i])
    out = dict(NO_LAUNCHES, warp_variance=cas.num, warp_variance_bwd=cas.num)
    for i in range(cas.num):
        if not cas.render_if[i]:
            continue
        H_r, W_r = int(H * cas.render_scale[i]), int(W * cas.render_scale[i])
        N = batch[f"ray_idx_{i}"].shape[1]
        nb = level_ray_blocks(max(ray_blocks, 1), N, n_max, H_r,
                              N == H_r * W_r and cas.train_img[i])
        out["img_sample"] += nb + (nb if nb > 1 else 0)
        out["img_sample_bwd"] += nb
    return out


def phase_train(model, batches: list, steps: int = 6):
    """The fine-tuning step at full width: launches per step (counts reset
    just before one step, read just after), the loss finite and the
    parameters moved, then step times over ``steps`` more steps cycling
    the batches (after 2 warm-up steps in all). Returns (launches, the
    train state, the step function)."""
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_blocked_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    state = create_train_state(model, make_optimizer(TRAIN_CFG, TRAIN_EP_ITER))
    step = make_blocked_train_step(model, RAY_BLOCKS)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    expect = expected_train_launches(model, batches[0])
    require(expect == dict(NO_LAUNCHES, warp_variance=2, warp_variance_bwd=2, img_sample=33,
                           img_sample_bwd=17), f"expected launches per step {expect}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = step(state, batches[0])
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(launches == expect, f"train: launches per step {launches}, expected {expect}")
    losses = [float(stats["loss"])]
    require(np.isfinite(losses[0]), f"train: loss {losses[0]}")
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in model.named_parameters())
    require(moved == len(before), f"train: {len(before) - moved} parameters did not change")
    step(state, batches[1])  # second warm-up step
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    stats_all = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (start, end) in enumerate(events):
        start.record()
        stats_all.append(step(state, batches[i % len(batches)]))
        end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses += [float(st["loss"]) for st in stats_all]
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    med = statistics.median(step_ms)
    emit(phase="train", geometry=list(TRAIN_HW), views=6, k_best=4, planes=[64, 8],
         samples=[8, 2], ray_blocks=RAY_BLOCKS, rays_per_step=TRAIN_RAYS,
         launches_per_step=launches, step_ms_median=med, step_ms_min=min(step_ms),
         step_ms_max=max(step_ms), host_wall_ms_per_step=wall * 1e3,
         rays_per_s=TRAIN_RAYS / (med / 1e3), peak_mem_gib=peak_gib, steps=steps,
         losses=losses, parameters_moved=moved)
    return launches, state, step


def run_train_path() -> list:
    """The third main path: the BoostENeRF fine-tuning step at 480x736.
    Returns its summary records."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    model = BoostENeRF(CascadeConfig(k_best=4))
    state = random_weights(model, 0)

    def make_batch(seed):
        return to_tensors(make_scene_batch(B=1, n_views=6, H=TRAIN_HW[0], W=TRAIN_HW[1],
                                           boost=True, k_best=4, seed=seed, rig="forward",
                                           with_targets=True), model.device)

    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        summary = phase_kernels_train(train_kernel_inputs(model, make_batch(0)))
    torch.cuda.empty_cache()
    phase_train_step_check(state)
    model.load_state_dict(state, strict=True)  # the kernel inputs moved the BN statistics
    batches = [make_batch(s) for s in (0, 1, 2)]
    launches, train_state, step = phase_train(model, batches)
    phase_profile(lambda: step(train_state, batches[0]), "profile_train",
                  ("warp_variance", "img_sample", "warp_variance_bwd", "img_sample_bwd"),
                  frames=1, unit="step")
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


# ------------------------------------ visualize, path and the training entry

PATH_FRAMES = 3
FINETUNE = "configs/exps/finetune/enerf_ours/free/base.yaml"
# the fine-tuning recipe, shortened only: one epoch of TRAIN_ENTRY_STEPS
# steps, with a log line, a checkpoint and a validation at its end
TRAIN_ENTRY_STEPS = 2
TRAIN_ENTRY_OPTS = ("train.epoch", "1", "ep_iter", str(TRAIN_ENTRY_STEPS), "eval_ep", "1",
                    "log_interval", "1", "save_ep", "1")
# The recipe's batch of 4 at 480x736 does not fit the card in JAX's
# unblocked step (scripts/torch_train_memory.py on the NVIDIA H100 80GB
# HBM3: out of memory with 74.9 GiB held, where batch 1 peaks at 19.3 GiB
# and batch 2 at 38.4; PERF.md, section 5): the entry takes the fewest ray
# blocks that fit.
TRAIN_ENTRY_RAY_BLOCKS = 2
TRAIN_CHECK_HW = (128, 192)
TRAIN_CHECK_STEPS = 2
# Card vs CPU port over ``run_train(cfg)``: the first step's loss
# (relative), and the parameters' change after TRAIN_CHECK_STEPS steps,
# relative L2 of all parameters together. Adam moves each parameter by
# about the learning rate whatever the size of its gradient, so where a
# gradient is small against its rounding (the U-Nets' convolutions on noise
# images) float32 alone flips the step's sign: on the CPU port at 64x96
# float32 against float64 reads 0.27 after two steps, and the control, a
# skipped last Adam step, 0.76 (tests/test_torch_chip_smoke_work.py). The
# first step's loss carries the tight bar (the second's, after one such
# update, read 3.9e-5 to 5.8e-5 on the H100, too near it: PERF.md, section
# 6); the change's bar lies between those readings.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_DELTA_RTOL = 0.5


def sync() -> None:
    """Wait for the card, where there is one (the CPU rehearsal has none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_calls(module, name: str, log: list, after=None):
    """Within the block each call of ``module.<name>`` appends its wall time
    (ms, device synchronised) and its kernel launches to ``log``, then
    calls ``after()``."""
    from boostmvsnerfs_torch.ops.cuda import launch_counts

    original = getattr(module, name)

    def wrapper(*args, **kw):
        sync()
        before, t0 = launch_counts(), time.perf_counter()
        out = original(*args, **kw)
        sync()
        log.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_delta(before)})
        if after is not None:
            after()
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, original)


def launch_delta(before: dict) -> dict:
    from boostmvsnerfs_torch.ops.cuda import launch_counts

    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def scaled(launches: dict, n: int) -> dict:
    return {k: n * v for k, v in launches.items()}


def added(*launches: dict) -> dict:
    return {k: sum(x.get(k, 0) for x in launches) for k in NO_LAUNCHES}


def free_scene(ws: str, H: int = 480, W: int = 736) -> None:
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    write_free_scene(os.path.join(ws, "Free"), "grass", EVAL_IMAGES, H, W, rig="varied")


def prepass_design(views: int, combos: int, k: int) -> dict:
    """The BoostENeRF pre-pass's launches over ``views`` target views:
    ceil(combos / k) chunks each, each chunk 2 warps (one per level)."""
    return {"warp_variance": views * math.ceil(combos / k) * 2}


ENERF_FRAME = {"warp_variance": 2, "img_sample": 1, "enerf_head": 1}


def phase_visualize(ws: str) -> None:
    """``python -m boostmvsnerfs_torch.run --type visualize`` over
    free_eval.yaml unchanged: the pre-pass, every test view through the
    model, the videos (or frames) written."""
    from boostmvsnerfs_torch import run as trun
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()
    out = trun.main(["--type", "visualize", "--cfg_file", FREE_EVAL, "workspace", ws,
                     "scene", "grass"])
    torch.cuda.synchronize()
    launches, views = launch_counts(), 2
    expect = added(prepass_design(views, 20, 4), scaled(ENERF_FRAME, views))
    emit(phase="visualize", config=FREE_EVAL, writer=out["writer"],
         files={os.path.relpath(f, ws): os.path.getsize(f) for f in out["files"]},
         frames=out["frames"], test_views=views, launches=launches, expected_launches=expect,
         seconds=time.perf_counter() - t0)
    require(launches == expect, f"visualize: launches {launches}, expected {expect}")
    require(out["frames"] == views and out["writer"] in ("imageio", "cv2", "png")
            and out["files"] and all(os.path.getsize(f) > 0 for f in out["files"]),
            f"visualize: {out}")


def phase_path(ws: str) -> list:
    """``runner.render_novel_path`` over free_eval.yaml unchanged:
    PATH_FRAMES interpolated frames, then one spiral frame; per frame the
    greedy selection (the pre-pass's chunks) and the forward, launches
    against the design; the kernels on the first frame's inputs; the
    first frame at TRAIN_CHECK_HW on the card against the CPU port.
    Returns the kernels' summary records."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = eval_cfg(FREE_EVAL, ws, "grass", "save_tag", "path")
    per_frame = added(prepass_design(1, 20, 4), ENERF_FRAME)
    runs = {}
    for path_type, n in (("interpolate", PATH_FRAMES), ("spiral", 1)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = runner.render_novel_path(cfg, n_frames=n, path_type=path_type)
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   files={os.path.relpath(f, ws): os.path.getsize(f) for f in out["files"]})
        runs[path_type] = out
        require(out["launches"] == scaled(per_frame, n),
                f"path ({path_type}): launches {out['launches']}, {per_frame} per frame")
        require(out["frames"] == n == len(out["per_frame"])
                and all(len(f["k_best"]) == 4 and all(0 <= i < 20 for i in f["k_best"])
                        for f in out["per_frame"]), f"path ({path_type}): {out}")

    model = runner.make_network(cfg)
    runner._init_or_load(cfg, model)
    np_batch = next(runner.novel_path_batches(cfg, make_dataset(cfg, "test"), PATH_FRAMES))
    np_batch["combos"] = combos = runner.view_combinations(6, 3)
    np_batch["k_best"] = runner.greedy_select(model, runner._device_batch(np_batch, "cuda"),
                                              combos, 4)
    require(np_batch["k_best"][0].tolist() == runs["interpolate"]["per_frame"][0]["k_best"],
            "path: the first frame's picks differ from the run's")
    with torch.no_grad():
        summary = phase_kernels({k: ENERF_KERNELS[k] for k in ENERF_FRAME},
                                main_path_kernel_inputs(model, runner._device_batch(np_batch,
                                                                                  "cuda")),
                                "path")
    del model
    torch.cuda.empty_cache()
    check = path_check(ws)
    emit(phase="path", config=FREE_EVAL, geometry=[480, 736], views=6, combinations=20, k_best=4,
         launches_per_frame=per_frame, runs=runs, check=check)
    for rec in summary.values():
        rec["launches"] = runs["interpolate"]["launches"][rec["name"]]
    return list(summary.values())


def path_check(ws: str) -> dict:
    """The path's middle frame at TRAIN_CHECK_HW on the card against the
    CPU port, the same weights (``check_selection``). Not the first: an
    interpolated path starts on a test view's camera, which is also one of
    its nearest source views, so the rays along the frame's border project
    onto that view's border, where the coverage masks step (ROADMAP fault
    4) and flip between two builds by rounding."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset

    hw = "[{}, {}]".format(*TRAIN_CHECK_HW)
    cfg = eval_cfg(FREE_EVAL, ws, "grass", "test_dataset.input_h_w", hw)
    models = {}
    for d in ("cuda", "cpu"):
        models[d] = runner.make_network(cfg, d)
        runner._init_or_load(cfg, models[d])
    frame = PATH_FRAMES // 2
    batches = runner.novel_path_batches(cfg, make_dataset(cfg, "test"), PATH_FRAMES)
    np_batch = next(itertools.islice(batches, frame, None))
    rep, psnr = check_selection(models, np_batch, cfg,
                                "warp_variance: the first view's features lost", render=True)
    require(psnr > 45.0, f"path: card vs CPU rgb PSNR {psnr} dB <= 45")
    return {"geometry": list(TRAIN_CHECK_HW), "frame": frame, **rep, "rgb_psnr_db": psnr}


def run_visualize_and_path() -> list:
    """Phases ``visualize``, ``path``, ``convert`` and ``gui`` on a Free
    scene of 16 images at 480x736 with seeded weights as ``latest.pt``."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws)
        save_seeded_weights(eval_cfg(FREE_EVAL, ws, "grass"))
        phase_visualize(ws)
        records = phase_path(ws)
        torch.cuda.empty_cache()
        cfg = phase_convert(ws)
        torch.cuda.empty_cache()
        return records + phase_gui(cfg)


# ------------------------------------------------ the converter and the viewer

# the reference MVSNeRF's InPlaceABN nets, whose blocks hold no num_batches_tracked
ABN_PREFIXES = ("feature.", "cost_reg_2.")
# the viewer's events, as its page posts them
GUI_EVENTS = ({"kind": "none"}, {"kind": "rotate", "dx": 30, "dy": -10, "orbit": False},
              {"kind": "pan", "dx": 20, "dy": 5}, {"kind": "zoom", "amount": 0.2},
              {"kind": "move", "forward": 0.1, "rightward": 0.05, "upward": 0.0},
              {"kind": "options", "out_type": "depth"}, {"kind": "play"})
# level 0 of a config that renders level 1 only: the server answers 500
GUI_LEVEL0 = {"kind": "options", "out_type": "pred", "level": 0}
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
FORWARD_TIMES = 5  # forwards of the first served frame's batch timed per cuDNN mode


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms within the block. By default
    two runs of one model on one batch differ on the H100 (ROADMAP fault 21:
    up to 25 uint8 levels on a path's first frame, 2 on its middle one, bit
    for bit equal with ``torch.backends.cudnn.deterministic``; PERF.md §6,
    PR 12), so checks that two runs render the same frame run under it."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def convert_cli(pth: str, out_dir: str, *flags) -> dict:
    """``python -m boostmvsnerfs_torch.convert_ckpt`` in a process of its
    own: its seconds and the entries it says it left out."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "boostmvsnerfs_torch.convert_ckpt", pth, out_dir,
                        *flags], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    require(r.returncode == 0, f"convert_ckpt {flags}: {r.stderr[-2000:]}")
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("left out "))
    left_out = line.split(": ", 1)[1].split(", ") if ": " in line else []
    return {"seconds": seconds, "left_out": left_out, "stdout": r.stdout.strip().splitlines()}


def phase_convert(ws: str):
    """The paper's ``.pth`` layout through the converter: the BoostENeRF
    weights of ``latest.pt`` as a reference ``{"net": state_dict}`` (no
    ``num_batches_tracked``, as the reference's InPlaceABN blocks hold none)
    and a v1 MVSNeRF one (InPlaceABN nets, tied ``pts_linears.1..5``), each
    converted by ``python -m boostmvsnerfs_torch.convert_ckpt``; the
    converted files equal to the weights; ``run_evaluate`` on the card from
    the converted BoostENeRF ``latest.pt`` (``exp_name_tag converted``)
    against the same weights saved directly, both rendering the direct
    run's view selection under ``deterministic_cudnn``: the psnr equal to
    the last bit. Returns the converted run's config."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, MVSNeRFConfig
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    direct = eval_cfg(FREE_EVAL, ws, "grass", "save_tag", "convert")
    conv = eval_cfg(FREE_EVAL, ws, "grass", "exp_name_tag", "converted")
    state = CheckpointManager(direct.trained_model_dir).restore()["model"]
    enerf_pth = os.path.join(ws, "boost_enerf.pth")
    torch.save({"net": {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")},
                "optim": {"lr": 5e-4}}, enerf_pth)
    runs = {"enerf": convert_cli(enerf_pth, conv.trained_model_dir)}

    v1 = random_weights(MVSNeRF(MVSNeRFConfig(net_type="v1"), device="cpu"), 0)
    ref = {k: v for k, v in v1.items()
           if not (k.startswith(ABN_PREFIXES) and k.endswith("num_batches_tracked"))}
    for i in range(2, 6):
        for leaf in ("weight", "bias"):
            ref[f"nerf.nerf.pts_linears.{i}.{leaf}"] = ref[f"nerf.nerf.pts_linears.1.{leaf}"]
    mvs_pth, mvs_dir = os.path.join(ws, "mvsnerf_v1.pth"), os.path.join(ws, "mvsnerf_v1")
    torch.save({"net": ref}, mvs_pth)
    runs["mvsnerf_v1"] = convert_cli(mvs_pth, mvs_dir, "--family", "mvsnerf")

    for name, (want, out_dir) in {"enerf": (state, conv.trained_model_dir),
                                  "mvsnerf_v1": ({**v1, **ref}, mvs_dir)}.items():
        got = CheckpointManager(out_dir).restore()["model"]
        require(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got),
                f"convert {name}: the converted weights differ from the checkpoint's")
        require(runs[name]["left_out"] == [], f"convert {name}: left out {runs[name]}")

    with deterministic_cudnn():
        t0 = time.perf_counter()
        ret_direct = runner.run_evaluate(direct)
        t1 = time.perf_counter()
        os.makedirs(conv.result_dir, exist_ok=True)
        shutil.copy(runner.view_selection_path(direct), runner.view_selection_path(conv))
        ret_conv = runner.run_evaluate(conv)
        t2 = time.perf_counter()
    emit(phase="convert", config=FREE_EVAL, conversions=runs,
         psnr_direct=ret_direct["psnr"], psnr_converted=ret_conv["psnr"],
         ssim_direct=ret_direct["ssim"], ssim_converted=ret_conv["ssim"],
         eval_seconds_direct=t1 - t0, eval_seconds_converted=t2 - t1,
         frame_ms_converted=ret_conv["frame_ms"], phase_seconds=time.perf_counter() - t_phase)
    require(math.isfinite(ret_conv["psnr"]) and ret_conv["psnr"] == ret_direct["psnr"],
            f"convert: psnr {ret_conv['psnr']} from the converted weights, "
            f"{ret_direct['psnr']} from the same weights saved directly")
    return conv


def gui_request(url: str, ev: dict | None = None) -> tuple:
    """(status, content type, body, ms) of ``GET url`` or, with ``ev``,
    ``POST url/event``."""
    import urllib.error
    import urllib.request

    req = (urllib.request.Request(url) if ev is None else
           urllib.request.Request(url + "/event", data=json.dumps(ev).encode(), method="POST"))
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, ctype, body = r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        status, ctype, body = e.code, e.headers.get("Content-Type"), e.read()
    return status, ctype, body, (time.perf_counter() - t0) * 1e3


def serve_events(state, url: str, per_frame: dict) -> tuple[list, dict]:
    """Each of GUI_EVENTS and GUI_LEVEL0 posted to the viewer: per served
    frame its JPEG (decoded: the frame's size), launches (counts reset just
    before the request, read just after), the render function's times, the
    encode's and the peak memory. Returns (the frames, their launches in
    all)."""
    import cv2

    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    H, W = state.options.window_hw
    frames, total = [], dict(NO_LAUNCHES)
    for ev in (*GUI_EVENTS, GUI_LEVEL0):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        status, ctype, body, ms = gui_request(url, ev)
        torch.cuda.synchronize()
        launches = launch_counts()
        total = {k: total[k] + launches[k] for k in total}
        rec = {"event": ev, "status": status, "request_ms": ms, "launches": launches,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if ev is GUI_LEVEL0:
            rec["body"] = body.decode(errors="replace")
            frames.append(rec)
            require(status == 500 and "rgb_level0" in rec["body"],
                    f"gui: level 0 of a level-1 config answered {status} {rec['body']!r}")
            continue
        img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        rec.update(jpeg_bytes=len(body), **state.frame_times[-1])
        frames.append(rec)
        require(status == 200 and ctype == "image/jpeg" and img is not None
                and img.shape == (H, W, 3), f"gui: {ev} answered {status} {ctype}")
        require(launches == {**NO_LAUNCHES, **per_frame},
                f"gui: {ev}: launches {launches}, expected {per_frame} per served frame")
    return frames, total


def phase_gui(cfg) -> list:
    """The viewer (``interactive/server.py``) on the card from the converted
    checkpoint: ``build_render_fn(cfg)``, served by ``make_server`` on
    127.0.0.1 port 0 in a thread and driven over HTTP (the page, ``/meta``,
    GUI_EVENTS: a JPEG of the frame's size each, launches per served frame
    against the path frame's design; GUI_LEVEL0 answers 500); the kernels
    on the first served frame's inputs; the forward of that frame's batch
    timed and rerun under cuDNN's default algorithms and under
    ``deterministic_cudnn`` (fault 21); ``render_fn`` at the first two
    poses of a PATH_FRAMES-frame path against ``render_novel_path``'s
    frames, both under ``deterministic_cudnn`` (1 uint8 level, the same
    picks); the middle pose at
    TRAIN_CHECK_HW on the card against the CPU port (``check_selection``;
    not the first pose, on a test view's camera, for the reason
    ``path_check`` gives). Returns the kernels' summary records, with the
    served requests' launches."""
    import threading

    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.eval.visualizer import Visualizer
    from boostmvsnerfs_torch.interactive.camera import RenderOptions
    from boostmvsnerfs_torch.interactive.server import ViewerState, build_render_fn, make_server
    from boostmvsnerfs_torch.utils.camera_paths import interpolate_path

    t_phase = time.perf_counter()
    per_frame = added(prepass_design(1, 20, 4), ENERF_FRAME)
    t0 = time.perf_counter()
    render_fn, camera, options = build_render_fn(cfg)
    build_s = time.perf_counter() - t0
    batches = []
    hook = render_fn.model.register_forward_pre_hook(
        lambda m, args: batches.append(args[0]) if not batches else None)
    state = ViewerState(render_fn, camera, options)
    server = make_server(state, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = gui_request(url + "/")
        meta = gui_request(url + "/meta")
        require(page[0] == 200 and page[1] == "text/html" and b"/event" in page[2],
                f"gui: the page answered {page[:2]}")
        meta_json = json.loads(meta[2])
        require(meta[0] == 200 and meta_json["window_hw"] == list(cfg.test_dataset.input_h_w)
                and meta_json["has_path"],
                f"gui: /meta {meta_json}")
        frames, total = serve_events(state, url, per_frame)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        hook.remove()

    with torch.no_grad():
        summary = phase_kernels({k: ENERF_KERNELS[k] for k in ENERF_FRAME},
                                main_path_kernel_inputs(render_fn.model, batches[0]), "gui")
        reruns = {}
        for mode in ("default", "deterministic", "default", "deterministic"):
            with deterministic_cudnn() if mode == "deterministic" else contextlib.nullcontext():
                rgb = [render_fn.model(batches[0])["rgb_level1"] for _ in range(2)]
                reruns.setdefault(mode, {"rerun_max_abs_diff": [], "forward_ms": []})
                reruns[mode]["rerun_max_abs_diff"].append(float((rgb[0] - rgb[1]).abs().max()))
                reruns[mode]["forward_ms"].append(
                    median_ms(lambda: render_fn.model(batches[0]), FORWARD_TIMES, warmup=1))
    del batches, rgb
    require(max(reruns["deterministic"]["rerun_max_abs_diff"]) == 0.0,
            f"gui: deterministic cuDNN reruns differ {reruns}")

    seen = []
    original = Visualizer.visualize

    def visualize(self, output, batch):
        original(self, output, batch)
        seen.append((self.color_frames[-1], np.asarray(batch["k_best"])[0].tolist()))

    Visualizer.visualize = visualize
    anchors = runner.path_anchors(make_dataset(cfg, "test"))[1]
    poses = interpolate_path(anchors, PATH_FRAMES)
    vs_path = []
    try:
        with deterministic_cudnn():
            runner.render_novel_path(cfg, n_frames=PATH_FRAMES)
            for i in range(2):
                frame = render_fn(poses[i], RenderOptions(window_hw=options.window_hw))
                diff = np.abs(frame.astype(np.int64) - seen[i][0])
                vs_path.append({"frame": i, "max_uint8_diff": int(diff.max()),
                                "pixels_over_0": int((diff.max(-1) > 0).sum()),
                                "k_best": render_fn.stats["k_best"], "path_k_best": seen[i][1]})
                require(int(diff.max()) <= 1 and render_fn.stats["k_best"] == seen[i][1],
                        f"gui: frame {i} against render_novel_path's {vs_path[-1]}")
    finally:
        Visualizer.visualize = original
    del render_fn, state
    torch.cuda.empty_cache()

    hw = "[{}, {}]".format(*TRAIN_CHECK_HW)
    small = eval_cfg(FREE_EVAL, cfg.workspace, "grass", "exp_name_tag", "converted",
                     "test_dataset.input_h_w", hw)
    models = {}
    for d in ("cuda", "cpu"):
        models[d] = runner.make_network(small, d)
        runner._init_or_load(small, models[d])
    dataset = make_dataset(small, "test")
    scene = runner.path_anchors(dataset)[0]
    np_batch = runner.pose_batch(small, dataset, scene, poses[PATH_FRAMES // 2])
    rep, psnr = check_selection(models, np_batch, small,
                                "warp_variance: the first view's features lost", render=True)
    served = [f for f in frames if f["status"] == 200]
    emit(phase="gui", config=FREE_EVAL, weights=cfg.trained_model_dir,
         geometry=list(cfg.test_dataset.input_h_w),
         views=6, combinations=20, k_best=4, build_seconds=build_s, page_ms=page[3],
         meta_ms=meta[3], meta=meta_json, launches_per_frame=per_frame, frames=frames,
         batch_ms=[f["batch_ms"] for f in served], select_ms=[f["select_ms"] for f in served],
         forward_ms=[f["forward_ms"] for f in served],
         encode_ms=[f["encode_ms"] for f in served],
         peak_mem_gib_max=max(f["peak_mem_gib"] for f in served), cudnn_modes=reruns,
         vs_novel_path=vs_path,
         check={"geometry": list(TRAIN_CHECK_HW), "frame": PATH_FRAMES // 2, **rep,
                "rgb_psnr_db": psnr},
         phase_seconds=time.perf_counter() - t_phase)
    require(psnr > 45.0, f"gui: card vs CPU rgb PSNR {psnr} dB <= 45")
    for rec in summary.values():
        rec["launches"] = total[rec["name"]]
    return list(summary.values())


def train_entry_cfg(ws: str, *opts):
    from boostmvsnerfs_torch.config import make_cfg

    return make_cfg(FINETUNE, ["workspace", ws, "scene", "grass", *TRAIN_ENTRY_OPTS, *opts])


def save_pretrain(cfg) -> dict:
    """Seeded random weights (``random_weights``) as the ``pretrain``
    checkpoint the recipe warm-starts from (``enerf`` or ``mvsnerf``);
    returns them."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    weights = random_weights(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(os.path.join(cfg.workspace, "trained_model", "pretrain", cfg.pretrain)).save(
        {"model": weights}, 0)
    return weights


def drive_train_entry(cfg, ray_blocks: int, device=None) -> dict:
    """``run_train(cfg)`` on the card (or ``device``): per logged step its
    wall time (from the previous record, or from the end of the pre-pass;
    the stats' float conversion synchronises), its launches and stats; the
    validation records; the pre-pass's and each validation's time and
    launches; the launches and the peak memory (on the card) of the whole
    run."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    steps, vals, prepass, validations = [], [], [], []
    mark = {}

    def restart():
        mark.update(t=time.perf_counter(), launches=launch_counts())

    def on_record(kind, state, r):
        if kind == "train":
            steps.append({"ms": (time.perf_counter() - mark["t"]) * 1e3,
                          "launches": launch_delta(mark["launches"]), "step": state.step, **r})
        else:
            vals.append(r)
        restart()

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    restart()
    t0 = time.perf_counter()
    with timed_calls(runner, "run_view_selection", prepass, restart), \
            timed_calls(runner, "run_evaluate", validations):
        state = runner.run_train(cfg, device=device, ray_blocks=ray_blocks, on_record=on_record)
    sync()
    return {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
            "final_step": state.step, "steps": steps, "val": vals, "prepass": prepass,
            "validations": validations}


def step_summary(run: dict) -> dict:
    ms = [s["ms"] for s in run["steps"]]
    return {"step_ms": ms, "step_ms_median_after_first": statistics.median(ms[1:]),
            "step_ms_min_after_first": min(ms[1:]), "step_ms_max_after_first": max(ms[1:]),
            "losses": [{k: v for k, v in s.items() if k not in ("ms", "launches")}
                       for s in run["steps"]]}


def phase_train_entry(ws: str) -> list:
    """``run_train(cfg)`` over the fine-tuning recipe (module docstring,
    item 10): the first run (pre-pass, TRAIN_ENTRY_STEPS steps, a
    checkpoint, a validation), its launches against the design, the resumed run, the
    kernels on the first batch, the bf16 convolutions, the card against the
    CPU port. Returns the kernels' summary records, with the first run's
    launches."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    cfg = train_entry_cfg(ws)
    pretrain = save_pretrain(cfg)
    first = drive_train_entry(cfg, TRAIN_ENTRY_RAY_BLOCKS)
    resumed = drive_train_entry(train_entry_cfg(ws, "train.epoch", "2"), TRAIN_ENTRY_RAY_BLOCKS)

    vs = runner.load_view_selection(cfg)
    model = runner.make_network(cfg)
    model.load_state_dict(pretrain, strict=True)
    batch = first_train_batch(cfg, vs, "cuda")
    design = train_entry_design(model, batch, TRAIN_ENTRY_RAY_BLOCKS, steps=TRAIN_ENTRY_STEPS)
    record = {"config": FINETUNE, "overrides": list(TRAIN_ENTRY_OPTS), "geometry": [480, 736],
              "batch": int(batch["all_src_inps"].shape[0]),
              "views": int(batch["all_src_inps"].shape[1]), "k_best": 4,
              "ray_blocks": TRAIN_ENTRY_RAY_BLOCKS, "design": design}
    for name, run, epoch in (("first", first, 0), ("resumed", resumed, 1)):
        record[name] = {**{k: run[k] for k in ("seconds", "launches", "peak_mem_gib",
                                               "final_step", "val", "prepass", "validations")},
                        **step_summary(run),
                        "launches_per_step": [s["launches"] for s in run["steps"]]}
        check_train_entry_run(name, run, design, epoch, steps=TRAIN_ENTRY_STEPS)
    require(first["final_step"] == TRAIN_ENTRY_STEPS
            and resumed["final_step"] == 2 * TRAIN_ENTRY_STEPS, "train_entry: resume")
    require(CheckpointManager(cfg.trained_model_dir).numbered_epochs() == [0, 1],
            "train_entry: checkpoints")
    with torch.no_grad():
        summary = phase_kernels_train(
            train_kernel_inputs(model, batch, ray_blocks=TRAIN_ENTRY_RAY_BLOCKS),
            "kernels_train_entry", "train_entry")
    del model, batch
    torch.cuda.empty_cache()
    record["bf16_conv"] = bf16_conv_check(ws, vs)
    record["check"] = train_check(ws)
    emit(phase="train_entry", **record)
    for rec in summary.values():
        rec["launches"] = first["launches"][rec["name"]]
    return list(summary.values())


def first_train_batch(cfg, view_selection, device):
    """The training entry's first batch (``runner.train_loader``, epoch 0)
    with its k_best attached, on ``device``."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset

    loader = runner.train_loader(cfg, make_dataset(cfg, "train"))
    loader.set_epoch(0)
    np_batch = runner.attach_boost_inputs(next(iter(loader)), view_selection, cfg)
    return runner._device_batch(np_batch, device)


def train_entry_design(model, batch, ray_blocks: int, steps: int,
                       train_views: int = EVAL_IMAGES - 2, test_views: int = 2) -> dict:
    """Launches of the training entry by design: per step
    (``expected_train_launches``), the pre-pass over the train views (the
    batch's view count, C(views, 3) combinations) and the test views (20),
    a validation (a frame per test view, each rendering the levels of
    ``render_if``: the recipe trains and validates both), and the whole
    first run (the pre-pass, ``steps`` steps, a validation) and the resumed
    run (no pre-pass)."""
    cas = model.cas
    step = expected_train_launches(model, batch, ray_blocks)
    n_views = int(batch["all_src_inps"].shape[1])
    prepass = added(prepass_design(train_views, math.comb(n_views, 3), cas.k_best),
                    prepass_design(test_views, 20, cas.k_best))
    rendered = sum(cas.render_if[: cas.num])
    validation = added(scaled({"warp_variance": cas.num, "img_sample": rendered,
                               "enerf_head": rendered}, test_views))
    return {"step": step, "prepass": prepass, "validation": validation,
            "first": added(prepass, scaled(step, steps), validation),
            "resumed": added(scaled(step, steps), validation)}


def check_train_entry_run(name: str, run: dict, design: dict, epoch: int, steps: int,
                          prepass: bool = True) -> None:
    """A ``drive_train_entry`` run against the design: its launches, each
    step's, ``steps`` steps of epoch ``epoch`` with finite losses, one
    validation with a finite ``val_psnr``, the pre-pass (of a boost recipe,
    ``prepass``) in the first run only."""
    require(run["launches"] == design[name],
            f"train_entry ({name}): launches {run['launches']}, expected {design[name]}")
    require(len(run["steps"]) == steps and all(s["epoch"] == epoch for s in run["steps"])
            and all(s["launches"] == design["step"] for s in run["steps"]),
            f"train_entry ({name}): steps {run['steps']}")
    require(all(math.isfinite(s["loss"]) for s in run["steps"]), f"train_entry ({name}): loss")
    require(len(run["val"]) == 1 and math.isfinite(run["val"][0]["val_psnr"]),
            f"train_entry ({name}): validation {run['val']}")
    want = [design["prepass"]] if prepass and name == "first" else []
    require([p["launches"] for p in run["prepass"]] == want,
            f"train_entry ({name}): pre-pass {run['prepass']}")
    require([v["launches"] for v in run["validations"]] == [design["validation"]],
            f"train_entry ({name}): validation launches {run['validations']}")


def run_train_entry() -> list:
    """Phase ``train_entry`` on a Free scene of 16 images at 480x736 with
    seeded pretrain weights."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws)
        return phase_train_entry(ws)


def bf16_conv_check(ws: str, vs: dict) -> dict:
    """The first validation frame with the trained weights, the convolutions
    at ``conv_dtype`` bfloat16 against float32: the rgb mean absolute
    difference under 0.05 (JAX's bar, tests/test_mixed_precision.py), and
    forward hooks on the batch norms seeing bf16 inputs (the convolutions'
    outputs) in the bf16 model and float32 ones in the other."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    cfg = train_entry_cfg(ws)
    weights = CheckpointManager(cfg.trained_model_dir).restore()["model"]
    batch = first_test_batch(cfg, vs, "cuda")
    rgb, seen = {}, {}
    for dtype in ("float32", "bfloat16"):
        model = runner.make_network(train_entry_cfg(ws, "enerf.cas_config.conv_dtype", dtype))
        model.load_state_dict(weights, strict=True)
        seen[dtype] = set()
        hook = lambda m, inp, out, d=dtype: seen[d].add(str(inp[0].dtype))  # noqa: E731
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.register_forward_hook(hook)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb[dtype] = model(batch)["rgb_level1"].cpu().numpy()
        torch.cuda.synchronize()
        seen[f"{dtype}_frame_ms"] = (time.perf_counter() - t0) * 1e3
    diff = float(np.abs(rgb["bfloat16"] - rgb["float32"]).mean())
    out = {"rgb_mean_abs_diff": diff, "psnr_db": psnr_db(rgb["bfloat16"], rgb["float32"]),
           "batch_norm_inputs": {k: sorted(v) if isinstance(v, set) else v
                                 for k, v in seen.items()}}
    require(diff < 0.05, f"bf16 convolutions: rgb mean difference {diff}")
    require(seen["bfloat16"] == {"torch.bfloat16"} and seen["float32"] == {"torch.float32"},
            f"bf16 convolutions: batch norm inputs {seen}")
    return out


def train_readings(losses, ref_losses, delta: dict, ref_delta: dict) -> dict:
    """The first step's loss against the reference's (relative error: both
    runs start from the same weights, so it differs by float32's rounding
    of one forward alone; a later step's follows an Adam update in which
    that rounding flips the sign of the smallest gradients, and is
    reported, not held), and the parameters' change (relative L2 of all
    together)."""
    num = math.sqrt(sum(float(((delta[k] - v) ** 2).sum()) for k, v in ref_delta.items()))
    den = math.sqrt(sum(float((v ** 2).sum()) for v in ref_delta.values()))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {"loss_rel_err": rel[0], "later_loss_rel_err": rel[1:], "delta_rel_l2": num / den}


def within_train_bars(r: dict) -> bool:
    return r["loss_rel_err"] <= TRAIN_LOSS_RTOL and r["delta_rel_l2"] <= TRAIN_DELTA_RTOL


def param_delta(params: dict, start: dict) -> dict:
    return {k: params[k].double().cpu() - start[k].double() for k in start}


def train_check(ws: str, cfg_fn=None) -> dict:
    """``run_train(cfg)`` at TRAIN_CHECK_HW for TRAIN_CHECK_STEPS steps
    (unblocked, no validation) on the card and on the CPU port from the same
    pretrain weights (the CPU run reads the card run's view selection):
    the losses and the parameters' change (the saved checkpoint minus the
    pretrain weights) within the TRAIN_* bars; the control, the CPU port
    with its last Adam step skipped, must fail them. ``cfg_fn(ws, *opts)``
    makes the recipe's config (default ``train_entry_cfg``)."""
    recipe_cfg = cfg_fn or train_entry_cfg
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    hw = "[{}, {}]".format(*TRAIN_CHECK_HW)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as small:
        free_scene(small, *TRAIN_CHECK_HW)
        opts = ("train_dataset.input_h_w", hw, "test_dataset.input_h_w", hw, "ep_iter",
                str(TRAIN_CHECK_STEPS), "eval_ep", "0")
        pretrain = save_pretrain(recipe_cfg(small, *opts))
        names = [k for k, _ in runner.make_network(recipe_cfg(small, *opts),
                                                   "cpu").named_parameters()]
        start = {k: pretrain[k] for k in names}
        runs = {}
        for d in ("cuda", "cpu"):
            cfg = recipe_cfg(small, *opts, "exp_name_tag", f"check_{d}")
            if d == "cpu" and runner.requires_view_selection(cfg):
                os.makedirs(cfg.result_dir, exist_ok=True)
                shutil.copy(runner.view_selection_path(runs["cuda"]["cfg"]),
                            runner.view_selection_path(cfg))
            losses, snaps = [], []

            def on_record(kind, state, r, losses=losses, snaps=snaps):
                losses.append(r["loss"])
                snaps.append({k: p.detach().cpu().clone()
                              for k, p in state.model.named_parameters()})

            t0 = time.perf_counter()
            runner.run_train(cfg, device=d, on_record=on_record)
            saved = CheckpointManager(cfg.trained_model_dir).restore()["model"]
            runs[d] = {"cfg": cfg, "losses": losses, "snaps": snaps,
                       "seconds": time.perf_counter() - t0, "delta": param_delta(saved, start)}
    card, cpu = runs["cuda"], runs["cpu"]
    reading = train_readings(card["losses"], cpu["losses"], card["delta"], cpu["delta"])
    control = train_readings(card["losses"], cpu["losses"], card["delta"],
                             param_delta(cpu["snaps"][-2], start))
    out = {"geometry": list(TRAIN_CHECK_HW), "steps": TRAIN_CHECK_STEPS,
           "losses_card": card["losses"], "losses_cpu": cpu["losses"], "reading": reading,
           "control_last_step_skipped": control,
           "bars": {"loss": TRAIN_LOSS_RTOL, "delta": TRAIN_DELTA_RTOL},
           "seconds": {d: r["seconds"] for d, r in runs.items()}}
    require(within_train_bars(reading), f"train entry: card vs CPU {out}")
    require(not within_train_bars(control), f"train entry: the control passes {out}")
    return out


# ------------------------------- the MVSNeRF heads and MVSNeRF training

MVS_HEADS = ("v1", "v2", "color_fusion")
HEAD_FRAMES = 3  # timed frames of each head (0.2-0.4 s each on the card)
MVS_FINETUNE = "configs/exps/finetune/mvsnerf_ours/free/base.yaml"
MVS_PLAIN_FINETUNE = "configs/exps/finetune/mvsnerf/free/base.yaml"
MVS_PLAIN_HW = (512, 512)  # configs/exps/evaluate/mvsnerf/free_eval.yaml
MVS_STEP_RAYS = 1024  # the recipes' num_rays (train_img false)


def run_mvsnerf_heads() -> list:
    """Phase ``mvsnerf_heads``: BoostMVSNeRF at the second main path's
    workload with each other renderer head (MVS_HEADS): the lookups
    against their plain versions at the first head's frame, then per head
    the reduced frame against the CPU port and ``phase_main``'s launches
    (#6 and #3 once, #8 never: these heads' MLPs run plainly), frame times
    and peak memory. Returns the lookups' summary records."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    H, W = MVS_HW
    summary, launches = None, None
    for net_type in MVS_HEADS:
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=len(MVS_K_BEST), net_type=net_type))
        state = random_weights(model, 0)
        model.load_state_dict(state, strict=True)

        def make_batch(seed):
            batch = make_scene_batch(B=1, n_views=6, H=H, W=W, boost=True, seed=seed,
                                     rig="forward", render_scales=(1.0,))
            return to_tensors(mvsnerf_batch(batch, k_best=MVS_K_BEST), model.device)

        if summary is None:
            with torch.no_grad():
                inputs = mvs_kernel_inputs(model, make_batch(0))
                summary = phase_kernels({k: MVS_KERNELS[k] for k in ("tri_sample", "img_sample")},
                                        inputs, "mvsnerf_heads")
            del inputs
            torch.cuda.empty_cache()
        phase_frame_mvsnerf(state, net_type, "frame_mvsnerf_heads")
        # color_fusion sums one sigmoid colour per view of a combination
        rgb_max = 3.0 if net_type == "color_fusion" else 1.0
        got = phase_main(model, [make_batch(s) for s in (0, 1, 2)], "mvsnerf_heads",
                         {"tri_sample": 1, "img_sample": 1}, "rgb_level0", H * W, rgb_max,
                         frames=HEAD_FRAMES, net_type=net_type, geometry=[H, W], views=6,
                         k_best=list(MVS_K_BEST), samples=model.cfg.num_samples)
        launches = launches or got
        del model
        torch.cuda.empty_cache()
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def mvs_entry_cfg(ws: str, *opts, cfg_file: str = MVS_FINETUNE):
    """The MVSNeRF fine-tuning recipe, shortened only (TRAIN_ENTRY_OPTS)."""
    from boostmvsnerfs_torch.config import make_cfg

    return make_cfg(cfg_file, ["workspace", ws, "scene", "grass", *TRAIN_ENTRY_OPTS, *opts])


def mvs_entry_design(steps: int, test_views: int = 2, blocks: int = 1) -> dict:
    """Launches of the MVSNeRF training entry by design: a step launches
    only the colour lookup (#3; the volume lookup and the MLP run plainly
    under autograd), the pre-pass none (geometry), a validation frame
    MVS_FRAME per row block (``blocks``, ``mvs_row_blocks``) and test
    view."""
    step = added({"img_sample": 1})
    validation = added(scaled(MVS_FRAME, test_views * blocks))
    return {"step": step, "prepass": added(), "validation": validation,
            "first": added(scaled(step, steps), validation),
            "resumed": added(scaled(step, steps), validation)}


def mvs_step_inputs(cfg, weights: dict, batch: dict, device=None) -> dict:
    """The colour lookup's inputs in the recipe's step (train mode), from
    the model's own stages: {'img_sample': [(label, args)]}."""
    from boostmvsnerfs_torch import runner

    model = runner.make_network(cfg, device)
    model.load_state_dict(weights, strict=True)
    model.train()
    with torch.no_grad():
        calls, _, _, _ = mvs_stages(model, batch)
    return {"img_sample": [("step", calls["img_sample"])]}


def run_train_entry_mvsnerf() -> list:
    """Phases ``train_entry_mvsnerf``, ``train_step_check_mvsnerf`` and
    ``profile_train_mvsnerf`` (module docstring, item 12). Returns the
    kernels' summary records."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws)
        records, profile_inputs = phase_train_entry_mvsnerf(ws)
        torch.cuda.empty_cache()
        phase_train_step_check_mvsnerf()
        torch.cuda.empty_cache()
        phase_profile_train_mvsnerf(*profile_inputs)
    return records


def phase_train_entry_mvsnerf(ws: str):
    """``run_train(cfg)`` over the BoostMVSNeRF fine-tuning recipe
    (MVS_FINETUNE), shortened only, on a Free scene at 480x736: the first
    run (pre-pass, TRAIN_ENTRY_STEPS steps, a checkpoint, a validation)
    and the resumed run against ``mvs_entry_design``; the kernels on the first batch (the
    step's colour lookup) and the first test batch (the validation frame's
    three kernels); then the plain MVSNeRF recipe at 512x512 for 2 steps
    and a validation. Returns (the kernels' summary records with the
    runs' launches, the profile's inputs)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    t_phase = time.perf_counter()
    cfg = mvs_entry_cfg(ws)
    pretrain = save_pretrain(cfg)
    first = drive_train_entry(cfg, 0)
    resumed = drive_train_entry(mvs_entry_cfg(ws, "train.epoch", "2"), 0)
    design = mvs_entry_design(steps=TRAIN_ENTRY_STEPS, blocks=mvs_row_blocks(TRAIN_HW[0]))
    for name, run, epoch in (("first", first, 0), ("resumed", resumed, 1)):
        check_train_entry_run(name, run, design, epoch, steps=TRAIN_ENTRY_STEPS)
    require(first["final_step"] == TRAIN_ENTRY_STEPS
            and resumed["final_step"] == 2 * TRAIN_ENTRY_STEPS, "train_entry_mvsnerf: resume")
    require(CheckpointManager(cfg.trained_model_dir).numbered_epochs() == [0, 1],
            "train_entry_mvsnerf: checkpoints")
    vs = runner.load_view_selection(cfg)
    require(len(vs) == EVAL_IMAGES, f"train_entry_mvsnerf: view selection {vs}")
    batch = first_train_batch(cfg, vs, "cuda")
    require(tuple(batch["ray_idx_0"].shape) == (4, MVS_STEP_RAYS)
            and tuple(batch["all_src_inps"].shape[:2]) == (4, 3),
            f"train_entry_mvsnerf: batch {tuple(batch['ray_idx_0'].shape)}")
    record = {"config": MVS_FINETUNE, "overrides": list(TRAIN_ENTRY_OPTS), "geometry": [480, 736],
              "batch": 4, "views": 3, "k_best": 4, "rays_per_image": MVS_STEP_RAYS,
              "samples": int(cfg.enerf.cas_config.num_samples[0]), "design": design}
    for name, run in (("first", first), ("resumed", resumed)):
        record[name] = {**{k: run[k] for k in ("seconds", "launches", "peak_mem_gib",
                                               "final_step", "val", "prepass", "validations")},
                        **step_summary(run)}
    with torch.no_grad():
        step = phase_kernels({"img_sample": MVS_KERNELS["img_sample"]},
                             mvs_step_inputs(cfg, pretrain, batch), "train_entry_mvsnerf/step")
        model = runner.make_network(cfg)
        model.load_state_dict(pretrain, strict=True)
        val_batch = first_test_batch(cfg, vs, "cuda")
        val = phase_kernels({k: MVS_KERNELS[k] for k in MVS_FRAME},
                            mvs_kernel_inputs(model, val_batch), "train_entry_mvsnerf/validation")
    del model, val_batch
    torch.cuda.empty_cache()
    for part, table in (("steps", step), ("validations", val)):
        for rec in table.values():
            rec["launches"] = sum(x["launches"][rec["name"]] for run in (first, resumed)
                                  for x in run[part])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as plain_ws:
        write_free_scene(os.path.join(plain_ws, "Free"), "grass", EVAL_IMAGES, *MVS_PLAIN_HW,
                         rig="varied")
        plain_cfg = mvs_entry_cfg(plain_ws, "ep_iter", "2", cfg_file=MVS_PLAIN_FINETUNE)
        save_pretrain(plain_cfg)
        plain = drive_train_entry(plain_cfg, 0)
        check_train_entry_run("first", plain,
                              mvs_entry_design(steps=2, blocks=mvs_row_blocks(MVS_PLAIN_HW[0])),
                              0, steps=2,
                              prepass=False)
    record["plain"] = {"config": MVS_PLAIN_FINETUNE, "geometry": list(MVS_PLAIN_HW),
                       **{k: plain[k] for k in ("seconds", "launches", "peak_mem_gib",
                                                "final_step", "val", "validations")},
                       **step_summary(plain)}
    record["phase_seconds"] = time.perf_counter() - t_phase
    emit(phase="train_entry_mvsnerf", **record)
    return [*step.values(), *val.values()], (cfg, pretrain, batch)


def mvs_step_batch(H: int, W: int, seed: int) -> dict:
    """``smooth_scene_batch`` completed for BoostMVSNeRF (K=2 of C(4,3):
    combinations 0 and 3), with the recipe's MVS_STEP_RAYS random rays and
    seeded target colours."""
    from boostmvsnerfs_torch.utils.synthetic import mvsnerf_batch

    b = mvsnerf_batch(smooth_scene_batch(H, W, seed), k_best=(0, 3))
    rng = np.random.default_rng(seed)
    b["ray_idx_0"] = np.sort(rng.choice(H * W, MVS_STEP_RAYS, replace=False))[None].astype(np.int32)
    b["rgb_0"] = rng.uniform(0, 1, (1, MVS_STEP_RAYS, 3)).astype(np.float32)
    return {k: v for k, v in b.items() if not k.endswith("_1")}


def mvs_recipe_cas():
    """The recipe's loss settings (its ``enerf.cas_config``)."""
    from boostmvsnerfs_torch.config import make_cfg
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    return CascadeConfig.from_cfg(make_cfg(MVS_FINETUNE).enerf)


def mvs_step_grads(state: dict, batch: dict, device: str, dtype) -> tuple:
    """One Adam step of BoostMVSNeRF (K=2, the recipe's 8 samples) from
    ``state`` with the recipe's loss settings: (loss, gradients as float64
    CPU tensors, a parameter without one reading 0)."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8), device=device).to(dtype)
    model.load_state_dict(state, strict=True)
    train_state = create_train_state(model, make_optimizer(TRAIN_CFG, TRAIN_EP_ITER))
    loss = float(make_train_step(model, cas=mvs_recipe_cas())(train_state, batch)["loss"])
    return loss, {k: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                  for k, p in model.named_parameters()}


def _detached_first(fn):
    return lambda vol, *args, **kw: fn(vol.detach(), *args, **kw)


def _pts_bias_detached(fn):
    return lambda params, *args, **kw: fn(
        {**params, "pts_bias": tuple(t.detach() for t in params["pts_bias"])}, *args, **kw)


# The BoostMVSNeRF step's gradient bars (per tensor, all together; as
# GRAD_RTOL_*). Its train-mode BatchNorms reduce over the volume's ~10^5-
# 10^6 voxels per channel, and so do the convolutions' weight gradients, so
# float32 reads as far from float64 as its sums' order allows: on the CPU
# port at 128x192 (seeded weights 0-2) 0.008-0.020 per tensor and
# 0.0035-0.0046 together at 8 threads, 0.024-0.043 and 0.005-0.010 at 4,
# and 0.06-0.27 and 0.02-0.09 at one thread, which sums each reduction in
# one sequence (the card's reductions are trees). The faults of MVS_FAULTS
# read at least 1.0 per tensor and 0.11 together. The bars lie between the
# spread at 4 or more threads and the faults, and every run checks both
# sides at the machine's thread count.
MVS_GRAD_BARS = (0.1, 0.025)
# Faults planted into the CPU port's BoostMVSNeRF step (as PLANTED_FAULTS):
# a volume lookup cut from the graph (the U-Net and the feature net lose
# their gradients), the MLP's pts_bias without a gradient, and a colour
# lookup that loses one view.
MVS_FAULTS = {
    "tri_sample_plain: the volume detached": (
        "boostmvsnerfs_torch.models.mvsnerf", "tri_sample_plain", _detached_first),
    "renderer_mlp_plain: pts_bias detached": (
        "boostmvsnerfs_torch.models.mvsnerf", "renderer_mlp_plain", _pts_bias_detached),
    "img_sample: the first view's colours lost": (
        "cuda.img_sample", "row_sample_plain",
        lambda fn: lambda imgs, *args: fn(_first_zeroed(imgs, 0), *args)),
}


def phase_train_step_check_mvsnerf() -> None:
    """One BoostMVSNeRF Adam step at TRAIN_CHECK_HW (4 views, K=2, 1024
    random rays) with the same weights and batch on the card (float32: the
    colour lookup on kernel #3, nothing else launched) and on the CPU port
    (float32, and float64 as the reference): the loss within 1e-4 and the
    card's gradients within the MVS_GRAD_BARS of float64, bars tested in
    the same run (float32's spread passes them, every fault of MVS_FAULTS
    fails them); then ``run_train`` over the recipe at TRAIN_CHECK_HW for
    TRAIN_CHECK_STEPS steps, card against CPU (``train_check``)."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    state = random_weights(BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8), device="cpu"), 0)
    batch = mvs_step_batch(*TRAIN_CHECK_HW, seed=3)
    reset_launch_counts()
    lg, gg = mvs_step_grads(state, batch, "cuda", torch.float32)
    torch.cuda.synchronize()
    card_launches = launch_counts()
    lc, gc = mvs_step_grads(state, batch, "cpu", torch.float32)
    ref_loss, ref = mvs_step_grads(state, batch, "cpu", torch.float64)
    bars = cpu_bar_readings(state, batch, ref, [gc], faults=MVS_FAULTS,
                            grads=lambda b: mvs_step_grads(state, b, "cpu", torch.float32)[1])
    vs_ref = grad_rel_errors(gg, ref)
    worst = sorted(vs_ref, key=vs_ref.get, reverse=True)[:3]
    record = {"geometry": list(TRAIN_CHECK_HW), "views": 4, "k_best": 2, "samples": 8,
              "rays": MVS_STEP_RAYS, "launches_card_step": card_launches,
              "loss_card": lg, "loss_cpu": lc, "loss_cpu_float64": ref_loss,
              "loss_rel_err": abs(lg - lc) / abs(lc),
              "card_vs_float64_worst": {k: vs_ref[k] for k in worst},
              "card_vs_float64_global": global_rel_error(gg, ref),
              "card_vs_cpu_worst": max(grad_rel_errors(gg, gc).values()),
              "bars": {"tensor": MVS_GRAD_BARS[0], "global": MVS_GRAD_BARS[1]},
              "cpu_float32_vs_float64": bars["spread"], "cpu_planted_faults": bars["faults"]}
    require(card_launches == added({"img_sample": 1}),
            f"train_step_check_mvsnerf: launches of the card's step {card_launches}")
    require(all(within_bars(r, MVS_GRAD_BARS) for r in bars["spread"]),
            "float32's own spread fails the bars")
    for fault, r in bars["faults"].items():
        require(not within_bars(r, MVS_GRAD_BARS), f"planted fault {fault!r} passes the bars: {r}")
    require(record["loss_rel_err"] <= 1e-4, f"card vs CPU loss {record['loss_rel_err']}")
    require(within_bars({"worst": max(vs_ref.values()), "global": record["card_vs_float64_global"]},
                        MVS_GRAD_BARS), f"card gradients {record}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as small:
        record["run_train"] = train_check(small, mvs_entry_cfg)
    record["phase_seconds"] = time.perf_counter() - t_phase
    emit(phase="train_step_check_mvsnerf", **record)


def mvs_plain_times(model, batch, iters: int = 5) -> dict:
    """The step's plain volume lookup and MLP alone at its shapes (train
    mode, CUDA events): each one's forward, and forward with backward (a
    seeded cotangent; the volume and the MLP's input features take
    gradients), median ms of ``iters``."""
    from boostmvsnerfs_torch.ops.cuda.tri_sample import tri_sample_plain

    model.train()
    with torch.no_grad():
        calls, (uvd, feat, dirs), _, _ = mvs_stages(model, batch)
    volume, xyz, spr = calls["tri_sample"]
    vol = volume.detach().requires_grad_()
    feat = feat.detach().requires_grad_()
    gen = torch.Generator(device=vol.device).manual_seed(5)
    g_vox = torch.randn(*xyz.shape[:2], vol.shape[-1], generator=gen, device=vol.device)
    g_raw = torch.randn(*uvd.shape[:2], 4, generator=gen, device=vol.device)
    head, freqs = model.nerf.nerf, model.cfg.pos_freqs

    def fwd_tri():
        with torch.no_grad():
            tri_sample_plain(vol, xyz, spr)

    def both_tri():
        tri_sample_plain(vol, xyz, spr).backward(g_vox)

    def fwd_mlp():
        with torch.no_grad():
            head(uvd, feat, dirs, freqs)

    def both_mlp():
        head(uvd, feat, dirs, freqs).backward(g_raw)

    out = {"samples": int(xyz.shape[0] * xyz.shape[1]), "volume": list(vol.shape)}
    for name, f, b in (("tri_sample_plain", fwd_tri, both_tri), ("mlp_plain", fwd_mlp, both_mlp)):
        fwd, total = median_ms(f, iters), median_ms(b, iters)
        out[name] = {"forward_ms": fwd, "forward_backward_ms": total, "backward_ms": total - fwd}
    return out


def phase_profile_train_mvsnerf(cfg, weights: dict, batch: dict) -> None:
    """One profiled step of the BoostMVSNeRF recipe (the entry's first
    batch: 4 images of 1024 rays, K=4, 480x736 volumes) after 2 warm-up
    steps: device busy against the step's time, cuDNN forward and backward,
    #3, the top kernels and the backward functions by device time; then the
    plain volume lookup and MLP alone at the step's shapes
    (``mvs_plain_times``)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = runner.make_network(cfg)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(model, make_optimizer(cfg.train, 4))
    step = make_train_step(model, cas=CascadeConfig.from_cfg(cfg.enerf))
    for _ in range(2):
        step(state, batch)
    phase_profile(lambda: step(state, batch), "profile_train_mvsnerf", ("img_sample",),
                  frames=1, unit="step")
    emit(phase="profile_train_mvsnerf_plain", **mvs_plain_times(model, batch))


# ------------------------------------------------ the ENeRF variants

COMPOSITE_CFG = "configs/exps/evaluate/enerf/base_eval.yaml"
# the layered composite at the published ENeRF widths: 2 foreground layers
# of 224x320 crops (multiples of 8 = 1 / min(volume_scale)) at origins
# (x, y), background planes (16, 4) (JAX runner's defaults otherwise)
COMPOSITE_OPTS = ("network_module", "lib.networks.enerf.enerf_composite",
                  "composite.num_fg_layers", "2", "composite.fg_hw", "[224, 320]",
                  "composite.bg_planes", "[16, 4]")
COMPOSITE_ORIGINS = ((96, 64), (384, 192))
COMPOSITE_HW = (480, 736)
# the card-vs-CPU frame and train step: 128x192, 64x64 crops
COMPOSITE_CHECK_HW, COMPOSITE_CHECK_FG = (128, 192), (64, 64)
COMPOSITE_CHECK_ORIGINS = ((16, 16), (120, 56))
# per frame, from the code (CompositeENeRF.render with render_if [false,
# true]): each level builds a volume per foreground layer and one for the
# background (#1 x 3 x 2); level 1 renders each layer and the background
# (#3 x 3, #5 x 3, of them 2 without voxel features)
COMPOSITE_FRAME = {"warp_variance": 6, "img_sample": 3, "enerf_head": 3}
COMPOSITE_NO_VOX_HEADS = 2
HUMAN_EVAL = "configs/exps/evaluate/enerf/free_eval.yaml"
HUMAN_FINETUNE = "configs/exps/finetune/enerf/free/base.yaml"
# the ENeRF fine-tuning recipe on random rays (dtu_pretrain.yaml's budget),
# drawn on the target's mask, with two 32x32 patches at level 1
HUMAN_TRAIN_OPTS = ("network_module", "lib.networks.enerf.enerf_human",
                    "enerf.cas_config.train_img", "[false, false]",
                    "enerf.cas_config.num_rays", "[4096, 32768]", "enerf.sample_on_mask", "true",
                    "enerf.cas_config.num_patchs", "[0, 2]",
                    "enerf.cas_config.patch_size", "[-1, 32]")


def composite_batch(H: int, W: int, origins, seed: int, targets: bool = False) -> dict:
    """A forward-rig batch (3 views) for the layered composite: the crops'
    origins as ``bbox`` and per-layer depth ranges (each foreground band
    inside the background's), as JAX tests/test_variants.py builds them;
    smooth source images for a train step."""
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    b = make_scene_batch(B=1, n_views=3, H=H, W=W, seed=seed, rig="forward",
                         with_targets=targets)
    nf = b["near_far"]
    b["near_far"] = np.stack([nf * np.array([1.2, 0.8])] * len(origins) + [nf],
                             1).astype(np.float32)
    b["bbox"] = np.asarray(origins, np.int32)[None]
    if targets:
        b["src_inps"] = smooth_images(b["src_inps"].shape, seed)
    return b


def composite_cfg(*opts):
    from boostmvsnerfs_torch.config import make_cfg

    return make_cfg(COMPOSITE_CFG, [*COMPOSITE_OPTS, *opts])


def composite_kernel_inputs(model, batch) -> dict:
    """The kernels' inputs on the composite frame, from the first
    foreground layer's own stages (its crop camera and depth range): #1 at
    both levels, #3 at level 1, and the image-feature-only head at level 1
    (C = 11) and at level 0 (C = 35; the eval cascade builds level 0's
    volume and maps but renders level 1 only)."""
    from boostmvsnerfs_torch.models.variants import _shift_ppoint
    from boostmvsnerfs_torch.ops.cuda.img_sample import fused_row_sample

    fg, cas, (h, w) = model.fg(0), model.cas, model.fg_hw
    feats = fg.extract_features(batch["src_inps"])
    origin = batch["bbox"][:, 0].float()
    sub = {**batch, "tar_ixt": _shift_ppoint(batch["tar_ixt"], origin[:, 0], origin[:, 1])}
    stage = (sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"],
             sub["near_far"][:, 0])
    out = {"warp_variance": [], "img_sample": []}
    prev = None
    for level in range(cas.num):
        dv, _, pm = fg.volume_inputs(level, feats, *stage, prev, tar_hw=(h, w))
        out["warp_variance"].append((f"fg0 level{level}", (feats[f"level_{level}"], pm, dv)))
        _, *prev = fg.build_level_volume(level, feats, *stage, prev, tar_hw=(h, w))
        bounds_map, maps = fg.level_maps(level, feats, *prev, sub["src_inps"], (h, w))
        rs = cas.render_scale[level]
        ray_idx = torch.arange(int(h * rs) * int(w * rs), device=maps.device)[None]
        world_xyz, _, _ = fg.sample_rays(level, bounds_map, sub, ray_idx)
        B, S, Hm, Wm, C = maps.shape
        pts = world_xyz.reshape(B, -1, 3)
        x, y = fg.project_to_views(pts, sub, rs)
        args = (maps.reshape(B * S, Hm, Wm, C), x.reshape(B * S, -1), y.reshape(B * S, -1))
        if cas.render_if[level]:
            out["img_sample"].append((f"fg0 level{level}", args))
        feat = fused_row_sample(*args).reshape(B, S, -1, C)
        head = (getattr(fg, f"nerf_{level}").head_params(), None, feat,
                fg.ray_diff_dirs(pts, sub))
        out[f"enerf_head/no_vox_C{C}"] = [(f"fg0 level{level}", head)]
    return out


COMPOSITE_KERNELS = {
    "warp_variance": ENERF_KERNELS["warp_variance"],
    "img_sample": ENERF_KERNELS["img_sample"],
    **{f"enerf_head/no_vox_C{C}": (
        "enerf_head", f"image-feature-only (use_vox_feat false), C {C}",
        "boostmvsnerfs_tpu/ops/pallas/enerf_head.py:45", head_work, None, BF16)
       for C in (11, 35)},
}


def composite_check(state: dict) -> dict:
    """The reduced composite frame (COMPOSITE_CHECK_*) on the card against
    the CPU port, same weights: rgb PSNR over 45 dB."""
    from boostmvsnerfs_torch import runner

    cfg = composite_cfg("composite.fg_hw", "[{}, {}]".format(*COMPOSITE_CHECK_FG))
    batch = composite_batch(*COMPOSITE_CHECK_HW, COMPOSITE_CHECK_ORIGINS, seed=3)
    outs = {}
    for device in ("cuda", "cpu"):
        model = runner.make_network(cfg, device)
        model.load_state_dict(state, strict=True)
        outs[device] = {k: v.cpu().numpy() for k, v in model(batch).items()}
    g, c = outs["cuda"], outs["cpu"]
    require(g.keys() == c.keys(), "composite: output keys differ between card and CPU")
    out = {"geometry": list(COMPOSITE_CHECK_HW), "fg_hw": list(COMPOSITE_CHECK_FG),
           "origins": COMPOSITE_CHECK_ORIGINS, "rgb_psnr_db": psnr_db(g["rgb_level1"],
                                                                       c["rgb_level1"]),
           "depth_max_abs_err": float(np.abs(g["depth_level1"] - c["depth_level1"]).max())}
    require(out["rgb_psnr_db"] > 45.0, f"composite: card vs CPU {out}")
    return out


def no_vox_heads_per_frame(model, batch) -> int:
    """Head calls without voxel features in one frame of ``model``."""
    from boostmvsnerfs_torch.models import nerf_head

    calls = []
    original = nerf_head.fused_nerf_head

    def spy(params, vox, *args):
        calls.append(vox is None)
        return original(params, vox, *args)

    nerf_head.fused_nerf_head = spy
    try:
        model(batch)
    finally:
        nerf_head.fused_nerf_head = original
    return sum(calls)


def run_composite() -> list:
    """Phases ``kernels`` (path composite), ``composite`` and
    ``profile_composite``: the layered composite from YAML
    (``make_network`` over COMPOSITE_CFG with COMPOSITE_OPTS: the eval
    cascade of base_eval.yaml, 3 views) at 480x736 with seeded weights.
    Returns the kernels' summary records with the frame's launches."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.models.enerf import to_tensors

    t_phase = time.perf_counter()
    cfg = composite_cfg()
    model = runner.make_network(cfg)
    state = random_weights(model, 0)
    model.load_state_dict(state, strict=True)

    def make_batch(seed):
        return to_tensors(composite_batch(*COMPOSITE_HW, COMPOSITE_ORIGINS, seed), model.device)

    with torch.no_grad():
        summary = phase_kernels(COMPOSITE_KERNELS, composite_kernel_inputs(model, make_batch(0)),
                                "composite")
        no_vox = no_vox_heads_per_frame(model, make_batch(0))
    torch.cuda.empty_cache()
    require(no_vox == COMPOSITE_NO_VOX_HEADS, f"composite: {no_vox} image-feature-only heads")
    check = composite_check(random_weights(runner.make_network(
        composite_cfg("composite.fg_hw", "[{}, {}]".format(*COMPOSITE_CHECK_FG)), "cpu"), 0))
    launches = phase_main(model, [make_batch(s) for s in (0, 1, 2)], "composite",
                          COMPOSITE_FRAME, "rgb_level1", COMPOSITE_HW[0] * COMPOSITE_HW[1],
                          config=COMPOSITE_CFG, overrides=list(COMPOSITE_OPTS),
                          geometry=list(COMPOSITE_HW), views=3, fg_hw=list(model.fg_hw),
                          origins=COMPOSITE_ORIGINS, planes=list(model.cas.volume_planes),
                          bg_planes=list(model.bg.cas.volume_planes),
                          no_vox_heads_per_frame=no_vox, check=check)
    batch = make_batch(0)
    phase_profile(lambda: model(batch), "profile_composite",
                  ("warp_variance", "img_sample", "enerf_head"))
    emit(phase="composite_seconds", seconds=time.perf_counter() - t_phase)
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def composite_step_grads(state: dict, batch: dict, device: str, dtype):
    """One Adam step of the 2-layer composite at COMPOSITE_CHECK_FG crops
    (the default cascade: both levels rendered on full images) from
    ``state``: (loss, gradients as float64 CPU tensors; the foreground
    volumes' feat_conv, which no head reads, at 0)."""
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.models.variants import CompositeENeRF
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = CompositeENeRF(CascadeConfig(), num_fg_layers=2, fg_hw=COMPOSITE_CHECK_FG,
                           device=device).to(dtype)
    model.load_state_dict(state, strict=True)
    train_state = create_train_state(model, make_optimizer(TRAIN_CFG, TRAIN_EP_ITER))
    loss = float(make_train_step(model)(train_state, batch)["loss"])
    return loss, {k: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                  for k, p in model.named_parameters()}


# Faults planted into the CPU port's composite step (as PLANTED_FAULTS):
# the crops scattered at the frame's origin, and the crop camera not moved
# in y.
COMPOSITE_FAULTS = {
    "_scatter_full: every crop at (0, 0)": (
        "boostmvsnerfs_torch.models.variants", "_scatter_full",
        lambda fn: lambda u, y0, x0, H, W: fn(u, y0 * 0, x0 * 0, H, W)),
    "_shift_ppoint: y0 ignored": (
        "boostmvsnerfs_torch.models.variants", "_shift_ppoint",
        lambda fn: lambda ixt, x0, y0: fn(ixt, x0, y0 * 0)),
}


def phase_composite_train() -> None:
    """One ``make_train_step`` step of the 2-layer composite at
    COMPOSITE_CHECK_HW on the card (float32: #1 f32, #2, #3 and #4 at the
    crops' shapes) and on the CPU port (float32, and float64 as the
    reference): the losses within 1e-4, the card's gradients within the
    GRAD_RTOL_* bars of float64, the bars tested in the same run (float32's
    spread passes them, every fault of COMPOSITE_FAULTS fails them)."""
    from boostmvsnerfs_torch.models.enerf import CascadeConfig
    from boostmvsnerfs_torch.models.variants import CompositeENeRF
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    state = random_weights(CompositeENeRF(CascadeConfig(), num_fg_layers=2,
                                          fg_hw=COMPOSITE_CHECK_FG, device="cpu"), 0)
    batch = composite_batch(*COMPOSITE_CHECK_HW, COMPOSITE_CHECK_ORIGINS, seed=3, targets=True)
    reset_launch_counts()
    lg, gg = composite_step_grads(state, batch, "cuda", torch.float32)
    torch.cuda.synchronize()
    card_launches = launch_counts()
    lc, gc = composite_step_grads(state, batch, "cpu", torch.float32)
    ref_loss, ref = composite_step_grads(state, batch, "cpu", torch.float64)
    bars = cpu_bar_readings(state, batch, ref, [gc], faults=COMPOSITE_FAULTS,
                            grads=lambda b: composite_step_grads(state, b, "cpu",
                                                                 torch.float32)[1])
    vs_ref = grad_rel_errors(gg, ref)
    worst = sorted(vs_ref, key=vs_ref.get, reverse=True)[:3]
    # per level: 3 volumes (#1 f32 and #2 each), 3 renders (#3 and #4 each)
    design = added({"warp_variance": 6, "warp_variance_bwd": 6, "img_sample": 6,
                    "img_sample_bwd": 6})
    record = {"geometry": list(COMPOSITE_CHECK_HW), "fg_hw": list(COMPOSITE_CHECK_FG),
              "origins": COMPOSITE_CHECK_ORIGINS, "views": 3, "launches_card_step": card_launches,
              "loss_card": lg, "loss_cpu": lc, "loss_cpu_float64": ref_loss,
              "loss_rel_err": abs(lg - lc) / abs(lc),
              "card_vs_float64_worst": {k: vs_ref[k] for k in worst},
              "card_vs_float64_global": global_rel_error(gg, ref),
              "card_vs_cpu_worst": max(grad_rel_errors(gg, gc).values()),
              "bars": {"tensor": GRAD_RTOL_TENSOR, "global": GRAD_RTOL_GLOBAL},
              "cpu_float32_vs_float64": bars["spread"], "cpu_planted_faults": bars["faults"],
              "phase_seconds": time.perf_counter() - t_phase}
    emit(phase="composite_train", **record)
    require(card_launches == design, "composite_train: launches of the card's step")
    require(all(within_bars(r) for r in bars["spread"]), "float32's own spread fails the bars")
    for fault, r in bars["faults"].items():
        require(not within_bars(r), f"planted fault {fault!r} passes the bars: {r}")
    require(record["loss_rel_err"] <= 1e-4, "composite_train: card vs CPU loss")
    require(within_bars({"worst": max(vs_ref.values()),
                         "global": record["card_vs_float64_global"]}),
            "composite_train: card gradients")


def human_train_cfg(ws: str, *opts):
    from boostmvsnerfs_torch.config import make_cfg

    return make_cfg(HUMAN_FINETUNE, ["workspace", ws, "scene", "grass", *TRAIN_ENTRY_OPTS,
                                     *HUMAN_TRAIN_OPTS, *opts])


def phase_human(ws: str) -> None:
    """``HumanENeRF`` from YAML on the Free scene at 480x736 (its batches
    carry no ``mask_at_box``, so the eval frame is ENeRF's): the eval entry
    over HUMAN_EVAL (launches per frame against the design), then the
    training entry over HUMAN_FINETUNE, shortened as ``train_entry`` and on
    random rays with mask sampling and patches (HUMAN_TRAIN_OPTS): steps,
    launches per step and per validation frame against the design, peak
    memory; then ``run_train`` at TRAIN_CHECK_HW card against CPU."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    cfg = eval_cfg(HUMAN_EVAL, ws, "grass", "network_module", "lib.networks.enerf.enerf_human")
    save_seeded_weights(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ret = runner.run_evaluate(cfg)
    torch.cuda.synchronize()
    launches = launch_counts()
    views = len(ret["frame_ms"])
    cas = runner.make_network(cfg, "cpu").cas
    rendered = sum(cas.render_if)
    frame = {"warp_variance": cas.num, "img_sample": rendered, "enerf_head": rendered}
    require(launches == added(scaled(frame, views)), f"human eval: launches {launches}")
    require(views == 2 and math.isfinite(ret["psnr"]), f"human eval: {ret}")
    record = {"evaluate": {"config": HUMAN_EVAL, "launches": launches,
                           "frame_ms": ret["frame_ms"],
                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "summary": {k: v for k, v in ret.items() if k != "frame_ms"}}}

    cfg = human_train_cfg(ws)
    save_pretrain(cfg)
    run = drive_train_entry(cfg, 0)
    model = runner.make_network(cfg, "cpu")
    loader = runner.train_loader(cfg, make_dataset(cfg, "train"))
    loader.set_epoch(0)
    batch = runner._device_batch(next(iter(loader)), "cpu")
    n_rays = [int(batch[f"ray_idx_{i}"].shape[1]) for i in range(cas.num)]
    require(n_rays == [4096, 32768 + 2 * 32 * 32], f"human train: rays per level {n_rays}")
    step = expected_train_launches(model, batch, 0)
    rendered = sum(model.cas.render_if)
    validation = added(scaled({"warp_variance": model.cas.num, "img_sample": rendered,
                               "enerf_head": rendered}, 2))
    design = {"step": step, "validation": validation,
              "first": added(scaled(step, TRAIN_ENTRY_STEPS), validation)}
    check_train_entry_run("first", run, design, 0, steps=TRAIN_ENTRY_STEPS, prepass=False)
    record["train"] = {"config": HUMAN_FINETUNE,
                       "overrides": [*TRAIN_ENTRY_OPTS, *HUMAN_TRAIN_OPTS],
                       "batch": int(batch["src_inps"].shape[0]), "rays_per_level": n_rays,
                       "design": design, **{k: run[k] for k in (
                           "seconds", "launches", "peak_mem_gib", "final_step", "val",
                           "validations")}, **step_summary(run)}
    record["check"] = train_check(ws, human_train_cfg)
    record["phase_seconds"] = time.perf_counter() - t_phase
    emit(phase="human", **record)


def run_variants() -> list:
    """The ENeRF variants (module docstring, item 14)."""
    records = run_composite()
    torch.cuda.empty_cache()
    phase_composite_train()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws)
        phase_human(ws)
    return records


# ------------------------------------ multi-GPU: torch.distributed ranks

# Each distributed phase launches its ranks with ``python -m
# torch.distributed.run`` (a process group of its own); a launch that
# outlives DIST_TIMEOUT_S is killed with every rank it started and fails
# the phase. The ranks run ``chip_smoke.py --rank-worker JOB OUT ...``
# (``rank_worker``), which drives the entries' own functions and writes
# each rank's readings into OUT.
DIST_TIMEOUT_S = 420
# the training entry's recipe (TRAIN_ENTRY_OPTS): one epoch of 2 steps a
# launch
DIST_TRAIN_OPTS = TRAIN_ENTRY_OPTS
DIST_FRAME_ITERS = 5
# the unsharded frame against the sharded one, under deterministic cuDNN
DIST_FRAME_TOL = 1e-5
DIST_PSNR_TOL_DB = 1e-4
SPREAD_FACTOR = 3.0
COLLECTIVE_PREFIXES = ("c10d::", "gloo:", "nccl:")


def descendants(pid: int) -> list:
    """Every process below ``pid`` (from /proc): torchrun starts each rank in
    a session of its own, out of reach of its own process group's signals."""
    children = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            with contextlib.suppress(OSError):
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def torchrun(nproc: int, args: list, tag: str) -> dict:
    """``nproc`` ranks of ``args`` (a script and its arguments, or ``-m``
    and a module) under ``torch.distributed.run --standalone``, from the
    repository root: on failure the phase fails; past DIST_TIMEOUT_S
    torchrun and every rank are killed and the phase fails. Returns the
    launch's seconds and each rank's output lines ({rank: [lines]}, from
    ``--tee``)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), "--tee", "3", *args]
    env = {**os.environ, "PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "4"}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for pid in [*descendants(proc.pid), proc.pid]:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{tag}: the ranks outlived {DIST_TIMEOUT_S} s\n{err[-3000:]}")
    require(proc.returncode == 0,
            f"{tag}: the launch exited {proc.returncode}\n{out[-3000:]}\n{err[-6000:]}")
    lines = {r: [ln.split(":", 1)[1] for ln in out.splitlines()
                 if ln.startswith(f"[default{r}]:")] for r in range(nproc)}
    return {"seconds": time.perf_counter() - t0, "lines": lines}


def rank_results(out: str, world: int) -> list:
    """Each rank's ``rank_worker`` readings: [(json record, npz arrays)]."""
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            rec = json.load(f)
        path = os.path.join(out, f"rank{r}.npz")
        res.append((rec, dict(np.load(path)) if os.path.exists(path) else {}))
    return res


@contextlib.contextmanager
def timed_collectives(log: dict):
    """Within the block every ``torch.distributed`` all-reduce and broadcast
    adds its wall time (ms, the card synchronised before and after: gloo
    stages CUDA tensors through the host) and one call to ``log``."""
    import torch.distributed as dist

    originals = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def timed(fn):
        def run(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            log["ms"] += (time.perf_counter() - t0) * 1e3
            log["calls"] += 1
            return out

        return run

    for name, fn in originals.items():
        setattr(dist, name, timed(fn))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def profile_readings(prof, wall_ms: float) -> dict:
    """The device-busy time of a profiled step and its idle share."""
    busy = sum(e.device_time_total for e in block_kernels(prof)) / 1e3
    return {"step_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms}


def worker_train(out: str, argv: list) -> tuple:
    """The training entry's ``main`` (``python -m boostmvsnerfs_torch.train``)
    under deterministic cuDNN with its blocked step recorded: the first
    batch, the first step's gradients and state, each step's stats, time,
    collectives' time (``timed_collectives``) and state digest; rank 0 of a
    world of 2 profiles its second step. Every ``torch.save`` is counted
    (rank 0 alone writes). Then rank 0 of a world of 2 holds the training
    kernels against their plain versions on its first batch
    (``rank_kernels``)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.ops.cuda import launch_counts
    from boostmvsnerfs_torch.parallel.mesh import state_digest
    from boostmvsnerfs_torch.train.__main__ import main as train_main

    rec = {"steps": [], "saves": 0}
    arrays = {}
    make_step = runner.make_blocked_train_step
    save = torch.save

    def counting_save(*args, **kw):
        rec["saves"] += 1
        return save(*args, **kw)

    def recording(model, *args, **kw):
        step = make_step(model, *args, **kw)

        def run(state, batch):
            import torch.distributed as dist

            n = len(rec["steps"])
            if n == 0:
                arrays.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})
            profile = n == 1 and dist.get_rank() == 0 and dist.get_world_size() > 1
            ctx = complete_profile() if profile else contextlib.nullcontext()
            sync()
            t0 = time.perf_counter()
            with ctx as prof, timed_collectives({"ms": 0.0, "calls": 0}) as coll:
                stats = step(state, batch)
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            if profile:
                rec["profile"] = profile_readings(prof, ms)
            if n == 0:
                arrays.update({f"grad/{k}": p.grad.float().cpu().numpy()
                               for k, p in state.model.named_parameters()})
                arrays.update({f"state/{k}": v.float().cpu().numpy()
                               for k, v in state.model.state_dict().items()})
            rec["steps"].append({"ms": ms, "collectives_ms": coll["ms"],
                                 "collectives_share": coll["ms"] / ms,
                                 "collective_calls": coll["calls"],
                                 "stats": {k: float(v) for k, v in stats.items()},
                                 "digest": state_digest(state.model)})
            return stats

        return run

    runner.make_blocked_train_step = recording
    torch.save = counting_save
    try:
        with deterministic_cudnn():
            state = train_main(argv)
    finally:
        runner.make_blocked_train_step = make_step
        torch.save = save
    rec.update(launches=launch_counts(), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if int(os.environ["RANK"]) == 0 and int(os.environ["WORLD_SIZE"]) > 1:
        from boostmvsnerfs_torch.parallel.mesh import sync_batchnorm

        model = sync_batchnorm(state.model, None)  # the process group is gone
        batch = runner._device_batch({k[6:]: v for k, v in arrays.items()
                                      if k.startswith("batch/")}, model.device)
        del state
        rec["kernels"] = rank_kernels(lambda: phase_kernels_train(
            train_kernel_inputs(model, batch, ray_blocks=TRAIN_ENTRY_RAY_BLOCKS),
            "kernels_distributed_train", "distributed_train"))
    return rec, arrays


def rank_kernels(measure) -> list:
    """The summary records of ``measure()`` (``phase_kernels`` or
    ``phase_kernels_train``), in a rank's own process after its run: the
    kernels at the rank's shapes, their profiles early in a process
    (torch.profiler loses device records more often late in a long one,
    ROADMAP fault 12)."""
    torch.cuda.empty_cache()
    with torch.no_grad():
        return list(measure().values())


def worker_eval(out: str, argv: list) -> tuple:
    """The eval entry's ``main`` (``python -m boostmvsnerfs_torch.run``) under
    deterministic cuDNN: its summary and the views its pooled records cover."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.run import main as run_main

    rec = {}
    base = runner.Evaluator

    class Recording(base):
        def summarize(self, verbose: bool = True) -> dict:
            rec["views"] = sorted({"{}_{}".format(*r["view"][:2]) for r in self.records})
            return super().summarize(verbose)

    runner.Evaluator = Recording
    try:
        with deterministic_cudnn():
            ret = run_main(argv)
    finally:
        runner.Evaluator = base
    rec["summary"] = {k: v for k, v in ret.items() if np.isscalar(v)}
    rec["frame_ms"] = ret["frame_ms"]
    return rec, {}


def dist_frame_model_and_batch(k_best: int = 4):
    """The main phase's BoostENeRF (seeded weights) and batch (480x736, 6
    views, K=4), the target moved between source frames 2 and 3: on a
    source camera (the rig's default for 6 views) border rays project onto
    the frame edges, where a viewport mask flips with an ulp of the depth
    (ROADMAP faults 4 and 9), and a fold of 2 volumes and one of 4 may take
    different cuDNN algorithms."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.utils.synthetic import look_at_ext, make_scene_batch

    model = BoostENeRF(CascadeConfig(k_best=k_best, render_if=(False, True)))
    model.load_state_dict(random_weights(model, 0), strict=True)
    batch = make_scene_batch(B=1, n_views=6, H=480, W=736, boost=True, k_best=4, seed=0,
                             rig="forward")
    pos = np.array([0.15 * np.sin(1.25), 0.04 * np.cos(2.25), 0.625])  # the rig's path at 2.5
    batch["tar_ext"] = look_at_ext(pos, target=pos + np.array([0.0, 0.0, 5.0]))[None]
    batch["k_best"] = batch["k_best"][:, :k_best]
    return model, to_tensors(batch, model.device)


def worker_frame(out: str, argv: list) -> tuple:
    """The BoostENeRF frame through ``StagedENeRF`` on the (cv, rays) mesh
    of the world (gloo), under deterministic cuDNN: the outputs, the
    launches of one frame, the times of DIST_FRAME_ITERS more; then the
    first ``cv`` rank holds the frame's kernels against their plain
    versions at its shapes (``rank_kernels``)."""
    import torch.distributed as dist

    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts
    from boostmvsnerfs_torch.parallel import mesh as mesh_lib
    from boostmvsnerfs_torch.parallel.staged import StagedENeRF

    with mesh_lib.process_group(True, "cuda", "gloo"), deterministic_cudnn():
        model, batch = dist_frame_model_and_batch()
        mesh = mesh_lib.make_cv_mesh(k_best=4)
        staged = StagedENeRF(model, mesh)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        got = staged(batch)
        sync()
        launches = launch_counts()
        times = []
        for _ in range(DIST_FRAME_ITERS):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            staged(batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), "launches": launches,
               "frame_ms": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        arrays = {k: v.float().cpu().numpy() for k, v in got.items()}
        first = mesh_lib.axis(mesh, "cv")[1] == 0
    del model, batch, staged, got
    if first:  # the kernels at the first cv rank's shapes: combinations 0 and 1
        model, batch = dist_frame_model_and_batch(k_best=2)
        table = {k: ENERF_KERNELS[k] for k in ("warp_variance", "img_sample", "enerf_head")}
        rec["kernels"] = rank_kernels(
            lambda: phase_kernels(table, main_path_kernel_inputs(model, batch), "distributed_eval"))
    return rec, arrays


RANK_WORKERS = {"train": worker_train, "eval": worker_eval, "frame": worker_frame}


def rank_worker(argv: list) -> int:
    """``chip_smoke.py --rank-worker JOB OUT [ARGS...]``, one rank of a
    ``torchrun`` launch: JOB of RANK_WORKERS with ARGS; writes
    ``OUT/rank<r>.json`` (with the rank's launches, from 0 at its start,
    and peak memory) and ``OUT/rank<r>.npz``."""
    from boostmvsnerfs_torch import set_numerics
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

    job, out, args = argv[0], argv[1], argv[2:]
    r = int(os.environ["RANK"])
    set_numerics()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rec, arrays = RANK_WORKERS[job](out, args)
    rec.setdefault("launches", launch_counts())
    rec.setdefault("peak_mem_gib", torch.cuda.max_memory_allocated() / 2**30)
    os.makedirs(out, exist_ok=True)
    if arrays:
        np.savez(os.path.join(out, f"rank{r}.npz"), **arrays)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def dist_train_args(out: str, ws: str, *opts, worker: bool = True, backend="nccl"):
    """The arguments of a training launch: the worker over the entry, or
    the entry itself (``-m boostmvsnerfs_torch.train``)."""
    entry = ["--distributed", "--dist_backend", backend, "--ray_blocks",
             str(TRAIN_ENTRY_RAY_BLOCKS), "--cfg_file", FINETUNE, "workspace", ws, "scene",
             "grass", *DIST_TRAIN_OPTS, *opts]
    if worker:
        return [os.path.join(REPO_ROOT, "chip_smoke.py"), "--rank-worker", "train", out, *entry]
    return ["-m", "boostmvsnerfs_torch.train", *entry]


def reference_step(cfg, pretrain: dict, batch: dict) -> tuple:
    """One non-distributed blocked step (TRAIN_ENTRY_RAY_BLOCKS) of the
    recipe from the pretrain weights on ``batch`` (numpy): the stats, the
    gradients and the state after it, as float32 CPU tensors."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_blocked_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = runner.make_network(cfg)
    model.load_state_dict(pretrain, strict=True)
    state = create_train_state(model, make_optimizer(cfg.train, int(cfg.ep_iter)))
    with deterministic_cudnn():
        stats = make_blocked_train_step(model, TRAIN_ENTRY_RAY_BLOCKS)(state, batch)
    out = ({k: float(v) for k, v in stats.items()},
           {k: p.grad.float().cpu() for k, p in model.named_parameters()},
           {k: v.float().cpu() for k, v in model.state_dict().items()})
    del model, state
    torch.cuda.empty_cache()
    return out


def step_readings(rank: tuple, ref: tuple) -> dict:
    """A rank's first step against the reference step: the loss (relative),
    the applied gradients, the running statistics and the parameters after
    the step (relative L2, per tensor and all together)."""
    rec, arrays = rank
    stats, grads, state = ref
    got_g = {k: torch.from_numpy(arrays[f"grad/{k}"]) for k in grads}
    stat_keys = [k for k in state if "running_" in k]
    param_keys = [k for k in grads]
    got_s = {k: torch.from_numpy(arrays[f"state/{k}"]) for k in stat_keys + param_keys}

    def readings(got, want):
        per = grad_rel_errors({k: got[k].double() for k in want},
                              {k: v.double() for k, v in want.items()})
        return {"max_per_tensor": max(per.values()), "worst": max(per, key=per.get),
                "global": global_rel_error({k: got[k].double() for k in want},
                                           {k: v.double() for k, v in want.items()})}

    loss = rec["steps"][0]["stats"]["loss"]
    return {"loss": loss, "ref_loss": stats["loss"],
            "loss_rel_err": abs(loss - stats["loss"]) / abs(stats["loss"]),
            "grads": readings(got_g, grads),
            "running_stats": readings(got_s, {k: state[k] for k in stat_keys}),
            "params": readings(got_s, {k: state[k] for k in param_keys})}


def within_step_bars(r: dict, grad_bars=(GRAD_RTOL_TENSOR, GRAD_RTOL_GLOBAL)) -> bool:
    """The loss within TRAIN_LOSS_RTOL; the running statistics and the
    parameters within the gradient bars (ROADMAP fault 6); the gradients
    within ``grad_bars``."""
    bars = {"grads": grad_bars, "running_stats": (GRAD_RTOL_TENSOR, GRAD_RTOL_GLOBAL),
            "params": (GRAD_RTOL_TENSOR, GRAD_RTOL_GLOBAL)}
    return r["loss_rel_err"] <= TRAIN_LOSS_RTOL and all(
        r[k]["max_per_tensor"] <= t and r[k]["global"] <= g for k, (t, g) in bars.items())


def ulp_moved(batch: dict) -> dict:
    """``batch`` with its source images moved by one float32 ulp."""
    x = batch["all_src_inps"].astype(np.float32)
    return {**batch, "all_src_inps": np.nextafter(x, np.float32(np.inf))}


def spread_bars(ref: tuple, moved: tuple) -> tuple:
    """Gradient bars for a step whose forward rounds otherwise than the
    reference's (the world-2 step's BatchNorms sum their statistics per
    rank): SPREAD_FACTOR times float32's own spread, the reference's
    gradients against those of its batch moved by one ulp, and no tighter
    than the fault-6 bars. On the noise scene at 480x736 an ulp moves
    samples across pixel lines and ReLUs across 0, and the U-Nets'
    batch-statistics BatchNorms spread each flip over a channel: the
    level-0 U-Net's last BatchNorm bias moved 8% between two runs of one
    step under cuDNN's default algorithms (PERF.md, section 6)."""
    r = step_readings(({"steps": [{"stats": moved[0]}]},
                       {**{f"grad/{k}": v.numpy() for k, v in moved[1].items()},
                        **{f"state/{k}": v.numpy() for k, v in moved[2].items()}}), ref)["grads"]
    return (max(GRAD_RTOL_TENSOR, SPREAD_FACTOR * r["max_per_tensor"]),
            max(GRAD_RTOL_GLOBAL, SPREAD_FACTOR * r["global"])), r


def batch_of(rank: tuple) -> dict:
    return {k[6:]: v for k, v in rank[1].items() if k.startswith("batch/")}


def concat_batches(batches: list) -> dict:
    """The ranks' first batches as one batch (``combos`` is every rank's)."""
    return {k: v if k == "combos" else np.concatenate([b[k] for b in batches])
            for k, v in batches[0].items()}


def relay_kernel_lines(launch: dict) -> None:
    """Print rank 0's ``kernels`` phase lines (``rank_kernels``) here."""
    for ln in launch["lines"][0]:
        if ln.startswith('{"phase": "kernels'):
            print(ln, flush=True)


def with_launches(records: list, launches: dict) -> list:
    """A rank's kernel summary records with the launches of the run's
    ranks together."""
    return [{**rec, "launches": launches[rec["name"]]} for rec in records]


def dist_launches(results: list) -> dict:
    """The launches of every rank together."""
    return added(*(rec["launches"] for rec, _ in results))


def dist_train_design(cfg, batch: dict, steps: int, prepass: bool, validation: bool) -> dict:
    """A training rank's launches by design (``expected_train_launches`` per
    step of its ``batch``): the pre-pass over the scene's train and test
    views (rank 0 of a launch that finds no view selection), ``steps``
    steps, one validation frame per test view (rank 0)."""
    from boostmvsnerfs_torch import runner

    model = runner.make_network(cfg, "cpu")
    cas = model.cas
    rendered = sum(cas.render_if[: cas.num])
    parts = [scaled(expected_train_launches(model, batch, TRAIN_ENTRY_RAY_BLOCKS), steps)]
    if prepass:
        combos = math.comb(int(batch["all_src_inps"].shape[1]), 3)
        parts += [prepass_design(EVAL_IMAGES - 2, combos, cas.k_best),
                  prepass_design(2, 20, cas.k_best)]
    if validation:
        parts.append(scaled({"warp_variance": cas.num, "img_sample": rendered,
                             "enerf_head": rendered}, 2))
    return added(*parts)


def phase_distributed_train(ws: str, smi: str) -> list:
    """Phase ``distributed_train`` (module docstring, item 15). Returns the
    kernels' summary records at a rank's shapes, with the launches of the
    world-2 run (both ranks)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    cfg_a = train_entry_cfg(ws, "exp_name_tag", "dist_nccl")
    pretrain = save_pretrain(cfg_a)
    record = {"config": FINETUNE, "overrides": list(DIST_TRAIN_OPTS), "geometry": [480, 736],
              "card": smi}

    # (a) world 1 over NCCL: the recipe's batch of 4 in one process
    out_a = os.path.join(ws, "dist_nccl")
    launch = torchrun(1, dist_train_args(out_a, ws, "exp_name_tag", "dist_nccl", "eval_ep", "0"),
                      "world 1")
    (rank_a,) = rank_results(out_a, 1)
    want = dist_train_design(cfg_a, batch_of(rank_a), 2, prepass=True, validation=False)
    require(rank_a[0]["launches"] == want,
            f"distributed_train world 1: launches {rank_a[0]['launches']}, expected {want}")
    ref_a = reference_step(cfg_a, pretrain, batch_of(rank_a))
    reading_a = step_readings(rank_a, ref_a)
    require(within_step_bars(reading_a), f"distributed_train world 1: {reading_a}")
    record["world1_nccl"] = {"launch_seconds": launch["seconds"], "first_step": reading_a,
                             "step_ms": [s["ms"] for s in rank_a[0]["steps"]],
                             "collectives_ms": [s["collectives_ms"] for s in rank_a[0]["steps"]],
                             "peak_mem_gib": rank_a[0]["peak_mem_gib"],
                             "launches": rank_a[0]["launches"]}

    # (b) world 2 over gloo on the one card: 2 + 2 images
    cfg_b = train_entry_cfg(ws, "exp_name_tag", "dist_gloo", "train.batch_size", "2")
    os.makedirs(cfg_b.result_dir, exist_ok=True)
    shutil.copy(runner.view_selection_path(cfg_a), runner.view_selection_path(cfg_b))
    out_b = os.path.join(ws, "dist_gloo")
    opts_b = ("exp_name_tag", "dist_gloo", "train.batch_size", "2")
    launch = torchrun(2, dist_train_args(out_b, ws, *opts_b, backend="gloo"), "world 2")
    ranks_b = rank_results(out_b, 2)
    want = [dist_train_design(cfg_b, batch_of(r), 2, prepass=False, validation=i == 0)
            for i, r in enumerate(ranks_b)]
    require([rec["launches"] for rec, _ in ranks_b] == want,
            f"distributed_train world 2: launches {[rec['launches'] for rec, _ in ranks_b]}, "
            f"expected {want}")
    whole = concat_batches([batch_of(r) for r in ranks_b])
    ref_b = reference_step(cfg_b, pretrain, whole)
    bars, spread = spread_bars(ref_b, reference_step(cfg_b, pretrain, ulp_moved(whole)))
    readings_b = [step_readings(r, ref_b) for r in ranks_b]
    for i, rd in enumerate(readings_b):
        require(within_step_bars(rd, bars), f"distributed_train world 2, rank {i}: {rd} {bars}")
    # the control: the ranks' gradients summed, not averaged
    summed = {**ranks_b[0][1], **{k: 2 * v for k, v in ranks_b[0][1].items()
                                  if k.startswith("grad/")}}
    control = step_readings((ranks_b[0][0], summed), ref_b)
    require(not within_step_bars(control, bars), f"distributed_train: the control passes {control}")
    digests = [[s["digest"] for s in rec["steps"]] for rec, _ in ranks_b]
    require(len(digests[0]) == 2 and digests[0] == digests[1],
            f"distributed_train: the ranks' parameters differ after a step {digests}")
    saves = [rec["saves"] for rec, _ in ranks_b]
    require(saves[0] > 0 and saves[1] == 0, f"distributed_train: saves per rank {saves}")
    mgr = CheckpointManager(cfg_b.trained_model_dir)
    require(mgr.numbered_epochs() == [0] and mgr.restore()["step"] == 2,
            f"distributed_train: checkpoints {mgr.numbered_epochs()}")
    require(any("validation" in ln for ln in launch["lines"][0])
            and not any("validation" in ln for ln in launch["lines"][1]),
            "distributed_train: rank 0 alone validates")
    # the entry itself resumes the run for its second epoch
    resumed = torchrun(2, dist_train_args(None, ws, *opts_b, "train.epoch", "2", "eval_ep", "0",
                                          worker=False, backend="gloo"), "world 2 resumed")
    require(any("resumed at epoch 1" in ln for ln in resumed["lines"][0])
            and mgr.numbered_epochs() == [0, 1] and mgr.restore()["step"] == 4,
            f"distributed_train: resume {resumed['lines'][0][-5:]} {mgr.numbered_epochs()}")
    launches = dist_launches(ranks_b)
    relay_kernel_lines(launch)
    record["world2_gloo"] = {
        "launch_seconds": launch["seconds"], "resumed_launch_seconds": resumed["seconds"],
        "global_batch": int(whole["all_src_inps"].shape[0]), "per_rank_batch": 2,
        "first_step": readings_b, "grad_bars": bars, "float32_spread": spread,
        "control_summed_gradients": control,
        "step_ms": [[s["ms"] for s in rec["steps"]] for rec, _ in ranks_b],
        "collectives_ms": [[s["collectives_ms"] for s in rec["steps"]] for rec, _ in ranks_b],
        "collectives_share": [[s["collectives_share"] for s in rec["steps"]]
                              for rec, _ in ranks_b],
        "collective_calls": [[s["collective_calls"] for s in rec["steps"]]
                             for rec, _ in ranks_b],
        "peak_mem_gib": [rec["peak_mem_gib"] for rec, _ in ranks_b],
        "launches_per_rank": [rec["launches"] for rec, _ in ranks_b], "saves": saves,
        "profile_rank0_step2": ranks_b[0][0]["profile"], "resumed_step": mgr.restore()["step"]}
    emit(phase="distributed_train", **record, phase_seconds=time.perf_counter() - t_phase)
    return with_launches(ranks_b[0][0]["kernels"], launches)


def phase_distributed_eval(ws: str, smi: str) -> list:
    """Phase ``distributed_eval`` (module docstring, item 15). Returns the
    kernels' summary records at a ``cv`` rank's shapes, with the sharded
    frame's launches (both ranks)."""
    from boostmvsnerfs_torch import runner

    t_phase = time.perf_counter()
    record = {"card": smi}
    with deterministic_cudnn():
        model, batch = dist_frame_model_and_batch()
        with torch.no_grad():
            whole = {k: v.float().cpu().numpy() for k, v in model(batch).items()}
            frame_ms = median_ms(lambda: model(batch), DIST_FRAME_ITERS, warmup=1)
    del model, batch
    out = os.path.join(ws, "dist_frame")
    launch = torchrun(2, [os.path.join(REPO_ROOT, "chip_smoke.py"), "--rank-worker", "frame",
                          out], "sharded frame")
    ranks = rank_results(out, 2)
    relay_kernel_lines(launch)
    for i, (_, arrays) in enumerate(ranks):
        require(set(arrays) == set(whole), f"sharded frame keys {sorted(arrays)}")
    errors = [{k: float(np.abs(arrays[k] - w).max()) for k, w in whole.items()}
              for _, arrays in ranks]
    for i, err in enumerate(errors):
        require(err["rgb_level1"] <= DIST_FRAME_TOL and err["depth_level1"] <= DIST_FRAME_TOL,
                f"sharded frame, rank {i}: {err}")
    launches = dist_launches(ranks)
    require(launches == added(ENERF_FRAME, ENERF_FRAME),
            f"sharded frame: launches {launches} (each rank: a frame's kernels on 2 volumes)")
    record["frame"] = {"mesh": ranks[0][0]["mesh"], "max_abs_err": errors,
                       "unsharded_frame_ms_median": frame_ms,
                       "sharded_frame_ms": [rec["frame_ms"] for rec, _ in ranks],
                       "peak_mem_gib": [rec["peak_mem_gib"] for rec, _ in ranks],
                       "launches_per_rank": [rec["launches"] for rec, _ in ranks],
                       "launch_seconds": launch["seconds"]}

    # the eval entry with 2 ranks, each rendering one of the 2 test views
    cfg = eval_cfg(FREE_EVAL, ws, "grass")
    save_seeded_weights(cfg)
    with deterministic_cudnn():
        one = runner.run_evaluate(cfg)
    out = os.path.join(ws, "dist_eval")
    launch = torchrun(2, [os.path.join(REPO_ROOT, "chip_smoke.py"), "--rank-worker", "eval", out,
                          "--type", "evaluate", "--distributed", "--dist_backend", "gloo",
                          "--cfg_file", FREE_EVAL, "workspace", ws, "scene", "grass"],
                      "distributed evaluate")
    evals = rank_results(out, 2)
    require([rec["launches"] for rec, _ in evals] == [added(ENERF_FRAME)] * 2,
            f"distributed evaluate: launches {[rec['launches'] for rec, _ in evals]} "
            "(each rank: one test view's frame; the view selection exists)")
    got = evals[0][0]
    require(got["views"] == ["grass_0", "grass_8"] and len(got["frame_ms"]) == 1,
            f"distributed evaluate: views {got['views']}, frames {got['frame_ms']}")
    require(abs(got["summary"]["psnr"] - one["psnr"]) <= DIST_PSNR_TOL_DB
            and abs(got["summary"]["ssim"] - one["ssim"]) <= 1e-5,
            f"distributed evaluate: {got['summary']} against one process's {one}")
    require(any(ln.strip().startswith("{'psnr'") for ln in launch["lines"][0])
            and not any("psnr" in ln for ln in launch["lines"][1]),
            "distributed evaluate: rank 0 alone prints the summary")
    record["evaluate"] = {"summary": got["summary"],
                          "one_process": {k: v for k, v in one.items() if np.isscalar(v)},
                          "views": got["views"],
                          "frame_ms": [rec["frame_ms"] for rec, _ in evals],
                          "one_process_frame_ms": one["frame_ms"],
                          "peak_mem_gib": [rec["peak_mem_gib"] for rec, _ in evals],
                          "launches_per_rank": [rec["launches"] for rec, _ in evals],
                          "launch_seconds": launch["seconds"]}
    emit(phase="distributed_eval", **record, phase_seconds=time.perf_counter() - t_phase)
    return with_launches(ranks[0][0]["kernels"], launches)


def run_distributed(smi: str) -> list:
    """The multi-GPU phases (module docstring, item 15) on a Free scene of 16
    images at 480x736."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        free_scene(ws)
        records = phase_distributed_train(ws, smi)
        torch.cuda.empty_cache()
        records += phase_distributed_eval(ws, smi)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2:])
    from boostmvsnerfs_torch import set_numerics
    from boostmvsnerfs_torch.ops.cuda import _build

    set_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build()
    ptxas = {}
    for k in _build.KERNELS:
        log = _build.library_path(k).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[k] = [ln.split("info    : ")[-1] for ln in lines if "registers" in ln or "spill" in ln]
    build_seconds = time.perf_counter() - t0
    emit(phase="build", seconds=build_seconds, ptxas=ptxas)

    parts = {}
    records = []
    for run in (run_enerf, run_mvsnerf, run_evaluate_path, run_evaluate_mvsnerf_path,
                run_staged_mvsnerf, run_visualize_and_path, run_train_entry, run_mvsnerf_heads,
                run_train_entry_mvsnerf, run_train_path, run_variants):
        t = time.perf_counter()
        records += run()
        parts[run.__name__] = time.perf_counter() - t
        torch.cuda.empty_cache()
    t = time.perf_counter()
    records += run_distributed(smi)
    parts["run_distributed"] = time.perf_counter() - t
    emit(phase="seconds", build=build_seconds, parts=parts,
         script=time.perf_counter() - T_IMPORT)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
