"""Smoke run of the PyTorch/CUDA port (boostmvsnerfs_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ and prints one JSON line per
phase. Two main paths are driven, each with its kernels checked first:

1. device  - the card, from torch and nvidia-smi.
2. build   - nvcc of every kernel (all translation units in parallel) and
   its register report.
3. kernels - each kernel against its plain PyTorch version on its main
   path's real inputs at full width (taken from the model's own stages):
   max abs error, median time, the plain version's time, the time of one
   PyTorch call computing the same function where one exists, and the
   bound (bytes over 3.35 TB/s or f32 flops over 67 TFLOP/s, the H100
   SXM's published peaks, whichever is larger).
4. frame   - a reduced-geometry BoostENeRF frame on the card against the
   port on the CPU (plain versions): rgb PSNR must exceed 45 dB.
5. main    - the first main path, bench.py's workload: BoostENeRF K=4 of
   C(6,3), 480x736, planes (64, 8), only level 1 rendered, seeded random
   weights, f32 with TF32 off. Three batches checked, launches per frame
   counted, then frame times over back-to-back frames.
6. profile - where a main-path frame's device time goes (torch.profiler):
   device-busy share, cuDNN convolutions, the ported kernels, top kernels.
7. kernels, frame_mvsnerf, main_mvsnerf, profile_mvsnerf - the same for
   the second main path, scripts/bench_mvsnerf.py's workload: BoostMVSNeRF
   K=4 of C(6,3) (combinations 0, 5, 9, 14), 224x352, 32 samples per ray,
   the published widths (pad 24, 8-ch volume, MLP 6x128), every pixel.

Then the per-kernel summary line, the card's name and power limit as
nvidia-smi prints them, and a last status line. Any failed check raises,
and the script exits non-zero; it also exits non-zero, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# Kernel vs plain version: both f32; the kernels sum in another order (and
# the head calls expf/log1pf), so the largest error allowed is 1e-4 of the
# output's largest magnitude (at least 1).
KERNEL_RTOL = 1e-4
MAIN_RAYS = 480 * 736
MVS_HW = (224, 352)
MVS_K_BEST = (0, 5, 9, 14)
NO_LAUNCHES = {"warp_variance": 0, "img_sample": 0, "enerf_head": 0, "tri_sample": 0,
               "renderer_mlp": 0}


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# Work of each kernel on given inputs: bytes (each input read once, each
# output written once) and f32 operations. The warp counts all four taps
# of every view (out-of-image taps are skipped at run time, but the bytes
# bound dominates either way).
def warp_work(feats, pm, dv):
    B, S, Hs, Ws, C = feats.shape
    n = dv.numel()
    nbytes = 4 * (feats.numel() + pm.numel() + n + n * C)
    return nbytes, n * (S * (35 + 11 * C) + 4 * C)


def sample_work(imgs, x, y, padding_mode="border"):
    C, n = imgs.shape[-1], x.numel()
    return 4 * (imgs.numel() + 2 * n + n * C), n * (20 + 7 * C)


def head_work(params, vox, feat, dirs):
    B, S, P, C = feat.shape
    macs = (S * C * 4 + 2 * 32 * C + S * 32 * C + S * 32 + 16 * 32 + 64 * 24 + 64
            + 64 * 88 + S * 64 * (C + 4) + S * 64)
    n_weights = sum(w.numel() + b.numel() for w, b in params.values())
    nbytes = 4 * (vox.numel() + feat.numel() + dirs.numel() + 4 * B * P + n_weights)
    return nbytes, 2 * macs * B * P


def tri_work(vol, xyz):
    C, n = vol.shape[-1], xyz.numel() // 3
    return 4 * (vol.numel() + xyz.numel() + n * C), n * (8 * (2 + 2 * C) + 12)


def mlp_work(params, pts, feat, dirs, encode_freqs=0):
    """Multiply-adds of every layer (the weights' size) per sample, plus
    the sines and cosines of an in-kernel encoding."""
    n = pts.shape[0] * pts.shape[1]
    macs = sum(w.numel() for w, _ in params.values())
    n_weights = sum(w.numel() + b.numel() for w, b in params.values())
    nbytes = 4 * (pts.numel() + feat.numel() + dirs.numel() + 4 * n + n_weights)
    return nbytes, n * (2 * macs + 2 * 3 * encode_freqs)


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
    world_xyz, uvd, _ = model.sample_rays(1, depth, std, nf_map, sub, sub["ray_idx_1"])
    BK = world_xyz.shape[0]
    vox = model.voxel_features(feat_vol, uvd, H, W)
    maps = model.view_maps(1, feats, sub["src_inps"])
    S, C = maps.shape[1], maps.shape[-1]
    pts = world_xyz.reshape(BK, -1, 3)
    x, y = model.project_to_views(pts, sub, 1.0)
    sample_args = (maps.reshape(BK * S, H, W, C), x.reshape(BK * S, -1), y.reshape(BK * S, -1))
    feat = fused_row_sample(*sample_args).reshape(BK, S, -1, C)
    dirs = model.ray_diff_dirs(pts, sub)
    return {
        "warp_variance": warp,
        "img_sample": [("level1", sample_args)],
        "enerf_head": [("level1", (model.nerf_1.head_params(), vox, feat, dirs))],
    }


def mvs_kernel_inputs(model, batch) -> dict:
    """Each kernel's inputs on the MVSNeRF main path, from the model's own
    stages: {entry: [(label, args), ...]}. The MLP's encoded instance takes
    the raw-coordinate instance's samples, encoded by the port's
    positional_encoding."""
    from boostmvsnerfs_torch.ops.cuda.renderer_mlp import positional_encoding

    sub, volume, near, far = model.fused_volumes(batch)
    calls, _, _ = model.render_stages(sub, volume, sub["ray_idx_0"], near, far)
    params, uvd, feat, dirs, freqs = calls["renderer_mlp"]
    return {
        "tri_sample": [("render", calls["tri_sample"])],
        "img_sample": [("render", calls["img_sample"])],
        "renderer_mlp": [("render", calls["renderer_mlp"])],
        "renderer_mlp/encoded": [("render", (params, positional_encoding(uvd, freqs), feat,
                                             dirs, 0))],
    }


def grid_sample_library_ms(imgs, x, y) -> float:
    """One ``F.grid_sample`` (bilinear, border, align-corners) on the same
    work, for scale; the port never calls it."""
    import torch.nn.functional as F

    V, H, W, C = imgs.shape
    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], -1)[:, None]  # (V, 1, P, 2)
    return median_ms(lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                           align_corners=True), 10)


def grid_sample_3d_library_ms(vol, xyz) -> float:
    """One 5-D ``F.grid_sample`` (trilinear, zeros, align-corners, NCDHW) on
    the same work, for scale; the port never calls it."""
    import torch.nn.functional as F

    B, D, H, W, C = vol.shape
    ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    scale = torch.tensor([W - 1, H - 1, D - 1], dtype=torch.float32, device=xyz.device)
    grid = (xyz / scale * 2 - 1)[:, None, None]  # (B, 1, 1, P, 3)
    return median_ms(lambda: F.grid_sample(ncdhw, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=True), 10)


# entry -> (kernel name, instance or None, its Pallas kernel, work, library yardstick or None)
ENERF_KERNELS = {
    "warp_variance": ("warp_variance", None, "boostmvsnerfs_tpu/ops/pallas/warp_variance.py:38",
                      warp_work, None),
    "img_sample": ("img_sample", None, "boostmvsnerfs_tpu/ops/pallas/img_sample.py:106",
                   sample_work, grid_sample_library_ms),
    "enerf_head": ("enerf_head", None, "boostmvsnerfs_tpu/ops/pallas/enerf_head.py:45",
                   head_work, None),
}
MVS_KERNELS = {
    "tri_sample": ("tri_sample", None, "boostmvsnerfs_tpu/ops/pallas/tri_sample.py:37",
                   tri_work, grid_sample_3d_library_ms),
    "img_sample": ("img_sample", None, "boostmvsnerfs_tpu/ops/pallas/img_sample.py:106",
                   sample_work, grid_sample_library_ms),
    "renderer_mlp": ("renderer_mlp", "raw coordinates, encoded in the kernel",
                     "boostmvsnerfs_tpu/ops/pallas/mlp.py:169", mlp_work, None),
    "renderer_mlp/encoded": ("renderer_mlp", "encoded input",
                             "boostmvsnerfs_tpu/ops/pallas/mlp.py:37", mlp_work, None),
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
        "img_sample": (img_sample.fused_row_sample, img_sample.row_sample_plain),
        "enerf_head": (enerf_head.fused_nerf_head, enerf_head.nerf_head_plain),
        "tri_sample": (tri_sample.fused_tri_sample, tri_sample.tri_sample_plain),
        "renderer_mlp": (renderer_mlp.fused_renderer_mlp, renderer_mlp.renderer_mlp_plain),
    }[name]


def phase_kernels(table: dict, inputs: dict, path: str) -> dict:
    """Every kernel of ``table`` against its plain version on ``inputs``;
    returns the summary record of each entry."""
    summary = {}
    for entry, (name, instance, replaces, work, library) in table.items():
        kernel, plain = kernel_pair(name)
        rec = {"name": name, "route": "cuda", "source": f"boostmvsnerfs_torch/csrc/{name}.cu",
               "replaces": replaces, "path": path, "max_abs_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
        if instance:
            rec["instance"] = instance
        ops_total = bytes_total = 0.0
        for label, args in inputs[entry]:
            got, want = kernel(*args), plain(*args)
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            del got, want
            ms = median_ms(lambda: kernel(*args), 20)
            plain_ms = median_ms(lambda: plain(*args), 3, warmup=1)
            nbytes, ops = work(*args)
            bms, by = bound(nbytes, ops)
            tensors = [a for a in args if torch.is_tensor(a)]
            lib_ms = library(*tensors) if library else None
            emit(phase="kernels", path=path, kernel=name, instance=instance, at=label,
                 shapes=[list(a.shape) for a in tensors],
                 max_abs_err=err, tolerance=KERNEL_RTOL * scale, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                 roofline_share=bms / ms)
            require(err <= KERNEL_RTOL * scale, f"{name} at {label}: max abs error {err} vs plain")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            if lib_ms is not None:
                rec["library_ms"] = lib_ms
            bytes_total += nbytes
            ops_total += ops
        rec["bound_ms"], rec["bound_by"] = bound(bytes_total, ops_total)
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


def phase_frame_mvsnerf(state: dict) -> None:
    """Reduced geometry (128x192, 4 views, K=2 of C(4,3), 32 samples): the
    port on the card against the port on the CPU, same weights and batch."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    batch = mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=128, W=192, boost=True, seed=3,
                                           rig="forward", render_scales=(1.0,)), k_best=(0, 3))
    outs = {}
    for device in ("cuda", "cpu"):
        model = BoostMVSNeRF(MVSNeRFConfig(k_best=2), device=device)
        model.load_state_dict(state, strict=True)
        outs[device] = {k: v.cpu().numpy() for k, v in model(batch).items()}
    g, c = outs["cuda"], outs["cpu"]
    require(g.keys() == c.keys(), "output keys differ between card and CPU")
    psnr = psnr_db(g["rgb_level0"], c["rgb_level0"])
    depth_err = float(np.abs(g["depth_level0"] - c["depth_level0"]).max())
    emit(phase="frame_mvsnerf", geometry=[128, 192], views=4, k_best=2, samples=32,
         rgb_psnr_db=psnr, depth_max_abs_err=depth_err)
    require(psnr > 45.0, f"card vs CPU rgb PSNR {psnr} dB <= 45")


def phase_main(model, batches, phase: str, expect: dict, rgb_key: str, n_rays: int,
               **describe) -> dict:
    """Launches per frame (counts reset just before, read just after one
    frame), three batches checked, then frame times over back-to-back
    frames."""
    from boostmvsnerfs_torch.ops.cuda import launch_counts, reset_launch_counts

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
        require(float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0, f"rgb outside [0, 1] (seed {seed})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for _ in range(2):
        model(batches[0])
    torch.cuda.synchronize()
    n = 10
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    t0 = time.perf_counter()
    for start, end in events:  # back to back: no host sync between frames
        start.record()
        model(batches[0])
        end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    frame_ms = [s.elapsed_time(e) for s, e in events]
    med = statistics.median(frame_ms)
    emit(phase=phase, **describe, launches_per_frame=launches, frame_ms_median=med,
         frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms),
         host_wall_ms_per_frame=wall * 1e3, rays_per_s=n_rays / (med / 1e3),
         peak_mem_gib=peak_gib, frames=n)
    return launches


def phase_profile(model, batch, phase: str, kernels, frames: int = 2) -> None:
    """Where a main-path frame's device time goes, from torch.profiler:
    per frame, the device-busy time (sum of kernel times; one stream, so
    they do not overlap) against the frame's CUDA-event time, the busy time
    under cuDNN convolutions, batch norm and each ported kernel, and the
    top kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(frames):
            model(batch)
        end.record()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernel_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    per_frame = lambda us: us / 1e3 / frames  # noqa: E731
    busy = per_frame(sum(e.device_time_total for e in kernel_events))
    wall = start.elapsed_time(end) / frames
    by_op = {e.key: per_frame(e.device_time_total) for e in events}
    ported = {name: per_frame(sum(e.device_time_total for e in kernel_events
                                  if f"{name}_kernel" in e.key))
              for name in kernels}
    top = sorted(kernel_events, key=lambda e: -e.device_time_total)[:12]
    emit(phase=phase, frames=frames, frame_ms=wall, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall,
         convolution_ms=by_op.get("aten::convolution", 0.0),
         batch_norm_ms=by_op.get("aten::batch_norm", 0.0), ported_kernels_ms=ported,
         top_kernels=[{"kernel": e.key[:120], "device_ms": per_frame(e.device_time_total),
                       "calls": e.count / frames} for e in top])


def run_enerf() -> list:
    """The first main path: BoostENeRF at 480x736. Returns its summary
    records."""
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
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
                          MAIN_RAYS, geometry=[480, 736], views=6, k_best=4, planes=[64, 8])
    phase_profile(model, make_batch(0), "profile", ("warp_variance", "img_sample", "enerf_head"))
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def run_mvsnerf() -> list:
    """The second main path: BoostMVSNeRF at 224x352. Returns its summary
    records."""
    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
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
                          "rgb_level0", H * W, geometry=[H, W], views=6,
                          k_best=list(MVS_K_BEST), samples=model.cfg.num_samples)
    phase_profile(model, make_batch(0), "profile_mvsnerf", tuple(kernels))
    for rec in summary.values():
        rec["launches"] = launches[rec["name"]]
    return list(summary.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    from boostmvsnerfs_torch.ops.cuda import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    records = run_enerf()
    torch.cuda.empty_cache()
    records += run_mvsnerf()
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
