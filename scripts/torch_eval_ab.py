"""Time the port's BoostENeRF eval frame in two checkouts, interleaved.

    python3 scripts/torch_eval_ab.py OLD_TREE NEW_TREE [--rounds 1]

Each tree is a directory holding a ``boostmvsnerfs_torch`` package (a
``git archive`` of a commit, or the repository itself). For each round the
trees run in the order OLD, NEW, NEW, OLD, each in a process of its own that
imports only that tree's package, builds its CUDA kernels there and renders
the first main path of ``chip_smoke.py``: BoostENeRF K=4 of C(6,3) at
480x736, planes (64, 8), level 1 rendered, seeded random weights (seed 0),
f32 with TF32 off. Each process prints one JSON line: the frame time
(median, min, max over 10 back-to-back frames after 2 warm-up frames, CUDA
events) and the device-busy time per frame of a profiled 2-frame window
(torch.profiler, the sum of kernel times). The last lines are a summary per
tree and the card's name and power limit from nvidia-smi. Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

FRAMES = 10


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.ops.cuda import _build
    from boostmvsnerfs_torch.utils.port_weights import random_state_dict
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    model = BoostENeRF(CascadeConfig(k_best=4, render_if=(False, True)))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_state_dict(model, 0).items()}, strict=True)
    model.eval()
    batch = to_tensors(make_scene_batch(B=1, n_views=6, H=480, W=736, boost=True, k_best=4,
                                        seed=0, rig="forward"), model.device)
    for _ in range(2):
        model(batch)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(FRAMES)]
    for start, end in events:
        start.record()
        model(batch)
        end.record()
    torch.cuda.synchronize()
    frame_ms = [s.elapsed_time(e) for s, e in events]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            model(batch)
        torch.cuda.synchronize()
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"tree": tree, "frame_ms_median": statistics.median(frame_ms),
            "frame_ms_min": min(frame_ms), "frame_ms_max": max(frame_ms),
            "device_busy_ms_per_frame": busy_us / 1e3 / 2}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.old)), flush=True)
        return 0
    results = {args.old: [], args.new: []}
    for _ in range(args.rounds):
        for tree in (args.old, args.new, args.new, args.old):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), tree, tree,
                                  "--worker"], capture_output=True, text=True, timeout=900)
            if out.returncode:
                sys.stderr.write(out.stderr[-4000:])
                return out.returncode
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            results[tree].append(rec)
    for tree, recs in results.items():
        print(json.dumps({"tree": tree, "runs": len(recs),
                          "frame_ms_median": [r["frame_ms_median"] for r in recs],
                          "device_busy_ms_per_frame": [r["device_busy_ms_per_frame"]
                                                       for r in recs]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
