"""Time the port's plane-sweep warp kernels and ENeRF head in two checkouts,
interleaved.

    python3 scripts/torch_kernel_ab.py OLD_TREE NEW_TREE [--rounds 1]

Each tree is a directory holding ``chip_smoke.py`` and a
``boostmvsnerfs_torch`` package (a ``git archive`` of a commit, or the
repository itself). For each round the trees run in the order OLD, NEW, NEW,
OLD, each in a process of its own that imports only that tree's package,
builds its CUDA kernels there and takes the kernels' inputs from that tree's
``chip_smoke.py`` (the model's own stages, seeded random weights, f32 with
TF32 off): the BoostENeRF eval frame at 480x736, K=4 (warp_variance at both
levels, enerf_head), and the fine-tuning step's train-mode stages
(warp_variance_bwd at both levels, with a seeded cotangent). Each call is
timed by ``chip_smoke.timings``: one call's CUDA-event time (median of 20)
and its device time (torch.profiler). warp_variance runs at the wrapper's
default and, where the tree has it, at ``compute_dtype=torch.float32``.
Each process prints one JSON line; the last lines are a summary per tree
and the card's name and power limit from nvidia-smi. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys


def worker(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.ops.cuda import _build
    from boostmvsnerfs_torch.ops.cuda.enerf_head import fused_nerf_head
    from boostmvsnerfs_torch.ops.cuda.warp_variance import fused_warp_variance, warp_variance_bwd
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()

    def batch(with_targets):
        return to_tensors(make_scene_batch(B=1, n_views=6, H=480, W=736, boost=True, k_best=4,
                                           seed=0, rig="forward", with_targets=with_targets),
                          torch.device("cuda"))

    out = {"tree": tree}
    has_dtype = "compute_dtype" in inspect.signature(fused_warp_variance).parameters
    with torch.no_grad():
        model = BoostENeRF(CascadeConfig(k_best=4, render_if=(False, True)))
        model.load_state_dict(smoke.random_weights(model, 0), strict=True)
        inputs = smoke.main_path_kernel_inputs(model, batch(False))
        for label, args in inputs["warp_variance"]:
            out[f"warp_variance default {label}"] = smoke.timings(
                lambda: fused_warp_variance(*args))
            if has_dtype:
                out[f"warp_variance float32 {label}"] = smoke.timings(
                    lambda: fused_warp_variance(*args, torch.float32))
        (_, args), = inputs["enerf_head"]
        out["enerf_head S=3"] = smoke.timings(lambda: fused_nerf_head(*args))
        del model, inputs
        torch.cuda.empty_cache()
        model = BoostENeRF(CascadeConfig(k_best=4))
        model.load_state_dict(smoke.random_weights(model, 0), strict=True)
        for label, args in smoke.train_kernel_inputs(model, batch(True))["warp_variance_bwd"]:
            out[f"warp_variance_bwd {label}"] = smoke.timings(lambda: warp_variance_bwd(*args))
    return out


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
        keys = [k for k in recs[0] if k != "tree"]
        print(json.dumps({"tree": tree, "runs": len(recs),
                          **{k: {"ms": [r[k]["ms"] for r in recs],
                                 "device_ms": [r[k]["device_ms"] for r in recs]} for k in keys}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
