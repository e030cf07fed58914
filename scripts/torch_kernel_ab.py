"""Time the port's kernels in two or more checkouts, interleaved.

    python3 scripts/torch_kernel_ab.py OLD_TREE NEW_TREE [MORE_TREES...]
        [--rounds 1] [--paths enerf,train,mvsnerf]

Each tree is a directory holding ``chip_smoke.py`` and a
``boostmvsnerfs_torch`` package (a ``git archive`` of a commit, or the
repository itself). For each round the trees run in the order given and
then in reverse (OLD, NEW, NEW, OLD for two), each in a process of its own
that imports only that tree's package, builds its CUDA kernels there and
takes the kernels' inputs from that tree's ``chip_smoke.py`` (the model's
own stages, seeded random weights, f32 with TF32 off). ``--paths`` picks
what is timed: ``enerf``, the BoostENeRF eval frame at 480x736, K=4
(warp_variance at both levels, enerf_head); ``train``, the fine-tuning
step's train-mode stages (warp_variance_bwd at both levels, with a seeded
cotangent); ``mvsnerf``, the BoostMVSNeRF eval frame at 224x352, K=4, 32
samples (tri_sample). Each call is timed by ``chip_smoke.timings``: one
call's CUDA-event time (median of 20) and its device time
(torch.profiler). warp_variance and tri_sample run at the wrapper's
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


def worker(tree: str, paths: tuple) -> dict:
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

    def has_dtype(fn):
        return "compute_dtype" in inspect.signature(fn).parameters

    out = {"tree": tree}
    with torch.no_grad():
        if "enerf" in paths:
            model = BoostENeRF(CascadeConfig(k_best=4, render_if=(False, True)))
            model.load_state_dict(smoke.random_weights(model, 0), strict=True)
            inputs = smoke.main_path_kernel_inputs(model, batch(False))
            for label, args in inputs["warp_variance"]:
                out[f"warp_variance default {label}"] = smoke.timings(
                    lambda: fused_warp_variance(*args))
                if has_dtype(fused_warp_variance):
                    out[f"warp_variance float32 {label}"] = smoke.timings(
                        lambda: fused_warp_variance(*args, torch.float32))
            (_, args), = inputs["enerf_head"]
            out["enerf_head S=3"] = smoke.timings(lambda: fused_nerf_head(*args))
            del model, inputs
            torch.cuda.empty_cache()
        if "train" in paths:
            model = BoostENeRF(CascadeConfig(k_best=4))
            model.load_state_dict(smoke.random_weights(model, 0), strict=True)
            for label, args in smoke.train_kernel_inputs(model, batch(True))["warp_variance_bwd"]:
                out[f"warp_variance_bwd {label}"] = smoke.timings(
                    lambda: warp_variance_bwd(*args))
            del model
            torch.cuda.empty_cache()
        if "mvsnerf" in paths:
            out.update(mvsnerf_timings(smoke, has_dtype))
    return out


def mvsnerf_timings(smoke, has_dtype) -> dict:
    """tri_sample on the BoostMVSNeRF main path's inputs, as the tree's
    chip_smoke.py takes them (224x352, K=4 of C(6,3), 32 samples)."""
    import torch

    from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
    from boostmvsnerfs_torch.models.enerf import to_tensors
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
    from boostmvsnerfs_torch.ops.cuda.tri_sample import fused_tri_sample
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch

    model = BoostMVSNeRF(MVSNeRFConfig(k_best=len(smoke.MVS_K_BEST)))
    model.load_state_dict(smoke.random_weights(model, 0), strict=True)
    H, W = smoke.MVS_HW
    batch = make_scene_batch(B=1, n_views=6, H=H, W=W, boost=True, seed=0, rig="forward",
                             render_scales=(1.0,))
    batch = to_tensors(mvsnerf_batch(batch, k_best=smoke.MVS_K_BEST), model.device)
    (_, args), = smoke.mvs_kernel_inputs(model, batch)["tri_sample"]
    out = {"tri_sample default": smoke.timings(lambda: fused_tri_sample(*args))}
    if has_dtype(fused_tri_sample):
        out["tri_sample float32"] = smoke.timings(
            lambda: fused_tri_sample(*args, compute_dtype=torch.float32))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--paths", default="enerf,train,mvsnerf")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    paths = tuple(args.paths.split(","))
    if args.worker:
        print(json.dumps(worker(args.trees[0], paths)), flush=True)
        return 0
    if len(args.trees) < 2:
        ap.error("give two or more trees")
    results = {tree: [] for tree in args.trees}
    for _ in range(args.rounds):
        for tree in args.trees + args.trees[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), tree, "--paths",
                                  args.paths, "--worker"], capture_output=True, text=True,
                                 timeout=900)
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
