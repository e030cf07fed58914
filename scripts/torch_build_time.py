"""Time a clean build of the port's CUDA kernels in one or more checkouts.

    python3 scripts/torch_build_time.py TREE [TREE ...] [--rounds 1]

Each tree is a directory holding a ``boostmvsnerfs_torch`` package (a
``git archive`` of a commit, or the repository itself). For each round the
trees run in the order given and then in the reverse order (A, B, B, A),
each in a process of its own that imports only that tree's package. The
process builds every kernel into an empty directory inside its tree with
``_build.build()``, which starts every translation unit at once as the first
CUDA call does, then compiles each unit alone, one after another. It prints
one JSON line: the parallel build's wall time and each unit's time alone,
in seconds. The last lines are the median build time per tree and the
card's name and power limit from nvidia-smi. Needs ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    from boostmvsnerfs_torch.ops.cuda import _build

    build_dir = Path(tempfile.mkdtemp(prefix="_build_time_", dir=os.path.abspath(tree)))
    _build.BUILD_DIR = build_dir
    try:
        t0 = time.perf_counter()
        _build.build()
        build_s = time.perf_counter() - t0
        alone = {}
        for name in _build.KERNELS:
            # older checkouts split a source into several translation units
            units = _build.units(name) if hasattr(_build, "units") else ((),)
            for i, defines in enumerate(units):
                t0 = time.perf_counter()
                subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-c", "-o",
                                str(build_dir / f"{name}.{i}.o"), str(_build.CSRC / f"{name}.cu")],
                               check=True, capture_output=True)
                alone[name if len(units) == 1 else f"{name}/{i}"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(build_dir)
    return {"tree": tree, "build_s": build_s, "alone_s": alone}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    times: dict[str, list[float]] = {t: [] for t in args.trees}
    for _ in range(args.rounds):
        for tree in args.trees + args.trees[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                                 capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr)
                return out.returncode
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            times[tree].append(json.loads(line)["build_s"])
    print(json.dumps({"median_build_s": {t: statistics.median(v) for t, v in times.items()}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
