"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (its window's sampled frames against the plain reference)
and the control's (the reference computed with TF32, one step below the
configuration's float32, in the program's place), at the cell's own size.
The limits in ``portbench/limits/<cell>.json`` are set between the two.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 5 [--control]
        [--faults half_batch altered]

``--faults`` (fine-tuning cells) reads each fault planted in the reference
put in the program's place. Prints one JSON line per seed and reading.
Runs only on CUDA; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    import boostmvsnerfs_torch

    from portbench import run as run_lib
    from portbench.harness import drive

    boostmvsnerfs_torch.set_numerics()
    torch.backends.cudnn.benchmark = False
    manifest = run_lib.load_manifest()
    cell, config, traffic = run_lib.cell_of(manifest, args.workload)
    with open(os.path.join(ROOT, config["file"])) as f:
        config_file = json.load(f)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        flow = drive.make_flow(drive.Context(config_file, traffic, seed, device))
        try:
            t1 = time.perf_counter()
            frames = 0
            while time.perf_counter() - t1 < args.seconds:
                flow.unit()
                frames += 1
            t2 = time.perf_counter()
            flow.free_program()
            program = flow.readings()
            t3 = time.perf_counter()
            print(json.dumps({"cell": cell["name"], "seed": seed, "reading": "program",
                              "frames": frames, "setup_s": t1 - t0, "check_s": t3 - t2,
                              **program}), flush=True)
            if args.control:
                control = flow.readings("control")
                print(json.dumps({"cell": cell["name"], "seed": seed, "reading": "control",
                                  "check_s": time.perf_counter() - t3, **control}), flush=True)
            for fault in args.faults:
                values = flow.readings(fault)
                print(json.dumps({"cell": cell["name"], "seed": seed, "reading": fault,
                                  **values}), flush=True)
        finally:
            flow.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
