"""Where torch.profiler loses device records in a ``chip_smoke.py`` run.

    python3 scripts/torch_profile_probe.py OUT.jsonl

Runs ``chip_smoke.py`` whole, in this process, and writes one JSON line to
OUT.jsonl per profile it takes (``complete_profile``): the seconds since the
start, the last phase record printed before it, the kernel launches the
profiler saw on the host, and how many of the primer's and of the measured
block's launches have no device record. A block with lost records is
written down instead of failing the run. Before the eval entry's phases,
after each of them and at the end, it also takes bare profiles of 5 small
kernels, with no primer, 0.05 s and 1 s after the profile's start, and
writes the same counts for them. Needs one CUDA device; stdout is the smoke
run's own.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def launch_records(prof) -> tuple[list, set]:
    """The correlation ids of the kernel launches on the host, in order, and
    of the device records."""
    events = prof.profiler.kineto_results.events()
    launches = sorted(e.correlation_id() for e in events if e.device_type() == CPU
                      and e.name().startswith(("cudaLaunch", "cuLaunch")))
    return launches, {e.correlation_id() for e in events if e.device_type() == CUDA}


def main(out_path: str) -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.perf_counter()
    out = open(out_path, "w")
    last = {"phase": None}

    def write(**rec):
        out.write(json.dumps({"s": round(time.perf_counter() - t0, 1), "after": last["phase"],
                              **rec}) + "\n")
        out.flush()

    emit = smoke.emit

    def emit_and_note(**rec):
        last["phase"] = [rec.get(k) for k in ("phase", "kernel", "at")]
        emit(**rec)

    def lost_launches(prof) -> int:
        launches, recorded = launch_records(prof)
        n = smoke.PRIMER_KERNELS
        write(kind="complete_profile", launches=len(launches),
              primer_lost=sum(c not in recorded for c in launches[:n]),
              block_lost=sum(c not in recorded for c in launches[n:]))
        return 0

    y = torch.ones(1 << 24, device="cuda") if torch.cuda.is_available() else None

    def bare_profiles(tag: str):
        from torch.profiler import ProfilerActivity, profile

        for lead in (0.05, 1.0):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(lead)
                for _ in range(5):
                    y.mul_(1.0)
                torch.cuda.synchronize()
                time.sleep(0.05)
            launches, recorded = launch_records(prof)
            write(kind="bare", at=tag, lead_s=lead, launches=len(launches),
                  lost=[i for i, c in enumerate(launches) if c not in recorded])

    def around(fn, tag):
        def run():
            bare_profiles(f"before {tag}")
            ret = fn()
            bare_profiles(f"after {tag}")
            return ret
        return run

    smoke.emit = emit_and_note
    smoke.lost_launches = lost_launches
    smoke.run_evaluate_path = around(smoke.run_evaluate_path, "evaluate")
    smoke.run_evaluate_mvsnerf_path = around(smoke.run_evaluate_mvsnerf_path, "evaluate_mvsnerf")
    rc = smoke.main()
    if rc == 0:
        bare_profiles("end")
    out.close()
    return rc


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
