"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by name
from ``BENCHMARK.json`` at the checkout's root:

* ``portbench/configs/<config>.json``: the configuration tree as it is run
  (``cfg``), with its source, precisions and assumptions;
* ``portbench/traffic/<traffic>.json``: the flow and its parameters, read by
  the one generator (``harness/drive.py``), which finds the flow's code in
  ``portbench/flows/<flow>.py``;
* ``portbench/metrics/<metric>.py``: each metric's reader, ``read(run)``,
  which returns a number or None (nothing to read: the metric is left out);
* ``portbench/limits/<cell>.json``: the numbers that decide ``correct`` and
  their limits (``harness/check.py``).

A run makes the scene and the weights from ``--seed``, builds the port's
model and warms up the cell's shapes (set-up), then renders frames in a
closed loop with one client for ``--seconds`` (the window, which ends at a
frame's end). With ``--trace 1`` it then profiles a short steady sub-window.
It reads the card's peak memory, frees the program, and holds the sampled
frames against the plain reference. The last line on standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(end-to-end with ``--trace 0``, per-layer with ``--trace 1``), ``device``,
with ``--trace 1`` the ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error.

It runs only on CUDA: without a card, or with fewer than the cell asks for,
it exits 3 and prints no result. It exits 4 and prints no result when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, before torch loads

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "boostmvsnerfs_tpu")


def load_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> tuple[dict, dict, dict]:
    """(the workload, its configuration entry, its traffic) of cell ``name``."""
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics: end-to-end without tracing, per-layer with it;
    those with a ``workloads`` list only where it names the cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read: the cell, the configuration tree, the
    window (each frame's latency and its length), the
    set-up's seconds, the traced sub-window's summary (or None) and the
    card's name."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool, device,
             config_file: dict | None = None, traffic: dict | None = None) -> tuple[dict, dict]:
    """One run of cell ``name`` on ``device`` after the look for the card:
    (the result line's object, the compared numbers beside their limits).
    ``config_file`` and ``traffic`` replace the cell's files (a test's small
    sizes on the CPU, where nothing is traced)."""
    import torch
    from boostmvsnerfs_torch.ops.cuda import KERNELS

    from portbench.harness import check, drive
    from portbench.harness import profile as profile_lib

    cell, config, cell_traffic = cell_of(manifest, name)
    traffic = cell_traffic if traffic is None else traffic
    if config_file is None:
        with open(os.path.join(ROOT, config["file"])) as f:
            config_file = json.load(f)
    ctx = drive.Context(config_file, traffic, seed, device)
    cuda = device.type == "cuda"
    flow = drive.make_flow(ctx)
    try:
        latencies = []
        drive.sync(device)
        setup_s = time.perf_counter() - T_START
        t0 = end = time.perf_counter()
        while end - t0 < seconds:
            flow.unit()
            start, end = end, time.perf_counter()
            latencies.append(end - start)
        window_s = end - t0

        summary = None
        if trace:
            n = int(traffic["profiled_frames"])

            def block():
                for _ in range(n):
                    with torch.profiler.record_function("frame"):
                        flow.unit()

            prof, traced_s, _ = profile_lib.profiled(block)
            summary = profile_lib.summarize(prof, n, KERNELS)
            summary["window_s"] = traced_s
            del prof
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        flow.free_program()
        values = flow.readings()
        correct, shown = check.judge(values, check.limits_of(cell["name"]))
    finally:
        flow.close()

    run = Run(cell=cell, cfg=flow.tree, traffic=traffic, latencies=latencies, window_s=window_s,
              setup_s=setup_s, profile=summary,
              card=torch.cuda.get_device_name(device) if cuda else "cpu")
    metrics = {}
    for m in metrics_of(manifest, cell["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(latencies), "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": run.card,
                         "count": cell["chips"], "memory_peak_bytes": memory_peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_total_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = shown
    return result, shown


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_manifest()
    cell, _, _ = cell_of(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    import boostmvsnerfs_torch

    boostmvsnerfs_torch.set_numerics()
    torch.backends.cudnn.benchmark = False
    result, shown = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, (value, limit) in shown.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
