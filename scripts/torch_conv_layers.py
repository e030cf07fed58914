"""The cells' convolutions on the card, layer by layer.

    python3 scripts/torch_conv_layers.py [--seed 1234] [--out conv_layers.jsonl]
        [--cells enerf_free_finetune,mvsnerf_free_finetune,enerf_free_eval,mvsnerf_free_eval]
        [--wgrad]

For each benchmark cell named (``portbench``'s: the scene and weights from
the seed, the cell's batches, set-up as the benchmark makes it) it

1. runs one unit (a fine-tuning step or an eval frame) and records, in call
   order, every convolution that ``models/blocks.conv_at`` sends through
   ``KernelConv`` (its layer, input and output shapes and strides, weight
   shape, stride, padding and whether it is transposed), and every data
   gradient that ``conv_dgrad`` computes (``chip_smoke.dgrad_records``: a
   transposed convolution's forward, a convolution's input gradient);
2. profiles one more unit with shapes recorded (primed as the benchmark
   primes it) and lists, in a step, for each ``KernelConvBackward`` the
   device kernels under it with their ms; then the unit's top kernels and
   its convolution kernels;
3. replays each data gradient alone, on seeded normal data of the layer's
   shapes and layout, through ``chip_smoke.conv_dgrad_check``: the kernel
   against its plain version and a second launch, its device ms beside
   cuDNN's (``torch.nn.grad.conv3d_input``, its kernels named) and the
   float32 bound; with ``--wgrad``, each weight gradient of a step too
   (``chip_smoke.conv_wgrad_check``).

Needs one CUDA device. Prints one JSON line per record (also written to
``--out``), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = ("enerf_free_finetune", "mvsnerf_free_finetune", "enerf_free_eval", "mvsnerf_free_eval")
ROUTED = "KernelConvBackward"
CONV_KERNELS = ("wgrad", "dgrad", "convolve", "fprop")  # conv_wgrad and conv_dgrad too


def emit(sink, **record) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    sink.write(line + "\n")


def record_layers(model, step) -> list:
    """The routed convolutions of one call of ``step()`` in call order
    (module docstring, 1)."""
    from boostmvsnerfs_torch.models import blocks

    seen, names = [], {m: n for n, m in model.named_modules()}
    real = blocks.KernelConv.apply

    def spy(x, w, b, conv, dgrad):
        out = real(x, w, b, conv, dgrad)
        seen.append({"layer": names.get(conv), "kind": type(conv).__name__,
                     "x": list(x.shape), "x_strides": list(x.stride()),
                     "weight": list(w.shape), "out": list(out.shape),
                     "out_strides": list(out.stride()), "stride": list(conv.stride),
                     "padding": list(conv.padding), "transposed": conv.transposed})
        return out

    blocks.KernelConv.apply = spy
    try:
        step()
    finally:
        del blocks.KernelConv.apply  # Function's own again
    return seen


def kernels_under(e) -> list:
    """(name, us) of every device kernel launched under host op ``e``."""
    out = [(k.name, k.duration) for k in e.kernels]
    for c in e.cpu_children:
        out += kernels_under(c)
    return out


def backward_table(prof, layers: list) -> list:
    """Each ``KernelConvBackward`` of the profile with what runs under it,
    matched to its layer by its output gradient's shape (the backward meets
    the layers in reverse order)."""
    free = list(layers)
    rows = []
    for e in prof.events():
        if e.device_type.name != "CPU" or e.name != ROUTED:
            continue
        g = [list(s) for s in e.input_shapes][:1]
        match = next((r for r in reversed(free) if [r["out"]] == g), None)
        if match is not None:
            free.remove(match)
        ks = kernels_under(e)
        rows.append({"layer": match and match["layer"], "grad_out": g[0] if g else None,
                     "device_ms": sum(us for _, us in ks) / 1e3,
                     "kernels": [[n[:90], us / 1e3] for n, us in ks]})
    return rows


def strided_normal(shape, strides, gen):
    import torch

    return torch.empty_strided(shape, strides, device="cuda").normal_(generator=gen)


@contextlib.contextmanager
def shapes_profile():
    """torch.profiler with shapes recorded, primed as the benchmark primes
    its profiles (``portbench/harness/profile.primed_profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import profile as profile_lib

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(profile_lib.PRIMER_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(profile_lib.PROFILE_LEAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(profile_lib.PROFILE_TAIL_S)


def replay_wgrad(smoke, layers: list, seed: int, out, cell: str) -> None:
    """Module docstring, 3: each layer's weight gradient alone."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    totals = {"kernel_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}
    for r in layers:
        x = strided_normal(r["x"], r["x_strides"], gen)
        g = strided_normal(r["out"], r["out_strides"], gen)
        rec = smoke.conv_wgrad_check(x, g, r["weight"], r["stride"], r["padding"],
                                     r["transposed"])
        totals["kernel_ms"] += rec["device_ms"]
        totals["cudnn_ms"] += rec["library_device_ms"]
        totals["bound_ms"] += rec["bound_ms"]
        emit(out, cell=cell, phase="replay_wgrad",
             **{k: r[k] for k in ("layer", "x", "out", "weight", "stride", "transposed")}, **rec)
    emit(out, cell=cell, phase="replay_wgrad_total", **totals)


def layer_of(layers: list, r: dict):
    """The recorded layer of data gradient ``r``: a transposed
    convolution whose input has the gradient's shape, or a convolution of
    the same weight and input shapes."""
    for lay in layers:
        if lay["weight"] != r["weight"] or lay["transposed"] != r["transposed"]:
            continue
        if (lay["x"] == r["g"] and lay["out"] == r["x"]) if r["transposed"] else \
                (lay["x"] == r["x"] and lay["out"] == r["g"]):
            return lay["layer"]
    return None


def replay_dgrad(smoke, layers: list, records: list, seed: int, out, cell: str) -> None:
    """Module docstring, 3: each data gradient alone."""
    import math

    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    totals = {"kernel_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}
    for r in records:
        g = smoke.seeded_conv_tensor(r["g"], r["g_layout"], gen)
        w = torch.randn(r["weight"], generator=gen, device="cuda") / math.sqrt(
            math.prod(r["weight"][1:]))
        rec = smoke.conv_dgrad_check(g, w, r["x"], r["stride"], r["padding"])
        del g, w
        totals["kernel_ms"] += rec["device_ms"]
        totals["cudnn_ms"] += rec["library_device_ms"]
        totals["bound_ms"] += rec["bound_ms"]
        emit(out, cell=cell, phase="replay_dgrad", layer=layer_of(layers, r), **r, **rec)
    emit(out, cell=cell, phase="replay_dgrad_total", records=len(records), **totals)


def run_cell(smoke, cell: str, args, out) -> None:
    import torch

    from portbench import run as bench
    from portbench.harness import drive
    from portbench.harness import profile as profile_lib

    manifest = bench.load_manifest()
    _, config, traffic = bench.cell_of(manifest, cell)
    with open(os.path.join(ROOT, config["file"])) as f:
        config_file = json.load(f)
    t0 = time.perf_counter()
    flow = drive.make_flow(drive.Context(config_file, traffic, args.seed,
                                         torch.device("cuda", 0)))
    train = hasattr(flow, "step_fn")
    try:
        emit(out, cell=cell, phase="setup", seconds=time.perf_counter() - t0)
        records = []
        layers = record_layers(flow.model,
                               lambda: records.extend(smoke.dgrad_records(flow.unit)))
        for r in layers:
            emit(out, cell=cell, phase="layer", **r)
        with shapes_profile() as prof:
            t = time.perf_counter()
            flow.unit()
            torch.cuda.synchronize()
            unit_s = time.perf_counter() - t
        if train:
            for row in backward_table(prof, layers):
                emit(out, cell=cell, phase="backward", **row)
        summary = profile_lib.summarize(prof, 1, ())
        emit(out, cell=cell, phase="unit", host_s=unit_s, busy_s=summary["busy_s"],
             conv_s=summary["conv_s"], device_ops=summary["device_ops"],
             conv_kernels_s={k: v for k, v in summary["kernels_s"].items()
                             if any(s in k for s in CONV_KERNELS)})
        del prof
        flow.free_program()
        replay_dgrad(smoke, layers, records, args.seed, out, cell)
        if train and args.wgrad:
            replay_wgrad(smoke, layers, args.seed, out, cell)
    finally:
        flow.close()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="conv_layers.jsonl")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--wgrad", action="store_true", help="replay the weight gradients too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_layers: needs a CUDA device", file=sys.stderr)
        return 1
    import boostmvsnerfs_torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    boostmvsnerfs_torch.set_numerics()
    torch.backends.cudnn.benchmark = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for cell in args.cells.split(","):
            run_cell(smoke, cell, args, out)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
