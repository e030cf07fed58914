"""``BENCHMARK.json`` and the files it names: the manifest's keys, names and
units; a metric found by its file; what the runs and the reference import;
the refusal of a host without a card."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.tests.portbench_support import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "boostmvsnerfs_tpu"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert all(PATH.match(p) for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells = {w["name"] for w in m["workloads"]}
    configs = {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        for kind in ("traffic", "limits"):
            name = w["traffic"] if kind == "traffic" else w["name"]
            assert os.path.exists(os.path.join(BENCH, kind, f"{name}.json"))
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(cells)
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(cells) // 4)
    assert configs == {w["config"] for w in m["workloads"]}
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(x["layer"]) and x["moves"] in e2e
        reported = set(e2e[x["moves"]].get("workloads", cells))
        assert set(x["workloads"]) <= reported
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower",
                                                                                  "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{x['name']}.py"))
        assert set(x.get("workloads", [])) <= cells
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert sum(cell in x.get("workloads", [cell]) for x in m["end_to_end"]) >= 2
        assert any(cell in x.get("workloads", [cell]) for x in m["per_layer"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_limits_files_name_numbers_the_flow_computes():
    """Each cell's limits name numbers that its traffic's flow reads
    (``NUMBERS`` of ``flows/<flow>.py``), each limit above nought."""
    from portbench import run
    from portbench.harness import drive

    m = manifest()
    for w in m["workloads"]:
        _, _, traffic = run.cell_of(m, w["name"])
        with open(os.path.join(BENCH, "limits", f"{w['name']}.json")) as f:
            limits = json.load(f)["limits"]
        assert limits and set(limits) <= set(drive.flow_module(traffic["flow"]).NUMBERS)
        assert all(v > 0 for v in limits.values())


def test_a_flow_is_found_by_its_file(tmp_path, monkeypatch):
    """A later mix of a new kind of work needs only its flow's file under
    ``flows/`` and its traffic file: the generator finds the flow by the
    name the traffic gives."""
    from portbench.harness import drive

    (tmp_path / "counted.py").write_text(
        "NUMBERS = ('units',)\n"
        "class Counted:\n"
        "    def __init__(self, ctx):\n"
        "        self.ctx = ctx\n"
        "def build(ctx):\n"
        "    return Counted(ctx)\n")
    monkeypatch.setattr(drive, "FLOWS", str(tmp_path))
    ctx = drive.Context({}, {"flow": "counted"}, 1, None)
    flow = drive.make_flow(ctx)
    assert type(flow).__name__ == "Counted" and flow.ctx is ctx
    assert drive.flow_module("counted").NUMBERS == ("units",)


def test_a_metric_is_found_by_its_file(tmp_path):
    """A later cell's metric needs only its file under ``metrics/`` and its
    entry: in a copy of the benchmark, the new reader is found and read."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
    m["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                           "source": "host_clock", "layer": "frame executor and model",
                           "moves": "frame_ms", "workloads": ["enerf_free_eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "portbench/metrics/frames.count.py").write_text(
        "def read(run):\n    return float(len(run.latencies))\n")
    spec = importlib.util.spec_from_file_location("portbench_copy_run",
                                                  tmp_path / "portbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    wanted = [x["name"] for x in run.metrics_of(run.load_manifest(), "enerf_free_eval", True)]
    assert "frames.count" in wanted
    assert "frames.count" not in [x["name"] for x in run.metrics_of(run.load_manifest(),
                                                                     "mvsnerf_free_eval", True)]
    assert run.reader("frames.count")(run.Run(latencies=[0.1, 0.2])) == 2.0


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    """A whole run of a cell (on the CPU at a small size, after the look for
    the card) and every metric reader load nothing whose top-level name is
    JAX's or the JAX package's."""
    code = (
        "import torch; torch.set_num_threads(2)\n"
        "from portbench import run\n"
        "from portbench.tests.portbench_support import cell_files, manifest\n"
        "m = manifest()\n"
        "for x in m['end_to_end'] + m['per_layer']: run.reader(x['name'])\n"
        "cfg, tr = cell_files('enerf_free_eval', images=16)\n"
        "run.run_cell(m, 'enerf_free_eval', 3, 0.0, False, torch.device('cpu'), cfg, tr)\n")
    found = _modules_after(code)
    assert "boostmvsnerfs_torch" in found and not found & FORBIDDEN


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import portbench.reference.boost_enerf, portbench.reference.boost_mvsnerf\n"
            "import portbench.harness.check\n")
    found = _modules_after(code)
    assert not found & (FORBIDDEN | {"boostmvsnerfs_torch"})


def test_a_host_without_a_card_gets_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "enerf_free_eval",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
