"""The port's tracing and profiling (``utils/profiling.py``) on the CPU:
spans nest and keep their self time; with tracing off a span makes no
annotation and reads no clock; under torch.profiler a span is a user
annotation enclosing its layer's aten ops; a staged ENeRF and a staged
MVSNeRF frame at 64x96 record their layers' spans; an MVSNeRF training step
records ``model.warp`` and counts ``render.samples``, and with tracing off
its spans cost the flag check alone; ``h2d_bytes`` counts the bytes a
batch's host arrays send; the launch counts are the registry's; the
benchmark's four readers of the spans and counters; ``device_trace`` and
``run_evaluate``'s ``profile_dir`` trace; the retaking profiler's count of
lost device records and its retakes."""

import contextlib
import glob
import importlib.util
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
from boostmvsnerfs_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from boostmvsnerfs_torch.parallel.staged import StagedENeRF, StagedMVSNeRF
from boostmvsnerfs_torch.utils import profiling
from boostmvsnerfs_torch.utils.profiling import collect, span, spanned, traced
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch, write_free_scene
from tests.test_torch_runner import REPO, _cfgs, _save_weights

METRICS = os.path.join(REPO, "portbench", "metrics")


@pytest.fixture(autouse=True)
def fresh_table():
    profiling.reset_traced()
    yield
    profiling.reset_traced()


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_trace_with_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir) as prof:
        with span("the_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof is not None
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "the_region" in names and any("matmul" in str(n) for n in names)
    assert traced()["spans"]["the_region"]["n"] == 1


@pytest.mark.parametrize("logdir", [None, ""])
def test_device_trace_is_a_noop_without_a_directory(logdir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace(logdir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_spans_nest_and_self_time_is_duration_less_children(monkeypatch):
    """On a clock that reads 0, 10, 40, 50, 60, 100 ns: the outer span lasts
    100 ns, its two children 30 and 10, so its self time is 60."""
    clock = iter([0, 10, 40, 50, 60, 100])
    monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(clock))
    with collect() as table:
        with span("outer"):
            with span("inner"):
                pass
            with span("inner"):
                pass
    want = {"outer": {"n": 1, "host_s": 100e-9, "self_s": 60e-9},
            "inner": {"n": 2, "host_s": 40e-9, "self_s": 40e-9}}
    for got in (table.as_dict()["spans"], traced()["spans"]):
        assert got.keys() == want.keys()
        for name, entry in want.items():
            assert got[name] == pytest.approx(entry, abs=1e-15)
    assert table.seconds("outer") == pytest.approx(100e-9)


def test_a_span_with_tracing_off_makes_no_annotation_and_reads_no_clock(monkeypatch):
    """Off: no ``record_function`` call, no clock read, one shared object.
    Inside ``collect()`` without a profiler: the clock, still no
    annotation."""
    calls = {"record_function": 0, "clock": 0}

    def spy(key, value):
        def fn(*args):
            calls[key] += 1
            return value(*args)
        return fn

    monkeypatch.setattr(profiling, "record_function", spy("record_function",
                                                          torch.profiler.record_function))
    monkeypatch.setattr(profiling, "perf_counter_ns", spy("clock", time.perf_counter_ns))

    @spanned("decorated")
    def work(x):
        return x + 1

    with span("a"):
        assert work(1) == 2
    assert span("a") is span("b") and calls == {"record_function": 0, "clock": 0}
    assert traced() == {"spans": {}, "counters": {}}
    with collect() as table:
        with span("a"):
            work(1)
    assert calls == {"record_function": 0, "clock": 4}
    assert table.spans["a"][0] == table.spans["decorated"][0] == 1


def test_a_span_is_an_annotation_enclosing_its_aten_ops_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("layer.work"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = prof.events()
    (outer,) = [e for e in events if e.name == "layer.work"]
    inner = [e for e in events if e.name == "aten::matmul"]
    assert inner and all(outer.time_range.start <= e.time_range.start
                         and e.time_range.end <= outer.time_range.end for e in inner)
    parents = set()
    e = inner[0].cpu_parent
    while e is not None:
        parents.add(e.name)
        e = e.cpu_parent
    assert "layer.work" in parents
    assert traced()["spans"]["layer.work"]["n"] == 1


def _frame(family: str):
    """(executor, numpy batch, the spans a frame records) at 64x96 on the
    CPU: a BoostENeRF of 2 levels rendering level 1, K=2; a BoostMVSNeRF in
    4 blocks of 16 rows, K=2."""
    if family == "enerf":
        model = BoostENeRF(CascadeConfig(k_best=2, volume_planes=(8, 8),
                                         render_if=(False, True)), device="cpu")
        batch = make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, k_best=2, seed=0,
                                 rig="forward")
        return StagedENeRF(model), batch, {
            "eval.to_card": 1, "executor.frame": 1, "model.features": 2, "model.volume": 2,
            "model.render": 1, "model.blend": 1}
    model = BoostMVSNeRF(MVSNeRFConfig(num_samples=8, k_best=2), device="cpu")
    batch = mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, seed=0,
                                           rig="forward", render_scales=(1.0,)), k_best=(0, 3))
    return StagedMVSNeRF(model, row_chunk=16), batch, {
        "eval.to_card": 1, "executor.frame": 1, "model.volume": 1, "model.warp": 1,
        "executor.block": 4, "model.render": 4}


@pytest.mark.parametrize("family", ["enerf", "mvsnerf"])
def test_a_staged_frame_records_its_layers_spans(family):
    torch.set_num_threads(1)
    forward, np_batch, want = _frame(family)
    with collect() as table:
        forward(runner._device_batch(np_batch, "cpu"))
    got = table.as_dict()
    assert {name: e["n"] for name, e in got["spans"].items()} == want
    # nothing crossed to another device; the MVSNeRF frame's B*K*H*W*D samples
    assert got["counters"] == ({} if family == "enerf" else {"render.samples": 2 * 64 * 96 * 8})
    frame = got["spans"]["executor.frame"]
    children = sum(e["host_s"] for name, e in got["spans"].items()
                   if name in ("model.features", "model.volume", "executor.block", "model.blend")
                   or (name == "model.render" and family == "enerf"))
    assert frame["self_s"] == pytest.approx(frame["host_s"] - children, rel=1e-6, abs=1e-9)
    assert 0 <= frame["self_s"] < frame["host_s"]


def _mvsnerf_step():
    """(step, state, numpy batch) of the recipe's unblocked BoostMVSNeRF
    training step at 64x96 on the CPU: K=2, 8 samples, 2 targets of 64
    random rays, the loss of a one-level cascade."""
    from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
    from boostmvsnerfs_torch.train.schedule import make_optimizer

    model = BoostMVSNeRF(MVSNeRFConfig(num_samples=8, k_best=2), device="cpu")
    rays = make_scene_batch(B=2, n_views=4, H=64, W=96, boost=True, seed=0, rig="forward",
                            render_scales=(1.0,), with_targets=True, ray_subsample={0: 64})
    batch = {**mvsnerf_batch(rays, k_best=(0, 3)), "ray_idx_0": rays["ray_idx_0"]}
    cas = CascadeConfig(num=1, render_if=(True,), train_img=(False,), loss_weight=(1.0,))
    state = create_train_state(model, make_optimizer({"lr": 5e-5}, 1))
    return make_train_step(model, cas=cas), state, batch


def test_an_mvsnerf_step_records_the_warp_and_counts_its_samples():
    """One training step: ``model.warp`` inside ``model.volume`` once, and
    ``render.samples`` B*K*R*D = 2*2*64*8, in the scope and in ``traced()``;
    the counter's total counts it too."""
    torch.set_num_threads(1)
    step, state, batch = _mvsnerf_step()
    before = profiling.counts().get("render.samples", 0)
    with collect() as table:
        step(state, batch)
    got = table.as_dict()
    assert {name: e["n"] for name, e in got["spans"].items()} == {
        "train.step": 1, "model.volume": 1, "model.warp": 1, "model.render": 1}
    assert got["counters"] == traced()["counters"] == {"render.samples": 2 * 2 * 64 * 8}
    assert profiling.counts()["render.samples"] - before == 2 * 2 * 64 * 8
    volume, warp = got["spans"]["model.volume"], got["spans"]["model.warp"]
    assert 0 < warp["host_s"] < volume["host_s"]
    assert volume["self_s"] == pytest.approx(volume["host_s"] - warp["host_s"], rel=1e-6,
                                             abs=1e-9)


def test_the_step_spans_off_cost_one_flag_check(monkeypatch):
    """Tracing off, the same step: every span is the shared no-op (no
    annotation, no clock read, nothing traced), and the counter's total
    still counts."""
    torch.set_num_threads(1)
    calls = {"record_function": 0, "clock": 0, "flag": 0}

    def spy(key, value):
        def fn(*args):
            calls[key] += 1
            return value(*args)
        return fn

    monkeypatch.setattr(profiling, "record_function", spy("record_function",
                                                          torch.profiler.record_function))
    monkeypatch.setattr(profiling, "perf_counter_ns", spy("clock", time.perf_counter_ns))
    step, state, batch = _mvsnerf_step()
    monkeypatch.setattr(profiling, "_profiler_enabled",
                        spy("flag", profiling._profiler_enabled))
    before = profiling.counts().get("render.samples", 0)
    step(state, batch)
    assert calls["record_function"] == calls["clock"] == 0
    # the four spans' checks, and one in the counter
    assert calls["flag"] == 5
    assert traced() == {"spans": {}, "counters": {}}
    assert profiling.counts()["render.samples"] - before == 2 * 2 * 64 * 8


def _sent(np_batch, dtype=torch.float32) -> int:
    """The bytes the host arrays send after the cast: floats as ``dtype``,
    the rest as int64."""
    return sum(np.asarray(v).size * (dtype.itemsize if np.asarray(v).dtype.kind == "f" else 8)
               for v in np_batch.values())


def test_h2d_bytes_counts_the_bytes_the_host_arrays_send():
    np_batch = mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, seed=0,
                                              render_scales=(1.0,)))
    before = profiling.counts().get("h2d_bytes", 0)
    with collect() as table:
        on_card = to_tensors(np_batch, "meta")
        to_tensors(on_card, "meta")  # already there: nothing crosses
        to_tensors(np_batch, "cpu")  # host to host
        to_tensors({k: torch.as_tensor(v) for k, v in np_batch.items()}, torch.device("meta"),
                   torch.float64)
    want = _sent(np_batch) + _sent(np_batch, torch.float64)
    assert table.counters == {"h2d_bytes": want}
    assert traced()["counters"] == {"h2d_bytes": want}
    assert profiling.counts()["h2d_bytes"] - before == want
    assert all(t.device.type == "meta" for t in on_card.values())


def test_launch_counts_are_the_registrys_counters():
    reset_launch_counts()
    _build.count_launch("tri_sample")
    with collect() as table:
        _build.count_launch("tri_sample")
    counts = launch_counts()
    assert counts == dict(dict.fromkeys(_build.KERNELS, 0), tri_sample=2)
    assert profiling.counts()["launches.tri_sample"] == 2
    assert table.counters == traced()["counters"] == {"launches.tri_sample": 1}
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with pytest.raises(KeyError):
        _build.count_launch("no_such_kernel")


def test_counters_and_spans_add_up_across_threads():
    """8 threads count and span 2,000 times each under a short switch
    interval: no update is lost."""
    n_threads, n = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with collect() as table:
            def work():
                for _ in range(n):
                    profiling.count("ticks")
                    with span("tick"):
                        pass
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert table.counters["ticks"] == n_threads * n == traced()["counters"]["ticks"]
    assert table.spans["tick"][0] == n_threads * n


def test_collect_scopes_nest_and_traced_keeps_everything():
    with collect() as outer:
        with span("first"):
            pass
        with collect() as inner:
            with span("second"):
                pass
    assert set(outer.spans) == {"first", "second"} and set(inner.spans) == {"second"}
    assert set(traced()["spans"]) == {"first", "second"}
    with span("after"):  # tracing off again
        pass
    assert "after" not in traced()["spans"]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"test_metric_{name}",
                                                  os.path.join(METRICS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_the_span_readers_read_the_traced_blocks_retake_included():
    """Two profiled blocks (a retake) of two frames and one step each, the
    batch sent through ``runner._device_batch`` to the meta device: each
    reader divides by the count in the same table; without a profile, or
    from a program without ``traced``, there is nothing to read."""
    from torch.profiler import ProfilerActivity, profile

    np_batch = {**make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, seed=0),
                "meta": [{}]}

    @spanned("executor.frame")
    def issue():
        torch.ones(32, 32).matmul(torch.ones(32, 32))

    @spanned("train.step")
    def step():
        torch.ones(32, 32).sum()

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                runner._device_batch(np_batch, "meta")
                issue()
            step()
    spans = traced()["spans"]
    assert spans["executor.frame"]["n"] == 4 and spans["train.step"]["n"] == 2
    run = types.SimpleNamespace(profile={"units": 2})
    frames = spans["executor.frame"]
    want = {
        "copy_ms.frame": spans["eval.to_card"]["host_s"] / 4 * 1e3,
        "h2d_mb.frame": _sent({k: v for k, v in np_batch.items() if k != "meta"}) / 1e6,
        "issue_ms.frame": frames["host_s"] / 4 * 1e3,
        "issue_ms.step": spans["train.step"]["host_s"] / 2 * 1e3,
    }
    for name, value in want.items():
        read = _reader(name)
        assert read(run) == pytest.approx(value, rel=1e-12) and value > 0
        assert read(types.SimpleNamespace(profile=None)) is None
    profiling.reset_traced()
    assert all(_reader(name)(run) is None for name in want)


def test_the_span_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "traced")
    run = types.SimpleNamespace(profile={"units": 4})
    for name in ("copy_ms.frame", "h2d_mb.frame", "issue_ms.frame", "issue_ms.step"):
        assert _reader(name)(run) is None


def test_run_evaluate_writes_a_trace_to_profile_dir(tmp_path):
    """ENeRF from configs/exps/evaluate/enerf/free_eval.yaml on the Free
    fixture at 64x96: ``profile_dir`` holds one trace of the frame loop,
    with the model's convolutions and the layers' spans in it."""
    torch.set_num_threads(1)
    ws = str(tmp_path / "ws")
    write_free_scene(f"{ws}/Free", "grass")
    logdir = str(tmp_path / "profile")
    cfg, _ = _cfgs("configs/exps/evaluate/enerf/free_eval.yaml",
                   ["workspace", ws, "scene", "grass", "test_dataset.input_h_w", "[64, 96]",
                    "eval_lpips", "false", "profile_dir", logdir])
    _save_weights(cfg, lambda sd: None)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        ret = runner.run_evaluate(cfg, device="cpu")
    finally:
        os.chdir(old)
    assert len(ret["frame_ms"]) == 2
    names = {str(e.get("name")) for e in _trace_events(logdir)}
    assert any("conv" in n for n in names)
    assert {"eval.to_card", "eval.frame", "executor.frame", "model.features", "model.volume",
            "model.render"} <= names
    spans = traced()["spans"]
    assert spans["eval.frame"]["n"] == spans["executor.frame"]["n"] == 2
    assert sum(ret["frame_ms"]) == pytest.approx(spans["eval.frame"]["host_s"] * 1e3, rel=1e-9)


class _Event:
    def __init__(self, name, device, corr):
        self._name, self._device, self._corr = name, device, corr

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("R", (), {
            "events": staticmethod(lambda: events)})})


def test_lost_launches_leave_out_the_primer():
    """A complete profile's check pairs each kernel launch after the
    primer's with its device record by correlation id: the primer's lost
    records do not count, the block's do."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    n = profiling.PRIMER_KERNELS
    events = [_Event("cudaLaunchKernel", cpu, c) for c in range(1, n + 4)]
    events += [_Event("aten::mul", cpu, 0), _Event("cudaStreamSynchronize", cpu, n + 9)]
    events += [_Event("spin_kernel(long)", cuda, c) for c in range(3, n + 1)]  # 2 lost
    events += [_Event("k", cuda, c) for c in (n + 1, n + 2, n + 3)]
    assert profiling.lost_launches(_Profile(events)) == 0
    events.pop()  # the block's last record
    events.append(_Event("cuLaunchKernel", cpu, n + 5))
    assert profiling.lost_launches(_Profile(events)) == 2


def test_a_profile_that_lost_records_is_taken_again(monkeypatch, capsys):
    """``profiled`` takes a block's profile again when torch.profiler lost a
    record of it (each loss noted in a ``profile_retaken`` line), returns
    the first complete one, and fails once PROFILE_TRIES profiles have all
    lost records."""
    outcomes, runs = [], []

    @contextlib.contextmanager
    def fake_profile():
        yield "profile"
        if outcomes.pop(0):
            raise profiling.LostRecords("lost")

    monkeypatch.setattr(profiling, "complete_profile", fake_profile)
    outcomes[:] = [True, True, False]
    assert profiling.profiled(lambda: runs.append(1) or len(runs)) == ("profile", 3)
    notes = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {n["phase"] for n in notes} == {"profile_retaken"}
    assert [n["attempt"] for n in notes] == [1, 2]
    outcomes[:] = [True] * profiling.PROFILE_TRIES
    with pytest.raises(profiling.LostRecords):
        profiling.profiled(lambda: None)
