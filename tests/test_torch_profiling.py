"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
``device_trace`` writes a Chrome trace and is a no-op without a directory,
``annotate`` names a region in it, ``perf_timer`` times a block, and
``run_evaluate`` with ``profile_dir`` writes its frames' trace there."""

import glob
import json
import os
import time

import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.utils import profiling
from boostmvsnerfs_torch.utils.synthetic import write_free_scene
from tests.test_torch_runner import REPO, _cfgs, _save_weights


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_trace_with_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir) as prof:
        with profiling.annotate("the_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof is not None
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "the_region" in names and any("matmul" in str(n) for n in names)


@pytest.mark.parametrize("logdir", [None, ""])
def test_device_trace_is_a_noop_without_a_directory(logdir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace(logdir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_perf_timer_times_the_block(capsys):
    with profiling.perf_timer("block", device="cpu") as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 1.0 and t.sync("x") == "x"
    assert "[perf] block:" in capsys.readouterr().out
    with profiling.perf_timer("quiet", enabled=False, device="cpu"):
        pass
    assert capsys.readouterr().out == ""


def test_run_evaluate_writes_a_trace_to_profile_dir(tmp_path):
    """ENeRF from configs/exps/evaluate/enerf/free_eval.yaml on the Free
    fixture at 64x96: ``profile_dir`` holds one trace of the frame loop,
    with the model's convolutions in it."""
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
