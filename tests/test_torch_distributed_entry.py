"""The entries' ``--distributed`` on the CPU: ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
boostmvsnerfs_torch.train --distributed --device cpu ...`` and ``-m
boostmvsnerfs_torch.run --type evaluate --distributed``, 2 gloo ranks.

The recipes are those of tests/test_torch_train_entry.py and
tests/test_torch_runner.py on the Free fixture at 64x96: the fine-tuning
recipe (BoostENeRF K=4, both levels on full images) for one epoch of 2
steps a rank (``train.batch_size`` 1 a rank), a checkpoint and a
validation per epoch, from seeded pretrain weights, then resumed for a
second epoch; the eval recipe over the 2 test views. Each launch is
killed at its timeout, which fails the test.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.utils.port_weights import random_state_dict

REPO = Path(__file__).resolve().parents[1]
FINETUNE = "configs/exps/finetune/enerf_ours/free/base.yaml"
FREE_EVAL = "configs/exps/evaluate/enerf_ours/free_eval.yaml"
FT_OPTS = ["train_dataset.input_h_w", "[64, 96]", "test_dataset.input_h_w", "[64, 96]",
           "train.batch_size", "1", "train.num_workers", "1", "ep_iter", "2", "eval_ep", "1",
           "log_interval", "1", "save_ep", "1"]
EVAL_OPTS = ["test_dataset.input_h_w", "[64, 96]"]
LAUNCH_TIMEOUT_S = 240


def _cfg(path: str, ws: str, *opts):
    from boostmvsnerfs_torch.config import make_cfg

    old = os.getcwd()
    os.chdir(REPO)
    try:
        return make_cfg(path, ["workspace", ws, "scene", "grass", *opts])
    finally:
        os.chdir(old)


def _torchrun(module: str, *args) -> dict:
    """A 2-rank launch from the repository root: {rank: its output lines}."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "--tee", "3", "-m", module, "--distributed", "--device", "cpu", *args]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    lines = {0: [], 1: []}
    for line in out.stdout.splitlines():
        for r in lines:
            if line.startswith(f"[default{r}]:"):
                lines[r].append(line[len(f"[default{r}]:"):])
    return lines


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The workspace after the first and the resumed training launch and
    the evaluation launch, with each launch's per-rank output."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    ws = str(tmp_path_factory.mktemp("dist"))
    write_free_scene(f"{ws}/Free", "grass")
    cfg = _cfg(FINETUNE, ws, *FT_OPTS)
    sd = random_state_dict(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(f"{ws}/trained_model/pretrain/enerf").save(
        {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, 0)
    common = ["--cfg_file", FINETUNE, "workspace", ws, "scene", "grass", *FT_OPTS]
    first = _torchrun("boostmvsnerfs_torch.train", *common, "train.epoch", "1")
    ckpts = CheckpointManager(cfg["trained_model_dir"]).numbered_epochs()
    resumed = _torchrun("boostmvsnerfs_torch.train", *common, "train.epoch", "2")
    evaluated = _torchrun("boostmvsnerfs_torch.run", "--type", "evaluate", "--cfg_file",
                          FREE_EVAL, "workspace", ws, "scene", "grass", *EVAL_OPTS)
    return {"ws": ws, "cfg": cfg, "first": first, "resumed": resumed, "evaluated": evaluated,
            "ckpts_after_first": ckpts}


def test_rank0_alone_records_and_saves(launched):
    """Rank 0 prints the records, the validation and the epochs; rank 1
    prints none of them. One checkpoint per epoch, from the first launch and
    the resumed one."""
    for run in ("first", "resumed"):
        rank0, rank1 = launched[run][0], launched[run][1]
        assert any(" iter 0/2 " in ln for ln in rank0), rank0
        assert any("validation" in ln for ln in rank0), rank0
        assert not any(" iter " in ln or "validation" in ln for ln in rank1), rank1
    assert launched["ckpts_after_first"] == [0]
    assert CheckpointManager(launched["cfg"]["trained_model_dir"]).numbered_epochs() == [0, 1]


def test_resumed_run_continues(launched):
    """The second launch resumes at epoch 1 (every rank checks that it read
    the state every other rank read) and takes its 2 steps; the saved state
    is after 4 steps."""
    rank0 = launched["resumed"][0]
    assert any("resumed at epoch 1" in ln for ln in rank0), rank0
    assert any("epoch 1 iter 0/2" in ln for ln in rank0)
    assert not any(ln.lstrip().startswith("epoch 0 ") for ln in rank0)
    state = CheckpointManager(launched["cfg"]["trained_model_dir"]).restore()
    assert state["step"] == 4


def test_ranks_end_with_equal_parameters(launched):
    """Every epoch ends with the ranks' check that they hold rank 0's model
    (``mesh.assert_replicated``), which raises and fails the launch
    otherwise; the checkpoint's parameters are finite and moved from the
    pretrain weights."""
    state = CheckpointManager(launched["cfg"]["trained_model_dir"]).restore()["model"]
    pre = CheckpointManager(f"{launched['ws']}/trained_model/pretrain/enerf").restore()["model"]
    assert all(torch.isfinite(v).all() for v in state.values())
    assert any(not torch.equal(state[k], pre[k]) for k in pre if k.endswith("weight"))


def test_distributed_evaluate_summarises_every_view(launched):
    """Rank 0 of ``run --type evaluate --distributed`` prints the summary of
    both test views (one rendered by each rank), equal to one process's
    ``run_evaluate`` with the same weights (psnr within 1e-4 dB); rank 1
    prints none."""
    from boostmvsnerfs_torch import runner

    rank0, rank1 = launched["evaluated"][0], launched["evaluated"][1]
    summaries = [ast.literal_eval(ln.strip()) for ln in rank0 if ln.strip().startswith("{'psnr'")]
    assert len(summaries) == 1 and not any("psnr" in ln for ln in rank1)
    scenes = [ln for ln in rank0 if ln.strip().startswith("grass_level1")]
    assert len(scenes) == 1
    want = runner.run_evaluate(_cfg(FREE_EVAL, launched["ws"], *EVAL_OPTS), device="cpu")
    got = summaries[0]
    assert got.keys() <= want.keys()
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-4)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_distributed_flag_needs_torchrun(monkeypatch):
    """``--distributed`` without torchrun's variables raises before any work."""
    from boostmvsnerfs_torch.run import main as run_main
    from boostmvsnerfs_torch.train.__main__ import main as train_main

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_main(["--cfg_file", FINETUNE, "--distributed", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run_main(["--type", "evaluate", "--cfg_file", FREE_EVAL, "--distributed",
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        run_main(["--type", "visualize", "--cfg_file", FREE_EVAL, "--distributed"])


# --------------------------------------- chip_smoke.py's distributed pieces


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script(tmp_path, body: str) -> str:
    path = tmp_path / "rank.py"
    path.write_text("import os, sys, time\nr = int(os.environ['RANK'])\n" + body)
    return str(path)


def test_smoke_launch_fails_with_a_failed_rank(smoke, tmp_path):
    """``chip_smoke.torchrun`` fails the phase when a rank exits non-zero,
    and returns each rank's output lines otherwise."""
    ok = smoke.torchrun(2, [_script(tmp_path, "print('rank', r, 'here')\n")], "ok")
    assert [ln.strip() for ln in ok["lines"][1]] == ["rank 1 here"]
    with pytest.raises(AssertionError, match="exited"):
        smoke.torchrun(2, [_script(tmp_path, "sys.exit(3 if r == 1 else 0)\n")], "failing")


def test_smoke_launch_kills_hung_ranks(smoke, tmp_path, monkeypatch):
    """A launch past ``DIST_TIMEOUT_S`` fails the phase, and its ranks are
    killed with it (each rank's pid names a process that is gone, or dead
    and not yet reaped)."""
    monkeypatch.setattr(smoke, "DIST_TIMEOUT_S", 10)
    pid = tmp_path / "pid"
    body = f"open({str(pid)!r} + str(r), 'w').write(str(os.getpid()))\ntime.sleep(300)\n"
    with pytest.raises(AssertionError, match="outlived"):
        smoke.torchrun(2, [_script(tmp_path, body)], "hung")
    for r in range(2):
        rank_pid = (tmp_path / f"pid{r}").read_text()
        status = Path(f"/proc/{rank_pid}/status")
        assert not status.exists() or "zombie" in status.read_text(), rank_pid


def test_smoke_step_bars_catch_summed_gradients(smoke):
    """``step_readings`` / ``within_step_bars``: a rank's first step equal
    to the reference passes, its gradients doubled (summed over 2 ranks,
    not averaged) fail, and ``spread_bars`` never falls below the fault-6
    bars."""
    rng = np.random.default_rng(0)
    grads = {f"w{i}": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
             for i in range(3)}
    state = {**{k: v + 1 for k, v in grads.items()}, "bn.running_mean": torch.ones(3)}
    ref = ({"loss": 0.5}, grads, state)
    arrays = {**{f"grad/{k}": v.numpy() for k, v in grads.items()},
              **{f"state/{k}": v.numpy() for k, v in state.items()}}
    rank = ({"steps": [{"stats": {"loss": 0.5}}]}, arrays)
    assert smoke.within_step_bars(smoke.step_readings(rank, ref))
    doubled = {k: 2 * v if k.startswith("grad/") else v for k, v in arrays.items()}
    assert not smoke.within_step_bars(smoke.step_readings((rank[0], doubled), ref))
    bars, spread = smoke.spread_bars(ref, ref)
    assert bars == (smoke.GRAD_RTOL_TENSOR, smoke.GRAD_RTOL_GLOBAL) and spread["global"] == 0
    batches = [{"combos": np.zeros((4, 3)), "k_best": np.full((2, 4), r)} for r in range(2)]
    whole = smoke.concat_batches(batches)
    assert whole["combos"].shape == (4, 3) and whole["k_best"][:, 0].tolist() == [0, 0, 1, 1]
