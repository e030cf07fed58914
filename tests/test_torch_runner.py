"""The port's eval entry against JAX's, end to end on scenes written to disk.

BoostENeRF from configs/exps/evaluate/enerf_ours/free_eval.yaml on the
Free fixture at 64x96 (2 test views, 6 source views, K=4 of 20), and
BoostMVSNeRF from configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml
on a ScanNet fixture at 64x96. Both packages get the same seeded
reference-named weights: the port loads them as ``latest.pt`` from
``trained_model_dir`` (the load path of ``_init_or_load``), JAX takes them
as ``variables``. Each package runs its own view-selection pre-pass and
writes its own ``view_selection.json``. Bars: the same JSON, and
``psnr`` within 0.01 dB and ``ssim`` within 1e-4 of JAX's.

On the JAX side ``eval_lpips`` is off: its fixture LPIPS has flax-initialised
VGG weights, which the port's seeded ``torch.Generator`` does not
reproduce, so the two LPIPS values measure different networks (LPIPS
itself is held against JAX's with carried weights in test_torch_eval.py);
and ``autotune_windows`` is off: it tunes the TPU samplers' windows, which
the exact path here does not use, by calibrated renders that would double
the file's time. JAX takes its exact path (gather warp and sampling, XLA
head, float32 warp, one jit per combination and frame).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import run as trun
from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import make_cfg
from boostmvsnerfs_torch.eval import lpips as tlpips
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.synthetic import write_free_scene, write_scannet_scene
from boostmvsnerfs_tpu import runner as jrunner
from boostmvsnerfs_tpu.config import make_cfg as jax_make_cfg
from boostmvsnerfs_tpu.utils.port_weights import port_enerf, port_mvsnerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
FREE_EVAL = "configs/exps/evaluate/enerf_ours/free_eval.yaml"
SCANNET_EVAL = "configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml"
JAX_EXACT = ["enerf.cas_config.warp_mode", "gather", "enerf.cas_config.eval_sampling", "gather",
             "enerf.cas_config.eval_head", "xla", "enerf.cas_config.warp_dtype", "float32",
             "execution", "jit", "eval_lpips", "false", "autotune_windows", "false",
             "save_tag", "jax"]


def _cfgs(cfg_file, opts):
    old = os.getcwd()
    os.chdir(REPO)
    try:
        return make_cfg(cfg_file, opts), jax_make_cfg(cfg_file, opts + JAX_EXACT)
    finally:
        os.chdir(old)


def _save_weights(cfg, state_fn):
    """Seeded weights as the port's latest.pt; the same weights for JAX."""
    sd = random_state_dict(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(cfg.trained_model_dir).save(
        {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, 0)
    return state_fn(sd)


@pytest.fixture(scope="module")
def free(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    write_free_scene(f"{ws}/Free", "grass")
    cfg, jcfg = _cfgs(FREE_EVAL, ["workspace", ws, "scene", "grass",
                                  "test_dataset.input_h_w", "[64, 96]"])
    variables = _save_weights(cfg, port_enerf)
    ret = runner.run_evaluate(cfg, device="cpu")
    jret = jrunner.run_evaluate(jcfg, variables=variables)
    return cfg, jcfg, ret, jret


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    """The ScanNet fixture's cameras, each turned its own way
    (``write_scannet_scene(rig="varied")``): on the line rig of
    tests/test_data.py the border rows' coverage flips by an ulp (ROADMAP
    fault 4) and greedy steps tie exactly."""
    ws = str(tmp_path_factory.mktemp("ws"))
    write_scannet_scene(f"{ws}/scannet_plus", "scene0000_01", n=8, H=64, W=96, rig="varied")
    cfg, jcfg = _cfgs(SCANNET_EVAL, ["workspace", ws, "scene", "scene0000_01",
                                     "test_dataset.input_h_w", "[64, 96]"])
    variables = _save_weights(cfg, port_mvsnerf)
    ret = runner.run_evaluate(cfg, device="cpu")
    jret = jrunner.run_evaluate(jcfg, variables=variables)
    return cfg, jcfg, ret, jret


@pytest.mark.parametrize("family,keys", [("free", ["grass_0", "grass_8"]),
                                         ("scannet", ["scene0000_01_3", "scene0000_01_5"])])
def test_view_selection_json_matches_jax(request, family, keys):
    cfg, jcfg, _, _ = request.getfixturevalue(family)
    with open(runner.view_selection_path(cfg)) as f:
        got = json.load(f)
    with open(jrunner.view_selection_path(jcfg)) as f:
        want = json.load(f)
    assert got == want
    assert sorted(got) == keys
    assert all(len(v) == 4 and all(0 <= i < 20 for i in v) for v in got.values())


@pytest.mark.parametrize("family", ["free", "scannet"])
def test_run_evaluate_matches_jax(request, family):
    cfg, _, ret, jret = request.getfixturevalue(family)
    assert abs(ret["psnr"] - jret["psnr"]) < 0.01
    assert abs(ret["ssim"] - jret["ssim"]) < 1e-4
    assert len(ret["frame_ms"]) == 2 and ret["fps"] > 0
    # the port runs the fixture LPIPS of the config's eval_lpips: true
    assert np.isfinite(ret["lpips_uncalibrated"]) and "lpips" not in ret
    # save_result: true (configs/exps/pretrain/enerf/dtu_pretrain.yaml)
    assert len([f for f in os.listdir(cfg.result_dir) if f.endswith(".png")]) == 2


def test_init_or_load(free, tmp_path, capsys):
    """``latest.pt``'s model when there is one; else seeded random weights,
    with a warning."""
    cfg = free[0]
    model = runner.make_network(cfg, "cpu")
    runner._init_or_load(cfg, model)
    saved = CheckpointManager(cfg.trained_model_dir).restore()["model"]
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    assert "loaded weights from" in capsys.readouterr().out
    cfg = dict(cfg, trained_model_dir=str(tmp_path / "none"))
    runner._init_or_load(cfg, model)
    assert "WARNING: no trained weights" in capsys.readouterr().out
    want = random_state_dict(model, 0)
    assert all(np.array_equal(v.numpy(), want[k]) for k, v in model.state_dict().items())


def test_attach_boost_inputs_clamps_into_the_batchs_table():
    batch = {"all_src_inps": np.zeros((2, 4, 8, 8, 3)),
             "meta": [{"scene": "s", "tar_view": 0}, {"scene": "s", "tar_view": 8}]}
    cfg = {"enerf": {"cost_volume_input_views": 3}}
    out = runner.attach_boost_inputs(batch, {"s_0": [0, 19, 3], "s_8": [2, 1, 7]}, cfg)
    assert out["combos"].shape == (4, 3)
    np.testing.assert_array_equal(out["k_best"], [[0, 3, 3], [2, 1, 3]])


def test_cli_network_run_on_the_cpu(free, capsys):
    """``python -m boostmvsnerfs_torch.run --type network --device cpu``
    over the fixture, with the view selection the evaluate run wrote."""
    cfg = free[0]
    old = os.getcwd()
    os.chdir(REPO)
    try:
        trun.main(["--type", "network", "--device", "cpu", "--cfg_file", FREE_EVAL,
                   "workspace", cfg.workspace, "scene", "grass",
                   "test_dataset.input_h_w", "[64, 96]"])
    finally:
        os.chdir(old)
    assert "network latency" in capsys.readouterr().out


def test_entries_raise_without_cuda_unless_cpu_asked(free, monkeypatch):
    """The default device is CUDA; with none present every entry raises
    instead of moving to the CPU."""
    cfg = free[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: runner.make_network(cfg), lambda: runner.run_evaluate(cfg),
                 lambda: tlpips.fixture_lpips(),
                 lambda: trun.main(["--type", "evaluate", "--cfg_file", FREE_EVAL,
                                    "workspace", cfg.workspace, "scene", "grass"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert runner.make_network(cfg, "cpu").device.type == "cpu"
