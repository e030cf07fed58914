"""The port's converter of the paper's ``.pth`` checkpoints
(``python -m boostmvsnerfs_torch.convert_ckpt``, ``utils/convert_ckpt.py``)
against JAX's route, on the CPU.

Each case writes a reference-layout ``.pth`` (``{"net": state_dict}``, with
an optimizer entry beside it as the reference's training checkpoints have)
from ``utils/port_weights.random_state_dict`` and converts it two ways: the
port's converter, and JAX's ``port_enerf`` / ``port_mvsnerf`` followed by the
port's ``enerf_state_dict_from_jax`` / ``mvsnerf_state_dict_from_jax``. Bar:
equal tensors under equal keys. JAX's ``port_mvsnerf`` carries only the
``v0`` head's layers, so for the attention head (v1) the JAX route holds
the shared keys and the converter adds the attention block's.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.utils import convert_ckpt
from boostmvsnerfs_torch.utils.port_weights import (
    enerf_state_dict_from_jax,
    mvsnerf_state_dict_from_jax,
    random_state_dict,
)
from boostmvsnerfs_torch.utils.synthetic import write_free_scene
from boostmvsnerfs_tpu.utils.port_weights import port_enerf, port_mvsnerf
from tests.test_torch_runner import FREE_EVAL, REPO, _cfgs

ABN_PREFIXES = ("feature.", "cost_reg_2.")  # the reference MVSNeRF's InPlaceABN nets


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_state_dict(family: str, seed: int = 0, **kw) -> dict:
    """A reference-layout state dict: seeded weights under the port's
    names, as the reference's modules name them. ENeRF keeps its batch
    norms' ``num_batches_tracked``; MVSNeRF's InPlaceABN blocks have none,
    and ``Renderer_attention`` (v1) holds one tensor under each of its tied
    ``pts_linears.1..D-1``."""
    model = convert_ckpt.build_model(family, kw.pop("names", ()), **kw)
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(model, seed).items()}
    if family == "mvsnerf":
        sd = {k: v for k, v in sd.items()
              if not (k.startswith(ABN_PREFIXES) and k.endswith("num_batches_tracked"))}
        if any(".color_attention." in k for k in sd):  # the attention head (v1)
            for i in range(2, model.cfg.mlp_depth):
                for leaf in ("weight", "bias"):
                    sd[f"nerf.nerf.pts_linears.{i}.{leaf}"] = sd[f"nerf.nerf.pts_linears.1.{leaf}"]
    return sd


CASES = {
    "enerf": ("enerf", {}, lambda sd: enerf_state_dict_from_jax(port_enerf(sd, 2, True))),
    "enerf_no_viewdir_agg": ("enerf", {"viewdir_agg": False},
                             lambda sd: enerf_state_dict_from_jax(port_enerf(sd, 2, False))),
    "mvsnerf_v0": ("mvsnerf", {}, lambda sd: mvsnerf_state_dict_from_jax(port_mvsnerf(sd, 6))),
    "mvsnerf_v1_tied": ("mvsnerf", {"names": ["nerf.nerf.color_attention.fc.weight"]},
                        lambda sd: mvsnerf_state_dict_from_jax(port_mvsnerf(sd, 6))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_converter_matches_the_jax_route(case, tmp_path):
    family, kw, jax_route = CASES[case]
    sd = reference_state_dict(family, **dict(kw))
    pth = str(tmp_path / "latest.pth")
    torch.save({"net": sd, "optim": {"state": {}, "lr": 5e-4}, "epoch": 3}, pth)
    args = [pth, str(tmp_path / "out"), "--family", family]
    if not kw.get("viewdir_agg", True):
        args.append("--no-viewdir-agg")
    out = convert_ckpt.main(args)
    assert out["left_out"] == []
    got = CheckpointManager(str(tmp_path / "out")).restore()["model"]
    want = jax_route({k: v.numpy() for k, v in sd.items()})
    if case == "mvsnerf_v1_tied":
        extra = sorted(set(got) - set(want))
        assert extra and all(k.startswith(("nerf.nerf.color_attention.", "nerf.nerf.weight_out."))
                             for k in extra)
        assert set(want) < set(got)
        for i in range(2, 6):  # the tied layers, each a copy of its own
            assert torch.equal(got[f"nerf.nerf.pts_linears.{i}.weight"],
                               sd["nerf.nerf.pts_linears.1.weight"])
            assert got[f"nerf.nerf.pts_linears.{i}.weight"].data_ptr() != \
                got["nerf.nerf.pts_linears.1.weight"].data_ptr()
    else:
        assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    model = convert_ckpt.build_model(family, list(got), **{k: v for k, v in kw.items()
                                                           if k != "names"})
    model.load_state_dict(got, strict=True)


def test_converter_lists_and_leaves_out_unknown_entries(tmp_path, capsys):
    sd = reference_state_dict("enerf", seed=1)
    sd["nerf_0.unused.weight"] = torch.ones(3)
    sd["optimizer_shadow.step"] = torch.zeros(())
    torch.save(sd, str(tmp_path / "bare.pth"))  # a bare state dict, no "net"
    out = convert_ckpt.main([str(tmp_path / "bare.pth"), str(tmp_path / "out")])
    assert out["left_out"] == ["nerf_0.unused.weight", "optimizer_shadow.step"]
    assert "left out 2 entries" in capsys.readouterr().out
    got = CheckpointManager(str(tmp_path / "out")).restore()["model"]
    assert "nerf_0.unused.weight" not in got and torch.equal(got["nerf_1.lr0.0.weight"],
                                                             sd["nerf_1.lr0.0.weight"])


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_converter_fails_on_a_bad_checkpoint(fault, tmp_path):
    sd = reference_state_dict("enerf")
    if fault == "missing":
        del sd["cost_reg_1.conv3.conv.weight"]
    else:
        sd["nerf_0.sigma.0.weight"] = torch.zeros(2, 2)
    torch.save({"net": sd}, str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError, match="Missing key|size mismatch"):
        convert_ckpt.main([str(tmp_path / "bad.pth"), str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out" / "latest.pt")


def test_cli_then_run_evaluate_reads_the_converted_weights(tmp_path, capsys):
    """``python -m boostmvsnerfs_torch.convert_ckpt`` exits 0 on a reference
    BoostENeRF checkpoint written into ``trained_model_dir``; ``run_evaluate``
    on the 64x96 Free fixture loads it (no random-init warning) and reads
    the psnr, to the bit, of the same weights saved directly as
    ``latest.pt``."""
    ws = str(tmp_path / "ws")
    write_free_scene(f"{ws}/Free", "grass")
    opts = ["workspace", ws, "scene", "grass", "test_dataset.input_h_w", "[64, 96]",
            "eval_lpips", "false"]
    direct, _ = _cfgs(FREE_EVAL, opts)
    conv, _ = _cfgs(FREE_EVAL, opts + ["exp_name_tag", "converted"])
    sd = {k: torch.from_numpy(v)
          for k, v in random_state_dict(runner.make_network(direct, "cpu"), 0).items()}
    CheckpointManager(direct.trained_model_dir).save({"model": sd}, 0)
    pth = str(tmp_path / "boost_enerf.pth")
    torch.save({"net": {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}},
               pth)
    r = subprocess.run([sys.executable, "-m", "boostmvsnerfs_torch.convert_ckpt", pth,
                        conv.trained_model_dir], cwd=REPO, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "saved to" in r.stdout and "left out 0 entries" in r.stdout

    old = os.getcwd()
    os.chdir(REPO)
    try:
        want = runner.run_evaluate(direct, device="cpu")
        os.makedirs(conv.result_dir, exist_ok=True)
        shutil.copy(runner.view_selection_path(direct), runner.view_selection_path(conv))
        capsys.readouterr()
        got = runner.run_evaluate(conv, device="cpu")
    finally:
        os.chdir(old)
    printed = capsys.readouterr().out
    assert f"loaded weights from {conv.trained_model_dir}" in printed
    assert "random init" not in printed
    assert np.isfinite(got["psnr"]) and got["psnr"] == want["psnr"]
    assert got["ssim"] == want["ssim"]
