"""The port's config system and ``from_cfg`` constructors against JAX's.

Every YAML under configs/ resolves its ``parent_cfg`` chain in both
packages to equal trees; ``CascadeConfig.from_cfg`` and
``MVSNeRFConfig.from_cfg`` agree with JAX's on every field the port has;
the TPU knobs are dropped by name, and every setting the port does not have
raises instead of being dropped.
"""

import dataclasses
import glob
import os
from pathlib import Path

import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import CfgNode, default_cfg, finalize_cfg, make_cfg
from boostmvsnerfs_torch.models.enerf import REFUSED, TPU_KNOBS, CascadeConfig
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
from boostmvsnerfs_tpu import config as jconfig
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.models.mvsnerf import MVSNeRFConfig as JaxMVSNeRFConfig

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(str(REPO / "configs" / "**" / "*.yaml"), recursive=True))
EXPERIMENTS = [p for p in CONFIGS if p != os.path.join("configs", "default.yaml")]


@pytest.fixture
def at_repo(monkeypatch):
    """``parent_cfg`` paths are relative to the repository root in both
    packages."""
    monkeypatch.chdir(REPO)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_matrix_is_complete():
    assert len(EXPERIMENTS) >= 90


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_loads_to_jax_tree(at_repo, path):
    opts = ["workspace", "/data/ws", "scene", "grass", "enerf.cas_config.k_best", "3"]
    got = make_cfg(path, opts)
    want = jconfig.make_cfg(path, opts)
    assert isinstance(got, CfgNode)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_cascade_from_cfg_matches_jax(at_repo, path):
    cfg = make_cfg(path)
    want = _fields(JaxCascadeConfig.from_cfg(jconfig.make_cfg(path).enerf))
    got = _fields(CascadeConfig.from_cfg(cfg.enerf))
    assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("path", [p for p in EXPERIMENTS if "mvsnerf" in p])
def test_mvsnerf_from_cfg_matches_jax(at_repo, path):
    got = _fields(MVSNeRFConfig.from_cfg(make_cfg(path)))
    want = _fields(JaxMVSNeRFConfig.from_cfg(jconfig.make_cfg(path)))
    assert got == {k: want[k] for k in got}


def test_cascade_fields_are_jaxs_without_its_tpu_knobs():
    """Every field of JAX's CascadeConfig is the port's, a TPU knob the
    port drops by name, or a setting it refuses."""
    jax_fields = {f.name for f in dataclasses.fields(JaxCascadeConfig)}
    own = {f.name for f in dataclasses.fields(CascadeConfig)}
    assert own | set(TPU_KNOBS) | set(REFUSED) == jax_fields
    assert not own & (set(TPU_KNOBS) | set(REFUSED))


@pytest.mark.parametrize("knob", TPU_KNOBS)
def test_tpu_knobs_are_dropped(at_repo, knob):
    cfg = make_cfg("configs/exps/evaluate/enerf_ours/free_eval.yaml")
    base = CascadeConfig.from_cfg(cfg.enerf)
    cfg.enerf.cas_config[knob] = getattr(JaxCascadeConfig(), knob)
    assert CascadeConfig.from_cfg(cfg.enerf) == base


def test_amp_config_takes_bf16_convolutions(at_repo):
    """The AMP recipe's ``conv_dtype: bfloat16`` reaches the model's FPN and
    both cost-regularisation nets; an unknown type raises."""
    cfg = make_cfg("configs/exps/pretrain/enerf/dtu_pretrain_amp.yaml")
    assert CascadeConfig.from_cfg(cfg.enerf).conv_dtype == "bfloat16"
    model = runner.make_network(cfg, "cpu")
    nets = [model.feature_net, model.cost_reg_0, model.cost_reg_1]
    assert all(net.dtype == torch.bfloat16 for net in nets)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    cfg.enerf.cas_config.conv_dtype = "float16"
    with pytest.raises(ValueError, match="conv_dtype"):
        CascadeConfig.from_cfg(cfg.enerf)


@pytest.mark.parametrize("key,value,match", [
    ("min_cost_reg_all", True, "queue 1 item 7"),
    ("use_vox_feat", False, "queue 1 item 7"),
])
def test_refused_cascade_settings_raise(at_repo, key, value, match):
    cfg = make_cfg("configs/exps/evaluate/enerf_ours/free_eval.yaml")
    cfg.enerf.cas_config[key] = REFUSED[key][0]
    CascadeConfig.from_cfg(cfg.enerf)  # the one value the port takes
    cfg.enerf.cas_config[key] = value
    with pytest.raises(NotImplementedError, match=match):
        CascadeConfig.from_cfg(cfg.enerf)
    with pytest.raises(NotImplementedError, match=match):
        runner.make_network(cfg, "cpu")


def test_unknown_cascade_setting_raises(at_repo):
    cfg = make_cfg("configs/exps/evaluate/enerf_ours/free_eval.yaml")
    cfg.enerf.cas_config.volume_planez = [64, 8]
    with pytest.raises(ValueError, match="volume_planez"):
        CascadeConfig.from_cfg(cfg.enerf)


@pytest.mark.parametrize("key,value,error,match", [
    ("net_type", "v3", ValueError, "net_type"),
    ("net_type", "colour_fusion", ValueError, "net_type"),
    ("feat_dim", 16, NotImplementedError, "8 channels"),
])
def test_refused_mvsnerf_settings_raise(at_repo, key, value, error, match):
    """Every JAX ``net_type`` is taken (tests/test_torch_mvsnerf_heads.py);
    an unknown one raises, as does a volume other than 8 channels."""
    cfg = make_cfg("configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml")
    cfg.mvsnerf[key] = value
    with pytest.raises(error, match=match):
        MVSNeRFConfig.from_cfg(cfg)


@pytest.mark.parametrize("name", ["enerf_composite", "enerf_human"])
def test_variant_networks_raise(at_repo, name):
    cfg = make_cfg("configs/exps/evaluate/enerf/free_eval.yaml",
                   ["network_module", f"boostmvsnerfs_tpu.models.{name}"])
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        runner.make_network(cfg, "cpu")


@pytest.mark.parametrize("path,cls", [
    ("configs/exps/evaluate/enerf/free_eval.yaml", "ENeRF"),
    ("configs/exps/evaluate/enerf_ours/free_eval.yaml", "BoostENeRF"),
    ("configs/exps/evaluate/mvsnerf/scannet_plus_eval.yaml", "MVSNeRF"),
    ("configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml", "BoostMVSNeRF"),
])
def test_make_network_dispatch(at_repo, path, cls):
    cfg = make_cfg(path)
    model = runner.make_network(cfg, "cpu")
    assert type(model).__name__ == cls
    assert model.device == torch.device("cpu") and not model.training
    assert runner.requires_view_selection(cfg) == cls.startswith("Boost")


@pytest.mark.parametrize("opts", [
    ["train.lr", "1e-3", "exp_name", "abc", "other_opts", "ignored", "x"],
    ["eval_lpips", "0", "enerf.cas_config.volume_planes", "[32, 4]", "new.key", "yes"],
])
def test_merge_from_list_matches_jax(opts):
    got, want = default_cfg(), jconfig.default_cfg()
    got.merge_from_list(list(opts))
    want.merge_from_list(list(opts))
    assert got.to_dict() == want.to_dict()


def test_odd_override_list_raises():
    with pytest.raises(ValueError, match="key/value pairs"):
        default_cfg().merge_from_list(["train.lr"])


def test_derived_dirs_match_jax():
    got, want = default_cfg(), jconfig.default_cfg()
    for cfg in (got, want):
        cfg.update(task="t", exp_name="e", exp_name_tag="x", workspace="/ws", save_tag="s")
    finalize_cfg(got)
    jconfig.finalize_cfg(want)
    assert got.to_dict() == want.to_dict()
    assert got.result_dir == os.path.join("/ws", "result", "t", "e_x", "s")
