"""The training entry from YAML (``runner.run_train(cfg)``, ``python -m
boostmvsnerfs_torch.train``) and the perceptual term against the JAX
package, on the CPU.

``run_train(cfg)`` runs the fine-tuning recipe
(configs/exps/finetune/enerf_ours/free/base.yaml: BoostENeRF K=4, both
levels on full images, lr 5e-5) on the Free fixture at 64x96, batch 1, 2
steps an epoch, from seeded pretrain weights; JAX's side is its
``make_train_step`` (its exact path, float32) on the batches of its own
``Loader`` and ``attach_boost_inputs``, at the level below its
``run_train``, whose flax initialisation alone would take minutes here.
Bars: the batches equal, each step's loss within 1e-4 relative (float32
on both sides; the second step follows the first's Adam update, in which
float32 rounding flips the sign of the smallest gradients); the
perceptual loss at rtol 1e-4 and its gradient at relative L2 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_tpu.models.boost_enerf import BoostENeRF as JaxBoostENeRF
from boostmvsnerfs_tpu.parallel import train as jt
from boostmvsnerfs_tpu.train.schedule import make_optimizer as jax_optimizer
from boostmvsnerfs_tpu.utils.port_weights import port_enerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this module: with several test
    processes sharing a machine's few cores, their pools' spinning threads
    slow each other down many times over, while these small tensors gain
    little from more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _write_vgg_npz(path: str) -> str:
    """Fixture VGG16 weights (flax's initialisation, seeded) in the format
    of JAX's ``convert_torchvision_weights``."""
    from boostmvsnerfs_tpu.eval.vgg import VGG16Features as JaxVGG

    params = JaxVGG().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    arrays = {}
    for name, p in params.items():
        arrays[f"{name}_kernel"] = np.asarray(p["kernel"])
        arrays[f"{name}_bias"] = np.asarray(p["bias"]) + 0.01 * np.arange(p["bias"].shape[0])
    np.savez(path, **arrays)
    return path


def test_perceptual_loss_matches_jax(tmp_path):
    """``perceptual_loss_fn`` over weights loaded from the converter's .npz
    against JAX's on the same images: the loss at rtol 1e-4 and its
    gradient with respect to the prediction at relative L2 1e-4."""
    from boostmvsnerfs_torch.eval.vgg import load_vgg, perceptual_loss_fn
    from boostmvsnerfs_tpu.eval import vgg as jvgg

    npz = _write_vgg_npz(str(tmp_path / "vgg.npz"))
    rng = np.random.default_rng(4)
    pred, tar = (rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(2))
    fn = perceptual_loss_fn(load_vgg(npz, "cpu"))
    p = torch.from_numpy(pred).requires_grad_()
    loss = fn(p, torch.from_numpy(tar))
    loss.backward()
    jfn = jvgg.perceptual_loss_fn(jvgg.load_vgg_params(npz))
    jloss, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(tar))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert _rel_l2(p.grad.numpy(), np.asarray(jgrad)) < 1e-4
    assert not any(q.requires_grad for q in load_vgg(npz, "cpu").parameters())


# ------------------------------------------------- the training entry (YAML)

FINETUNE = "configs/exps/finetune/enerf_ours/free/base.yaml"
# the recipe, shortened and at 64x96 (the Free fixture's size), batch 1
FT_OPTS = ["train_dataset.input_h_w", "[64, 96]", "test_dataset.input_h_w", "[64, 96]",
           "train.batch_size", "1", "train.num_workers", "2", "ep_iter", "2", "eval_ep", "1",
           "log_interval", "1", "save_ep", "1"]
JAX_EXACT = ["enerf.cas_config.warp_mode", "gather", "enerf.cas_config.eval_sampling", "gather",
             "enerf.cas_config.eval_head", "xla", "enerf.cas_config.warp_dtype", "float32"]


def _ft_cfg(ws, *opts, jax_side=False):
    """The fine-tuning recipe's config over workspace ``ws`` (read from the
    repository root, where ``parent_cfg`` paths resolve)."""
    import os
    from pathlib import Path

    from boostmvsnerfs_torch.config import make_cfg
    from boostmvsnerfs_tpu.config import make_cfg as jax_make_cfg

    old = os.getcwd()
    os.chdir(Path(__file__).resolve().parents[1])
    try:
        args = ["workspace", ws, "scene", "grass", *FT_OPTS, *opts]
        return jax_make_cfg(FINETUNE, args + JAX_EXACT) if jax_side else make_cfg(FINETUNE, args)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def finetune(tmp_path_factory):
    """``run_train(cfg)`` on the CPU over the fine-tuning recipe (BoostENeRF
    K=4, both levels on full images, lr 5e-5) on the Free fixture: one
    epoch of 2 steps from seeded pretrain weights, then a second run with
    ``train.epoch 2`` that resumes. Each step's batch and stats, and each
    record, are kept."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.utils.synthetic import write_free_scene

    ws = str(tmp_path_factory.mktemp("ft"))
    write_free_scene(f"{ws}/Free", "grass")
    cfg = _ft_cfg(ws, "train.epoch", "1")
    sd = random_state_dict(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(f"{ws}/trained_model/pretrain/enerf").save(
        {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, 0)
    seen, records = [], []
    make_step = runner.make_train_step

    def recording_step(model, *args):
        step = make_step(model, *args)
        return lambda state, batch: (seen.append(dict(batch)), step(state, batch))[1]

    run = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(runner, "make_train_step", recording_step)
    try:
        run["first"] = runner.run_train(cfg, device="cpu",
                                        on_record=lambda *r: records.append(r[::2]))
        run["resumed"] = runner.run_train(_ft_cfg(ws, "train.epoch", "2"), device="cpu",
                                          on_record=lambda *r: records.append(r[::2]))
    finally:
        mp.undo()
    return {"ws": ws, "cfg": cfg, "sd": sd, "batches": seen, "records": records, **run}


def test_run_train_matches_jax_steps(finetune):
    """The same batches as JAX's ``Loader`` and ``attach_boost_inputs`` give
    over the run's view selection, and each step's loss within 1e-4
    relative of JAX's ``make_train_step`` (its exact path, float32) from
    the same pretrain weights, the resumed epoch included."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_tpu import runner as jrunner
    from boostmvsnerfs_tpu.data import make_dataset as jax_make_dataset
    from boostmvsnerfs_tpu.data.loader import Loader as JaxLoader

    jcfg = _ft_cfg(finetune["ws"], "train.epoch", "2", jax_side=True)
    vs = runner.load_view_selection(finetune["cfg"])
    meta = jcfg.train.sampler_meta
    loader = JaxLoader(jax_make_dataset(jcfg, "train"), batch_size=1, shuffle=True, ep_iter=2,
                       input_views_num=runner.boost_views_num(meta.input_views_num, 3),
                       input_views_prob=meta.input_views_prob, num_workers=2)
    model = _jax_model_from_cfg(jcfg)
    tx = jax_optimizer(jcfg.train, 2)
    state = jt.create_train_state(model, tx, None, variables=port_enerf(finetune["sd"]))
    step_fn = jt.make_train_step(model, tx)
    want = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        for np_batch in loader:
            np_batch = jrunner.attach_boost_inputs(np_batch, vs, jcfg)
            batch = {k: v for k, v in np_batch.items() if k != "meta"}
            got_batch = finetune["batches"][len(want)]
            assert got_batch.keys() == batch.keys()
            for k, v in batch.items():
                assert np.array_equal(np.asarray(got_batch[k]), v), k
            state, stats = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
            want.append(float(stats["loss"]))
    got = [r["loss"] for kind, r in finetune["records"] if kind == "train"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _jax_model_from_cfg(jcfg):
    from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCas

    return JaxBoostENeRF(cas=JaxCas.from_cfg(jcfg.enerf))


def test_run_train_resumes_validates_and_saves(finetune, capsys):
    """Warm start from the pretrain checkpoint, a validation record per
    epoch (``eval_ep`` 1), a checkpoint per epoch, the view selection over
    the train and test views, and the second run resuming at epoch 1 for
    the remaining 2 steps."""
    records, cfg = finetune["records"], finetune["cfg"]
    kinds = [(kind, r["epoch"]) for kind, r in records]
    assert kinds == [("train", 0), ("train", 0), ("val", 0), ("train", 1), ("train", 1),
                     ("val", 1)]
    for kind, r in records:
        if kind == "val":
            assert np.isfinite(r["val_psnr"]) and np.isfinite(r["val_ssim"])
    assert finetune["first"].step == 2 and finetune["resumed"].step == 4
    assert CheckpointManager(cfg.trained_model_dir).numbered_epochs() == [0, 1]
    from boostmvsnerfs_torch import runner

    vs = runner.load_view_selection(cfg)
    train_views = [i for i in range(16) if i % 8]
    assert sorted(vs) == sorted(f"grass_{i}" for i in [0, 8] + train_views)
    assert all(vs[f"grass_{i}"] == [0, 0, 0, 0] for i in train_views)  # 3 views: C(3,3) = 1
    moved = CheckpointManager(cfg.trained_model_dir).restore()["model"]
    assert any(not np.array_equal(moved[k].numpy(), v) for k, v in finetune["sd"].items())


def _with_view_selection(cfg, like):
    """``cfg`` with the view selection of config ``like`` in its result dir."""
    import os
    import shutil

    from boostmvsnerfs_torch import runner

    os.makedirs(cfg.result_dir, exist_ok=True)
    shutil.copy(runner.view_selection_path(like), runner.view_selection_path(cfg))
    return cfg


def test_run_train_goes_on_after_a_failed_validation(finetune, monkeypatch, capsys):
    from boostmvsnerfs_torch import runner

    def fail(*args, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(runner, "run_evaluate", fail)
    cfg = _with_view_selection(_ft_cfg(finetune["ws"], "train.epoch", "1", "ep_iter", "1",
                                       "exp_name_tag", "failval"), finetune["cfg"])
    state = runner.run_train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert state.step == 1 and "validation failed: RuntimeError('planted')" in out
    assert "warm start from" in out


def test_boost_views_num_raises_counts_below_a_combination():
    """ROADMAP fault 13: the recipe's view counts [2, 3, 4] give a boost
    model batches of 2 views, which have no 3-view combination; JAX's
    ``attach_boost_inputs`` leaves an empty table (its step fails), the
    port draws 3 views instead, from the same random stream."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_tpu import runner as jrunner

    assert runner.boost_views_num([2, 3, 4], 3) == [3, 3, 4]
    assert runner.boost_views_num(None, 3) is None
    batch = {"all_src_inps": np.zeros((1, 2, 8, 8, 3)), "meta": [{"scene": "s", "tar_view": 1}]}
    out = jrunner.attach_boost_inputs(batch, {"s_1": [0, 0]}, {"enerf": {}})
    assert out["combos"].size == 0 and (out["k_best"] < 0).all()
    with pytest.raises((TypeError, IndexError)):  # the fold's combos[k_best]
        jnp.asarray(out["combos"])[jnp.asarray(out["k_best"])]


def test_train_cli_on_the_cpu_and_refusals(finetune, capsys, monkeypatch):
    """``python -m boostmvsnerfs_torch.train --device cpu`` over the recipe
    (one step, ray-blocked); without CUDA the default device raises;
    ``--distributed`` without torchrun's environment raises, and so does ray
    blocking an MVSNeRF model (the blocked step renders ENeRF levels)."""
    from pathlib import Path

    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.train import __main__ as tmain

    monkeypatch.chdir(Path(__file__).resolve().parents[1])
    opts = ["train.epoch", "1", "ep_iter", "1", "eval_ep", "0", "exp_name_tag", "cli"]
    _with_view_selection(_ft_cfg(finetune["ws"], *opts), finetune["cfg"])
    argv = ["--cfg_file", FINETUNE, "workspace", finetune["ws"], "scene", "grass", *FT_OPTS,
            *opts]
    state = tmain.main(["--device", "cpu", "--ray_blocks", "2", *argv])
    assert state.step == 1 and "epoch 0 iter 0/1" in capsys.readouterr().out
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmain.main(["--distributed", *argv])
    cfg = _ft_cfg(finetune["ws"], "network_module", "boostmvsnerfs_tpu.models.boost_mvsnerf")
    with pytest.raises(ValueError, match="trains unblocked"):
        runner.run_train(cfg, device="cpu", ray_blocks=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_train(finetune["cfg"])


def test_run_train_adds_the_perceptual_term(finetune, tmp_path):
    """With ``vgg_weights`` naming converted weights, both full-image levels
    add 0.01 x their loss weight x the perceptual loss (reference
    lib/train/losses/enerf.py:30-38)."""
    from boostmvsnerfs_torch import runner

    npz = _write_vgg_npz(str(tmp_path / "vgg.npz"))
    cfg = _with_view_selection(_ft_cfg(finetune["ws"], "train.epoch", "1", "ep_iter", "1",
                                       "eval_ep", "0", "exp_name_tag", "vgg", "vgg_weights", npz),
                               finetune["cfg"])
    records = []
    runner.run_train(cfg, device="cpu", on_record=lambda kind, state, r: records.append(r))
    r = records[0]
    want = sum(w * (r[f"color_mse_{i}"] + 0.01 * r[f"perceptual_loss_{i}"])
               for i, w in enumerate((0.1, 1.0)))
    assert r["perceptual_loss_0"] > 0 and r["perceptual_loss_1"] > 0
    np.testing.assert_allclose(r["loss"], want, rtol=1e-6)
