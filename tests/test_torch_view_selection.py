"""The view selection's coverage masks and greedy picks against JAX.

BoostENeRF on the Free fixture at 64x96 (tests/test_data.py's scene, 4
source views, C(4,3) = 4 combinations) from
configs/exps/evaluate/enerf_ours/free_eval.yaml; BoostMVSNeRF on the same
scene (6 views, 20 combinations) from
configs/exps/evaluate/mvsnerf_ours/free_eval.yaml, and its masks also on a
ScanNet fixture at 64x96. The same seeded reference-named weights go to
JAX through ``port_enerf`` / ``port_mvsnerf``. The JAX model takes its exact path (gather warp and
sampling, XLA head, float32, one jit per combination). Bars: masks at atol
1e-5 against JAX; the port's folded ``forward_view_selection`` (chunks of
``k_best`` combinations in the batch axis, the FPN once over all views)
within 1e-6 of its per-combination ``combo_coverage_mask`` loop.
"""

import dataclasses
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import make_cfg
from boostmvsnerfs_torch.data import make_dataset
from boostmvsnerfs_torch.data.loader import Loader
from boostmvsnerfs_torch.models.boost_enerf import greedy_steps, view_combinations
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.synthetic import write_free_scene, write_scannet_scene
from boostmvsnerfs_tpu import runner as jrunner
from boostmvsnerfs_tpu.config import make_cfg as jax_make_cfg
from boostmvsnerfs_tpu.utils.port_weights import port_enerf, port_mvsnerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
# the JAX model's exact path on the CPU: gather warp and sampling, the XLA
# head, a float32 warp (the port's CPU path), one jit per combination
JAX_EXACT = ["enerf.cas_config.warp_mode", "gather", "enerf.cas_config.eval_sampling", "gather",
             "enerf.cas_config.eval_head", "xla", "enerf.cas_config.warp_dtype", "float32",
             "execution", "jit"]


def _setup(tmp, cfg_file, opts, state_fn):
    """(port cfg, model, JAX cfg, JAX mask function, variables, first test
    batch). One JAX mask function per setup: each ``make_mask_fn`` call
    jits anew."""
    old = os.getcwd()
    os.chdir(REPO)
    try:
        cfg = make_cfg(cfg_file, ["workspace", tmp] + opts)
        jcfg = jax_make_cfg(cfg_file, ["workspace", tmp] + opts + JAX_EXACT)
    finally:
        os.chdir(old)
    model = runner.make_network(cfg, "cpu")
    sd = random_state_dict(model, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    batch = next(iter(Loader(make_dataset(cfg, "test"), 1)))
    mask_fn = jrunner.make_mask_fn(jcfg, jrunner.make_network(jcfg))
    return cfg, model, jcfg, mask_fn, state_fn(sd), batch


@pytest.fixture(scope="module")
def enerf(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    write_free_scene(f"{ws}/Free", "grass")
    return _setup(ws, "configs/exps/evaluate/enerf_ours/free_eval.yaml",
                  ["scene", "grass", "test_dataset.input_h_w", "[64, 96]",
                   "enerf.test_input_views", "4", "enerf.cas_config.k_best", "3"], port_enerf)


@pytest.fixture(scope="module")
def mvsnerf(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    write_free_scene(f"{ws}/Free", "grass")
    return _setup(ws, "configs/exps/evaluate/mvsnerf_ours/free_eval.yaml",
                  ["scene", "grass", "test_dataset.input_h_w", "[64, 96]"], port_mvsnerf)


@pytest.fixture(scope="module")
def mvsnerf_scannet(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    write_scannet_scene(f"{ws}/scannet_plus", "scene0000_01", n=8, H=64, W=96)
    return _setup(ws, "configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml",
                  ["scene", "scene0000_01", "test_dataset.input_h_w", "[64, 96]"], port_mvsnerf)


def _arrays(batch):
    return {k: v for k, v in batch.items() if k != "meta"}


def _jax_masks(setup, combos) -> np.ndarray:
    _, _, _, mask_fn, variables, batch = setup
    jb = {k: jnp.asarray(v) for k, v in _arrays(batch).items()}
    return np.stack([np.asarray(mask_fn(variables, jb, jnp.asarray(c))) for c in combos])


def _combos(setup):
    return view_combinations(setup[5]["all_src_inps"].shape[1], 3)


@pytest.fixture(scope="module")
def enerf_masks(enerf):
    combos = _combos(enerf)
    model, b = enerf[1], _arrays(enerf[5])
    loop = np.stack([model.combo_coverage_mask(b, c).numpy() for c in combos])
    return loop, _jax_masks(enerf, combos)


def test_enerf_fixture_geometry(enerf):
    batch = enerf[5]
    assert batch["all_src_inps"].shape == (1, 4, 64, 96, 3)
    assert len(_combos(enerf)) == 4


def test_boost_enerf_masks_match_jax(enerf_masks):
    got, want = enerf_masks
    assert got.shape == want.shape == (4, 1, 64, 96)
    assert 0.0 < want.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k_best", [1, 3, 4])
def test_folded_view_selection_matches_per_combination_loop(enerf, enerf_masks, k_best):
    """Chunks of k_best combinations (3 + 1 at k_best 3: a short last
    chunk) against one combination at a time with the FPN on its views."""
    model = enerf[1]
    model.cas = dataclasses.replace(model.cas, k_best=k_best)
    try:
        folded = model.forward_view_selection(_arrays(enerf[5]), _combos(enerf)).numpy()
    finally:
        model.cas = dataclasses.replace(model.cas, k_best=3)
    np.testing.assert_allclose(folded, enerf_masks[0], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def mvsnerf_masks(mvsnerf):
    combos = _combos(mvsnerf)
    return (mvsnerf[1].forward_view_selection(_arrays(mvsnerf[5]), combos).numpy(),
            _jax_masks(mvsnerf, combos))


def test_boost_mvsnerf_masks_match_jax(mvsnerf, mvsnerf_masks):
    assert len(_combos(mvsnerf)) == 20
    got, want = mvsnerf_masks
    assert got.shape == want.shape == (20, 1, 64, 96)
    assert 0.0 < want.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_boost_mvsnerf_folded_matches_per_combination_loop(mvsnerf, mvsnerf_masks):
    """Chunks of k_best combinations over every view's visibility, computed
    once, against one combination at a time: the same sums of 0/1 terms,
    so equal exactly."""
    model, b = mvsnerf[1], _arrays(mvsnerf[5])
    loop = np.stack([model.combo_coverage_mask(b, c).numpy() for c in _combos(mvsnerf)])
    np.testing.assert_array_equal(mvsnerf_masks[0], loop)


def test_boost_mvsnerf_masks_match_jax_off_the_border_rows(mvsnerf_scannet):
    """The ScanNet fixture's cameras differ only along x, so the first and
    last rows' samples project exactly onto the views' top and bottom
    edges, where a 1-ulp difference flips a view (ROADMAP fault 4): there
    the masks may differ, and everywhere else they agree."""
    combos = _combos(mvsnerf_scannet)
    got = mvsnerf_scannet[1].forward_view_selection(_arrays(mvsnerf_scannet[5]), combos).numpy()
    want = _jax_masks(mvsnerf_scannet, combos)
    assert got.shape == want.shape == (20, 1, 64, 96)
    np.testing.assert_allclose(got[:, :, 1:-1], want[:, :, 1:-1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["enerf", "mvsnerf"])
def test_greedy_select_matches_jax(request, family):
    """Equal picks, and each step's winning margin exceeds what the masks'
    largest difference d could move a ranking: a share moves by at most d
    through its own mask and d per earlier pick through the coverage so
    far, so two shares by at most 2 (k + 1) d."""
    setup = request.getfixturevalue(family)
    masks, jax_masks = request.getfixturevalue(f"{family}_masks")
    cfg, model, _, mask_fn, variables, batch = setup
    k = int(cfg.enerf.cas_config.k_best)
    combos = _combos(setup)
    picks = runner.greedy_select(model, _arrays(batch), combos, k)
    jb = {key: jnp.asarray(v) for key, v in _arrays(batch).items()}
    want = jrunner.greedy_select(mask_fn, variables, jb, jnp.asarray(combos), k)
    np.testing.assert_array_equal(picks, want)
    masks, jax_masks = masks[:, 0], jax_masks[:, 0]
    d = float(np.abs(masks - jax_masks).max())
    greedy, margins = greedy_steps(masks, k)
    assert greedy == list(picks[0])
    assert all(margin > 2 * (k + 1) * d for margin in margins), (margins, d)
