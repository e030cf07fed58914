"""The port's metrics, LPIPS and evaluator against JAX's.

The same numpy inputs go through both packages: PSNR, masked PSNR, SSIM
and the DTU depth metrics at rtol 1e-5; LPIPS with JAX's fixture VGG16 and
head weights carried across (``vgg_state_dict_from_jax``) at rtol 1e-4;
the ``Evaluator``'s per-scene summary, LPIPS and depth included, on the
same outputs and batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.eval import metrics
from boostmvsnerfs_torch.eval.evaluator import Evaluator
from boostmvsnerfs_torch.eval.lpips import LPIPS, fixture_lpips, load_lpips
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.utils.port_weights import vgg_state_dict_from_jax
from boostmvsnerfs_tpu.eval import metrics as jmetrics
from boostmvsnerfs_tpu.eval.evaluator import Evaluator as JaxEvaluator
from boostmvsnerfs_tpu.eval.lpips import fixture_lpips as jax_fixture_lpips
from boostmvsnerfs_tpu.eval.lpips import load_lpips as jax_load_lpips
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL = 1e-5


def _images(seed, shape=(40, 56, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(40, 56, 3), (33, 47)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _images(0, shape)
    for fn, jfn in ((metrics.psnr, jmetrics.psnr), (metrics.ssim, jmetrics.ssim)):
        got = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(jfn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_masked_psnr_matches_jax():
    a, b = _images(1)
    msk = np.random.default_rng(2).uniform(size=a.shape[:2]) > 0.3
    got = float(metrics.masked_psnr(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(msk)))
    want = float(jmetrics.masked_psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(msk)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_depth_metrics_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(425, 905, (30, 40)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0
    pred = (gt + rng.normal(0, 6, gt.shape)).astype(np.float32)
    got = metrics.depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.depth_metrics(pred, gt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX's fixture LPIPS and the port's LPIPS with its weights."""
    jax_lp = jax_fixture_lpips(0)
    lins = [np.asarray(w) for w in jax_lp.lin_weights]
    return LPIPS(vgg_state_dict_from_jax(jax_lp.vgg_variables), lins, device="cpu"), jax_lp


def test_lpips_matches_jax(lpips_pair):
    lp, jax_lp = lpips_pair
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (2, 48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    got = lp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_lp(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(lp(torch.from_numpy(a), torch.from_numpy(a)).abs().max()) == 0.0


def test_load_lpips_reads_the_jax_packages_files(tmp_path, lpips_pair):
    """``load_lpips`` reads the two .npz files JAX's ``load_lpips`` reads
    (VGG16 ``conv{i}_kernel`` HWIO / ``conv{i}_bias``; heads ``lin{i}``)."""
    _, jax_lp = lpips_pair
    params = jax_lp.vgg_variables["params"]
    vgg = {f"{n}_{leaf}": np.asarray(p[leaf]) for n, p in params.items()
           for leaf in ("kernel", "bias")}
    np.savez(tmp_path / "vgg.npz", **vgg)
    np.savez(tmp_path / "lin.npz", **{f"lin{i}": np.asarray(w)
                                      for i, w in enumerate(jax_lp.lin_weights)})
    lp = load_lpips(str(tmp_path / "vgg.npz"), str(tmp_path / "lin.npz"), device="cpu")
    jlp = jax_load_lpips(str(tmp_path / "vgg.npz"), str(tmp_path / "lin.npz"))
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-1, 1, (1, 32, 40, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(lp(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jlp(jnp.asarray(a), jnp.asarray(b))), rtol=1e-4)


def test_fixture_lpips_is_seeded():
    a = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    b = a.flip(1)
    d0, d0b, d1 = (fixture_lpips(s, device="cpu")(a, b) for s in (0, 0, 1))
    assert torch.equal(d0, d0b) and not torch.equal(d0, d1)
    assert bool(torch.isfinite(d0).all()) and float(d0) > 0


def _eval_case(seed, B=2, H=24, W=32, scene="grass"):
    """One batch and output of a 2-level cascade rendering only level 1,
    with a mask and DTU-style depths."""
    rng = np.random.default_rng(seed)
    n = H * W
    gt = rng.uniform(size=(B, n, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    dpt = rng.uniform(425, 905, (B, H, W)).astype(np.float32)
    batch = {"rgb_1": gt, "msk_1": (rng.uniform(size=(B, n)) > 0.1),
             "tar_dpt": dpt,
             "meta": [{"scene": scene, "tar_view": 8 * b + seed, "frame_id": 0, "h_0": H // 4,
                       "w_0": W // 4, "h_1": H, "w_1": W} for b in range(B)]}
    out = {"rgb_level1": pred, "depth_level1": (dpt + rng.normal(0, 3, dpt.shape)).reshape(B, n),
           "depth_mvs_level1": dpt[:, ::2, ::2] + 4.0}
    return out, batch


@pytest.mark.parametrize("eval_center", [False, True])
def test_evaluator_summary_matches_jax(tmp_path, lpips_pair, eval_center):
    lp, jax_lp = lpips_pair
    kw = dict(lpips_key="lpips_uncalibrated", eval_depth=True, eval_center=eval_center,
              save_result=True)
    render_if = (False, True)
    ev = Evaluator(CascadeConfig(render_if=render_if), lpips_fn=lp,
                   result_dir=str(tmp_path / "port"), **kw)
    jev = JaxEvaluator(JaxCascadeConfig(render_if=render_if), eval_lpips=True, lpips_fn=jax_lp,
                       result_dir=str(tmp_path / "jax"), **kw)
    for seed, scene in ((0, "grass"), (1, "grass"), (2, "lab")):
        out, batch = _eval_case(seed, scene=scene)
        ev.evaluate({k: torch.from_numpy(v) for k, v in out.items()}, batch)
        jev.evaluate(out, batch)
    assert ev.scene_psnrs.keys() == jev.scene_psnrs.keys() == {"grass_level1", "lab_level1"}
    got, want = ev.summarize(), jev.summarize()
    assert got.keys() == want.keys()
    assert {"psnr", "ssim", "lpips_uncalibrated", "abs", "mvs_acc_10"} <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4 if "lpips" in k else RTOL,
                                   err_msg=k)
    saved = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert saved == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(saved) == 6 and ev.psnrs == []  # summarize resets
