"""The port's row-block executor (``parallel/staged.StagedMVSNeRF``) and
``runner.make_forward`` against the JAX package's, on the CPU.

The slice of tests/test_torch_mvsnerf.py: MVSNeRF and BoostMVSNeRF at 64x96
(4 views, K=2 of C(4,3), pad 24, the published MLP widths, 8 samples, every
pixel), the same seeded weights in both packages (``port_mvsnerf``). With
``row_chunk=16`` the 64 raster rows render in 4 blocks. Bars: against JAX's
``StagedMVSNeRF(row_chunk=16)`` the model bar of tests/test_torch_mvsnerf.py,
rgb PSNR > 45 dB (JAX's warp is windowed, exact here where H/4 <= 32:
ROADMAP fault 5); against the port's own model forward 1e-5, since the
volume is built once by the same call and every later step works per ray.
Torch runs at one intra-op thread.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.config import make_cfg
from boostmvsnerfs_torch.models import mvsnerf as tm
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.parallel import staged
from boostmvsnerfs_torch.train.checkpoint import CheckpointManager
from boostmvsnerfs_torch.utils.port_weights import mvsnerf_state_dict_from_jax, random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch, mvsnerf_batch, write_scannet_scene
from boostmvsnerfs_tpu import runner as jrunner
from boostmvsnerfs_tpu.config import make_cfg as jax_make_cfg
from boostmvsnerfs_tpu.models import mvsnerf as jm
from boostmvsnerfs_tpu.models.boost_mvsnerf import BoostMVSNeRF as JaxBoostMVSNeRF
from boostmvsnerfs_tpu.parallel.staged import StagedMVSNeRF as JaxStagedMVSNeRF
from boostmvsnerfs_tpu.utils.port_weights import port_mvsnerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
SLICE = dict(num_samples=8, k_best=2)
H, W = 64, 96
ROW_CHUNK = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{name: (port model on the CPU, JAX model)} with the same weights, and
    the JAX variables."""
    plain = tm.MVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    variables = port_mvsnerf(random_state_dict(plain, 0))
    plain.load_state_dict(mvsnerf_state_dict_from_jax(variables), strict=True)
    boost = BoostMVSNeRF(tm.MVSNeRFConfig(**SLICE), device="cpu")
    boost.load_state_dict(plain.state_dict(), strict=True)
    cfg = jm.MVSNeRFConfig(**SLICE)
    return {"plain": (plain, jm.MVSNeRF(cfg)), "boost": (boost, JaxBoostMVSNeRF(cfg))}, variables


@pytest.fixture(scope="module")
def batch():
    return mvsnerf_batch(make_scene_batch(B=1, n_views=4, H=H, W=W, boost=True, seed=0,
                                          rig="forward", render_scales=(1.0,)), k_best=(0, 3))


@pytest.fixture(scope="module")
def frames(models, batch):
    """{name: (port staged, JAX staged, port model forward)} outputs."""
    nets, variables = models
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name, (model, jax_model) in nets.items():
        got = staged.StagedMVSNeRF(model, row_chunk=ROW_CHUNK)(batch)
        want = JaxStagedMVSNeRF(jax_model, row_chunk=ROW_CHUNK)(variables, jbatch)
        out[name] = ({k: v.numpy() for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()},
                     {k: v.numpy() for k, v in model(batch).items()})
    return out


def test_the_frame_renders_in_four_row_blocks(batch):
    ids = torch.as_tensor(batch["ray_idx_0"])
    blocks = staged.ray_blocks(ids, W, ROW_CHUNK)
    assert [b.shape[1] for b in blocks] == [ROW_CHUNK * W] * 4
    assert torch.equal(torch.cat(blocks, 1), ids)


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_staged_matches_jax_staged(frames, name, record_property):
    got, want, _ = frames[name]
    assert got.keys() == want.keys() == {"rgb_level0", "depth_level0", "weights_level0"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
    psnr = -10 * np.log10(np.mean((got["rgb_level0"] - want["rgb_level0"]) ** 2))
    record_property("rgb_psnr_db", float(psnr))
    assert psnr > 45.0


@pytest.mark.parametrize("name", ["boost", "plain"])
def test_staged_matches_the_model_forward(frames, name):
    got, _, want = frames[name]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def _random_rays(batch, n=1000):
    ids = np.random.default_rng(3).choice(H * W, n, replace=False)[None]
    return dict(batch, ray_idx_0=ids.astype(batch["ray_idx_0"].dtype))


@pytest.mark.parametrize("case,row_chunk", [("random rays", ROW_CHUNK),
                                            ("rows not a multiple", 24),
                                            ("rows within one block", 64)])
def test_one_block_cases(models, batch, case, row_chunk, monkeypatch):
    """Random rays (N not whole rows), 64 rows in chunks of 24, and 64 rows
    in chunks of 64 each render as one block, equal to the model's forward;
    JAX's rule splits them the same way."""
    nets, _ = models
    b = _random_rays(batch) if case == "random rays" else batch
    ids = torch.as_tensor(b["ray_idx_0"])
    assert len(staged.ray_blocks(ids, W, row_chunk)) == 1
    assert len(JaxStagedMVSNeRF._ray_blocks(
        type("S", (), {"row_chunk": row_chunk})(), b["ray_idx_0"], W)) == 1
    model = nets["boost"][0]
    calls = []
    render_rays = model.render_rays

    def counted(sub, volume, ray_idx, near, far):
        calls.append(ray_idx.shape)
        return render_rays(sub, volume, ray_idx, near, far)

    monkeypatch.setattr(model, "render_rays", counted)
    got = staged.StagedMVSNeRF(model, row_chunk=row_chunk)(b)
    assert calls == [ids.shape]
    want = model(b)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("N,width,row_chunk", [(64 * 96, 96, 16), (64 * 96, 96, 32),
                                               (480 * 736, 736, 32), (224 * 352, 352, 32),
                                               (64 * 96, 96, 24), (1024, 96, 16),
                                               (32 * 64, 64, 32), (96 * 8, 8, 32)])
def test_ray_blocks_follow_jax(N, width, row_chunk):
    ids = np.arange(N)[None]
    want = JaxStagedMVSNeRF._ray_blocks(type("S", (), {"row_chunk": row_chunk})(), ids, width)
    got = staged.ray_blocks(torch.as_tensor(ids), width, row_chunk)
    assert [b.numpy().tolist() for b in got] == [b.tolist() for b in want]


NETWORKS = {"boost_enerf": "configs/exps/evaluate/enerf_ours/free_eval.yaml",
            "enerf": "configs/exps/evaluate/enerf/free_eval.yaml",
            "enerf_composite": "configs/exps/evaluate/enerf/base_eval.yaml",
            "enerf_human": "configs/exps/evaluate/enerf/free_eval.yaml",
            "boost_mvsnerf": "configs/exps/evaluate/mvsnerf_ours/free_eval.yaml",
            "mvsnerf": "configs/exps/evaluate/mvsnerf/free_eval.yaml"}
EXECUTIONS = {"default": [], "staged": ["execution", "staged"], "jit": ["execution", "jit"]}


def _in_repo(fn, *args):
    old = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


def _kind(fwd, model) -> str:
    """The executor's class, or "model" for the model itself (the port) or
    for a jit of its apply (JAX)."""
    name = type(fwd).__name__
    return name if name.startswith("Staged") else "model"


@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("network", NETWORKS)
def test_make_forward_picks_jaxs_executor(network, execution):
    opts = ["network_module", f"lib.networks.enerf.{network}", *EXECUTIONS[execution]]
    cfg = _in_repo(make_cfg, NETWORKS[network], opts)
    jcfg = _in_repo(jax_make_cfg, NETWORKS[network], opts)
    model, jax_model = runner.make_network(cfg, "cpu"), jrunner.make_network(jcfg)
    got, want = runner.make_forward(cfg, model), jrunner.make_forward(jcfg, jax_model)
    assert _kind(got, model) == _kind(want, jax_model)
    if _kind(got, model) == "model":
        assert got is model
    else:
        assert got.model is model


def test_run_evaluate_goes_through_the_row_blocks(tmp_path, monkeypatch):
    """``run_evaluate`` on a ScanNet scene at 64x64 with 8 samples a ray
    (BoostMVSNeRF, 2 test views): each frame in 2 blocks of 32 rows, and the
    psnr equal to the run with ``execution jit`` (the model whole)."""
    ws = str(tmp_path)
    write_scannet_scene(f"{ws}/scannet_plus", "scene0000_01", n=8, H=H, W=64, rig="varied")
    opts = ["workspace", ws, "scene", "scene0000_01", "test_dataset.input_h_w", f"[{H}, 64]",
            "enerf.cas_config.num_samples", "[8]", "eval_lpips", "false", "save_result", "false"]
    cfg = _in_repo(make_cfg, "configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml", opts)
    sd = random_state_dict(runner.make_network(cfg, "cpu"), 0)
    CheckpointManager(cfg.trained_model_dir).save(
        {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, 0)
    blocks = []
    ray_blocks = staged.ray_blocks

    def counted(*args):
        blocks.append(ray_blocks(*args))
        return blocks[-1]

    monkeypatch.setattr(staged, "ray_blocks", counted)
    got = runner.run_evaluate(cfg, device="cpu")
    assert [len(b) for b in blocks] == [2, 2]
    cfg = _in_repo(make_cfg, "configs/exps/evaluate/mvsnerf_ours/scannet_plus_eval.yaml",
                   opts + ["execution", "jit"])
    want = runner.run_evaluate(cfg, device="cpu")
    assert len(blocks) == 2
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]
