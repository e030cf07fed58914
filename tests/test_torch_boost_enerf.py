"""The whole slice: the port's BoostENeRF fused eval render against JAX.

32x64, 4 source views, K=2 of C(4,3), volume planes (8, 8), only level 1
rendered, forward rig: the smallest geometry at which both U-Nets' strides
divide evenly. The same seeded reference-named weights go to JAX through
``port_enerf`` and come back to the port through
``enerf_state_dict_from_jax``. The JAX model takes its exact path (gather
warp and sampling, XLA head, float32). Bars: rgb PSNR > 45 dB (the model
bar of tests/test_reference_parity.py); the regressed depth and std at
rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.utils.port_weights import enerf_state_dict_from_jax, random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch
from boostmvsnerfs_tpu.models.boost_enerf import BoostENeRF as JaxBoostENeRF
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.utils.port_weights import port_enerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SLICE = dict(k_best=2, volume_planes=(8, 8), render_if=(False, True))


@pytest.fixture(scope="module")
def renders():
    batch = make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, k_best=2, seed=0,
                             rig="forward")
    model = BoostENeRF(CascadeConfig(**SLICE), device="cpu")
    variables = port_enerf(random_state_dict(model, 0))
    model.load_state_dict(enerf_state_dict_from_jax(variables), strict=True)
    got = {k: v.numpy() for k, v in model(batch).items()}
    jax_model = JaxBoostENeRF(cas=JaxCascadeConfig(
        warp_mode="gather", eval_sampling="gather", eval_head="xla", warp_dtype="float32",
        **SLICE))
    want = jax_model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    return got, {k: np.asarray(v) for k, v in want.items()}


def test_outputs_match_jax_keys_and_shapes(renders):
    got, want = renders
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k


def test_rgb_psnr_above_45db(renders, record_property):
    got, want = renders
    err = np.abs(got["rgb_level1"] - want["rgb_level1"])
    psnr = -10 * np.log10(np.mean(err**2))
    record_property("rgb_psnr_db", float(psnr))
    record_property("rgb_max_abs_err", float(err.max()))
    record_property("rays_off_by_1e-4", int((err.max(-1) > 1e-4).sum()))
    assert psnr > 45.0
    assert 0.0 <= got["rgb_level1"].min() and got["rgb_level1"].max() <= 1.0


@pytest.mark.parametrize("key", ["depth_mvs_level1", "std_level1"])
def test_regressed_depth_matches(renders, key):
    got, want = renders
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)


def test_entry_point_raises_without_cuda_unless_cpu_asked(monkeypatch):
    """The default device is CUDA; with none present the model raises
    instead of moving to the CPU, and device='cpu' is the explicit way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BoostENeRF(CascadeConfig(**SLICE))
    model = BoostENeRF(CascadeConfig(**SLICE), device="cpu")
    assert model.device.type == "cpu"
