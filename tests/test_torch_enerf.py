"""The port's plain ENeRF forward, both cascade levels rendered, against JAX.

32x64, 3 source views, volume planes (8, 8), ``render_if`` (True, True):
level 0 renders 8 samples per ray through the 35-channel head and plain
``composite``, which the boost slice test (level 1 only, blended) does not
reach. Weights as in tests/test_torch_boost_enerf.py; the JAX model takes
its exact path (gather warp and sampling, XLA head, float32). Bars: rgb
PSNR > 45 dB per level (the model bar of tests/test_reference_parity.py);
regressed depth and std at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.models.enerf import ENeRF, CascadeConfig
from boostmvsnerfs_torch.utils.port_weights import enerf_state_dict_from_jax, random_state_dict
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.models.enerf import ENeRF as JaxENeRF
from boostmvsnerfs_tpu.utils.port_weights import port_enerf

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CAS = dict(volume_planes=(8, 8), render_if=(True, True))


@pytest.fixture(scope="module")
def renders():
    batch = make_scene_batch(B=1, n_views=3, H=32, W=64, seed=1, rig="forward")
    model = ENeRF(CascadeConfig(**CAS), device="cpu")
    variables = port_enerf(random_state_dict(model, 1))
    model.load_state_dict(enerf_state_dict_from_jax(variables), strict=True)
    got = {k: v.numpy() for k, v in model(batch).items()}
    jax_model = JaxENeRF(cas=JaxCascadeConfig(
        warp_mode="gather", eval_sampling="gather", eval_head="xla", warp_dtype="float32", **CAS))
    want = jax_model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    return got, {k: np.asarray(v) for k, v in want.items()}


def test_outputs_match_jax_keys_and_shapes(renders):
    got, want = renders
    assert got.keys() == want.keys()
    assert {"rgb_level0", "rgb_level1"} <= got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k


@pytest.mark.parametrize("level", [0, 1])
def test_rgb_psnr_above_45db(renders, level, record_property):
    got, want = renders
    key = f"rgb_level{level}"
    psnr = -10 * np.log10(np.mean((got[key] - want[key]) ** 2))
    record_property("rgb_psnr_db", float(psnr))
    assert psnr > 45.0


@pytest.mark.parametrize("key", ["depth_mvs_level0", "std_level0", "depth_mvs_level1",
                                 "std_level1"])
def test_regressed_depth_matches(renders, key):
    got, want = renders
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)
