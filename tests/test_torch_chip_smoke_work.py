"""chip_smoke.py's work counts and bounds on toy inputs (CPU).

The sampler's bound charges the map bytes that the four bilinear taps can
touch, not the whole map: a ray block of the fine-tuning step samples a band
of each map, and a bound that charged the whole map would be slower than
F.grid_sample's measured time on the same inputs. The renderer MLP's bound
charges its dense layers to the tensor cores at bf16 (989 TFLOP/s) and to
the f32 units at f32 (67 TFLOP/s).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(x, y, V=2, H=9, W=13, C=5):
    imgs = torch.zeros(V, H, W, C)
    t = lambda a: torch.tensor(np.broadcast_to(np.asarray(a, np.float32), (V, len(a))).copy())  # noqa: E731
    return imgs, t(x), t(y)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_samples_inside_one_pixel_touch_its_four_taps(smoke, padding_mode):
    rng = np.random.default_rng(0)
    imgs, x, y = _case(rng.uniform(4.05, 4.95, 50), rng.uniform(2.05, 2.95, 50))
    V, _, _, C = imgs.shape
    assert smoke.touched_pixels(imgs, x, y, padding_mode) == 4 * V
    n = x.numel()
    nbytes, _ = smoke.sample_work(imgs, x, y, padding_mode)
    assert nbytes == 4 * (4 * V * C + 2 * n + n * C)
    nbytes, _ = smoke.sample_bwd_work(imgs, x, y, torch.zeros(V, x.shape[1], C), padding_mode)
    assert nbytes == 4 * (4 * V * C + imgs.numel() + 4 * n + n * C)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_samples_covering_the_map_touch_all_of_it(smoke, padding_mode):
    V, H, W, C = 2, 9, 13, 5
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    # every pixel centre, plus samples far outside (behind the camera, and
    # past the zeros padding's clamp), which add no pixel
    x = np.concatenate([xx.ravel(), [1e10, -1e10, W + 5.0]])
    y = np.concatenate([yy.ravel(), [-1e10, 1e10, H + 5.0]])
    imgs, x, y = _case(x, y, V, H, W, C)
    assert smoke.touched_pixels(imgs, x, y, padding_mode) == V * H * W
    n = x.numel()
    assert smoke.sample_work(imgs, x, y, padding_mode)[0] == 4 * (imgs.numel() + 2 * n + n * C)


@pytest.mark.parametrize("compute_dtype,want_ms", [(torch.bfloat16, 2.565), (torch.float32, 37.87)])
def test_mlp_bound_at_the_main_paths_sample_count(smoke, compute_dtype, want_ms):
    """The MVSNeRF main path's MLP work (4 x 78,848 rays x 32 samples, F =
    20, the encoded instance): the published-width MLP's weights on toy
    (meta) input tensors of the path's sample count."""
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig, RendererMLP

    params = RendererMLP(MVSNeRFConfig(), 20).mlp_params()
    n = 224 * 352 * 32
    pts, feat, dirs = (torch.empty(4, n, w, device="meta") for w in (63, 20, 3))
    ms, by = smoke.bound(*smoke.mlp_work(params, pts, feat, dirs, 0, compute_dtype))
    assert by == "operations"
    assert round(ms, 3 if compute_dtype == torch.bfloat16 else 2) == want_ms
