"""The port's geometry debug tooling (``utils/debug_viz.py``) against JAX's,
on the same seeded inputs: epipolar segments and corner points equal, and
the figures written as PNGs."""

import os

import numpy as np
import pytest

from boostmvsnerfs_torch.utils import debug_viz
from boostmvsnerfs_tpu.utils import debug_viz as jdebug_viz
from tests.helpers import make_batch


def _segments_args(b, s, near, far):
    pts = np.array([[20.0, 12.0], [40.0, 30.0], [10.0, 40.0], [63.0, 0.0]], np.float32)
    return (pts, b["tar_ixt"][0], b["tar_ext"][0], b["src_ixts"][0, s], b["src_exts"][0, s],
            near, far)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_epipolar_segments_match_jax(rng, s):
    b = make_batch(rng, B=1, S=3, H=48, W=64)
    near, far = b["near_far"][0]
    for depths in ((near, far), (0.5 * (near + far),) * 2):
        got = debug_viz.epipolar_segments(*_segments_args(b, s, *depths))
        want = jdebug_viz.epipolar_segments(*_segments_args(b, s, *depths))
        assert got.shape == (4, 2, 2) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,n", [("texture", 8), ("texture", 30), ("gray", 5), ("flat", 4),
                                    ("stripes", 6)])
def test_corner_points_match_jax(rng, kind, n):
    img = {"texture": rng.uniform(0, 1, (40, 56, 3)).astype(np.float32),
           "gray": rng.uniform(0, 1, (33, 47)).astype(np.float32),
           "flat": np.zeros((40, 56), np.float32),
           "stripes": np.tile((np.arange(56) % 7 < 3).astype(np.float32), (40, 1))}[kind]
    got, want = debug_viz.corner_points(img, n), jdebug_viz.corner_points(img, n)
    # a flat score map falls back to a grid of at most n points
    assert got.shape == (n, 2) if kind in ("texture", "gray") else len(got) <= n
    np.testing.assert_array_equal(got, want)


def test_epipolar_check_figure_writes_png_and_matches_jax(rng, tmp_path):
    b = make_batch(rng, B=1, S=3, H=48, W=64)
    b["tar_img"] = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    out = str(tmp_path / "epipolar.png")
    segs = debug_viz.epipolar_check_figure(b, out, num_points=6)
    assert os.path.getsize(out) > 0 and segs.shape == (3, 6, 2, 2)
    np.testing.assert_array_equal(
        segs, jdebug_viz.epipolar_check_figure(b, str(tmp_path / "jax.png"), num_points=6))


def test_depth_prob_figure_writes_png_and_matches_jax(rng, tmp_path):
    H, W, D = 24, 32, 16
    dv = np.linspace(2.0, 6.0, D)
    logits = rng.normal(0, 1, (D, H, W))
    prob = np.exp(logits) / np.exp(logits).sum(0)
    depth = (prob * dv[:, None, None]).sum(0)
    std = np.sqrt((prob * (dv[:, None, None] - depth) ** 2).sum(0))
    dv3 = np.broadcast_to(dv[:, None, None], (D, H, W))
    for values in (dv, dv3):
        out = str(tmp_path / "prob.png")
        got = debug_viz.depth_prob_figure(depth, std, prob, values, (10, 12), out)
        want = jdebug_viz.depth_prob_figure(depth, std, prob, values, (10, 12),
                                            str(tmp_path / "jax.png"))
        assert os.path.getsize(out) > 0
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["prob"], prob[:, 10, 12])
