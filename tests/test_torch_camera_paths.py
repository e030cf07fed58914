"""The port's camera paths (``utils/camera_paths.py``) against JAX's.

Host numpy on both sides, the same formulas: every pose equal to JAX's to
1e-12. Anchors are a Free fixture's test-view poses and a seeded set of
turned cameras; the interpolated path starts and ends on the first and last
anchors (to 1e-12: the quaternion round trip), and every pose is rigid (to
1e-12 on the interpolated path, 1e-9 on the spiral, whose ``look_at``
normalises by the norm plus 1e-10).
"""

import numpy as np
import pytest

from boostmvsnerfs_torch.utils import camera_paths as tcp
from boostmvsnerfs_tpu.utils import camera_paths as jcp
from boostmvsnerfs_tpu.utils import colmap as jcolmap


def _anchors(kind: str) -> np.ndarray:
    """Rigid c2w poses on the Free fixture's circle (test views 0 and 8 of
    ``utils/synthetic.write_free_scene``, looking along +z), or four
    cameras there each turned by a seeded unit quaternion."""
    rng = np.random.default_rng(3)
    n = 4 if kind == "turned" else 2
    out = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, 3] = [3 * np.sin(0.2 * 8 * i), 0.1, 3 * np.cos(0.2 * 8 * i)]
        if kind == "turned":
            q = np.array([1.0, *rng.uniform(-0.3, 0.3, 3)])
            c2w[:3, :3] = jcolmap.qvec2rotmat(q / np.linalg.norm(q))
        out.append(c2w)
    return np.stack(out)


def _rigid(c2w: np.ndarray, atol: float = 1e-12) -> bool:
    R = c2w[:3, :3]
    return (np.allclose(R @ R.T, np.eye(3), rtol=0, atol=atol)
            and abs(np.linalg.det(R) - 1) < atol and np.array_equal(c2w[3], [0, 0, 0, 1]))


@pytest.mark.parametrize("kind", ["free", "turned"])
@pytest.mark.parametrize("n_frames", [2, 7, 30])
def test_interpolate_path_equals_jax(kind, n_frames):
    anchors = _anchors(kind)
    got, want = tcp.interpolate_path(anchors, n_frames), jcp.interpolate_path(anchors, n_frames)
    assert got.shape == (n_frames, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0], anchors[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[-1], anchors[-1], rtol=0, atol=1e-12)
    assert all(_rigid(c) for c in got)


@pytest.mark.parametrize("kind", ["free", "turned"])
@pytest.mark.parametrize("kw", [{}, {"n_rots": 1, "zrate": 0.25, "rads_scale": 0.5},
                                {"focus_depth": 3.0}])
def test_spiral_path_equals_jax(kind, kw):
    anchors = _anchors(kind)
    got, want = tcp.spiral_path(anchors, 12, **kw), jcp.spiral_path(anchors, 12, **kw)
    assert got.shape == (12, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # look_at divides by |v| + 1e-10, so its axes are unit to ~1e-10
    assert all(_rigid(c, atol=1e-9) for c in got)


def test_pose_helpers_equal_jax():
    anchors = _anchors("turned")
    np.testing.assert_allclose(tcp.average_pose(anchors), jcp.average_pose(anchors),
                               rtol=0, atol=1e-12)
    eye, target = np.array([0.3, -0.2, 1.0]), np.array([1.0, 0.5, 6.0])
    np.testing.assert_allclose(tcp.look_at(eye, target), jcp.look_at(eye, target),
                               rtol=0, atol=1e-12)
    for c in anchors:
        q = tcp.rotmat2qvec(c[:3, :3])
        np.testing.assert_allclose(q, jcolmap.rotmat2qvec(c[:3, :3]), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tcp.qvec2rotmat(q), jcolmap.qvec2rotmat(q), rtol=0, atol=1e-12)
    q0, q1 = tcp.rotmat2qvec(anchors[0][:3, :3]), tcp.rotmat2qvec(anchors[1][:3, :3])
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(tcp._slerp(q0, q1, t), jcp._slerp(q0, q1, t), rtol=0,
                                   atol=1e-12)
