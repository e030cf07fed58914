"""The port's visualizer (``eval/visualizer.py``) against JAX's.

``depth_colormap`` equals JAX's exactly, with OpenCV and without it. The
``Visualizer`` collects the same uint8 frames and writes them with each
writer: imageio where it can write video (a stand-in module here, whose
``mimwrite`` records its frames), OpenCV's ``VideoWriter`` (this
machine's imageio has no video backend), and the PNG frames, decoded equal
to the ones JAX's visualizer writes when its video write fails.
"""

import os
import sys
import types

import numpy as np
import pytest

from boostmvsnerfs_torch.data.formats import read_image_file
from boostmvsnerfs_torch.eval import visualizer as tvis
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_tpu.eval import visualizer as jvis
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig

H, W = 24, 32


def _outputs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    outs = []
    for i in range(n):
        outs.append({"rgb_level1": rng.uniform(-0.1, 1.1, (1, H * W, 3)).astype(np.float32),
                     "depth_level1": rng.uniform(2.0, 6.0, (1, H * W)).astype(np.float32)})
    return outs


def _batch(i):
    return {"meta": [{"scene": "grass", "tar_view": i, "h_1": H, "w_1": W}]}


def _run(vis_mod, cas, result_dir, write_video=True):
    vis = vis_mod.Visualizer(cas, str(result_dir), write_video=write_video, fps=5)
    for i, out in enumerate(_outputs()):
        vis.visualize(out, _batch(i))
    frames = list(vis.color_frames), list(vis.depth_frames)
    return vis, frames


@pytest.mark.parametrize("depth", ["random", "constant", "negative"])
@pytest.mark.parametrize("with_cv2", [True, False])
def test_depth_colormap_equals_jax(depth, with_cv2, monkeypatch):
    rng = np.random.default_rng(1)
    d = {"random": rng.uniform(2.0, 6.0, (H, W)), "constant": np.full((H, W), 3.0),
         "negative": rng.uniform(-5.0, -1.0, (H, W))}[depth].astype(np.float32)
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setattr(jvis, "cv2", None)
    got, want = tvis.depth_colormap(d), jvis.depth_colormap(d)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_collected_frames_equal_jax(tmp_path):
    _, got = _run(tvis, CascadeConfig(), tmp_path / "port")
    _, want = _run(jvis, JaxCascadeConfig(), tmp_path / "jax")
    for a, b in zip(got, want):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_png_frames_equal_jax(tmp_path, monkeypatch):
    """No video writer works: colour frames as ``color_NNNN.png``, decoded
    equal to JAX's (whose imageio has no video backend here either)."""
    jax_vis, _ = _run(jvis, JaxCascadeConfig(), tmp_path / "jax")
    jax_vis.summarize()
    monkeypatch.setitem(sys.modules, "cv2", None)
    vis, _ = _run(tvis, CascadeConfig(), tmp_path / "port")
    monkeypatch.setitem(tvis.VIDEO_WRITERS, "imageio", _failing)
    out = vis.summarize()
    names = [f"color_{i:04d}.png" for i in range(3)]
    assert out == {"writer": "png", "frames": 3,
                   "files": [str(tmp_path / "port" / n) for n in names]}
    assert sorted(os.listdir(tmp_path / "jax")) == names
    for n in names:
        np.testing.assert_array_equal(read_image_file(str(tmp_path / "port" / n)),
                                      read_image_file(str(tmp_path / "jax" / n)))


def _failing(path, frames, fps):
    raise ValueError("no video backend")


def test_video_through_cv2(tmp_path, monkeypatch):
    """imageio cannot write video: OpenCV's writer takes both videos, every
    frame at the output's size."""
    import cv2

    monkeypatch.setitem(tvis.VIDEO_WRITERS, "imageio", _failing)
    vis, _ = _run(tvis, CascadeConfig(), tmp_path)
    out = vis.summarize()
    assert out["writer"] == "cv2" and out["frames"] == 3
    assert out["files"] == [str(tmp_path / "color.mp4"), str(tmp_path / "depth.mp4")]
    for path in out["files"]:
        cap = cv2.VideoCapture(path)
        shapes = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            shapes.append(frame.shape)
        cap.release()
        assert shapes == [(H, W, 3)] * 3, path


def test_video_through_imageio(tmp_path, monkeypatch):
    """Where imageio writes video it goes first: both videos, the collected
    frames at the configured rate."""
    written = {}
    v2 = types.SimpleNamespace(
        mimwrite=lambda path, frames, fps: written.update({path: (list(frames), fps)}))
    monkeypatch.setitem(sys.modules, "imageio", types.SimpleNamespace(v2=v2))
    monkeypatch.setitem(sys.modules, "imageio.v2", v2)
    vis, (color, depth) = _run(tvis, CascadeConfig(), tmp_path)
    out = vis.summarize()
    assert out["writer"] == "imageio"
    assert written.keys() == set(out["files"]) == {str(tmp_path / "color.mp4"),
                                                    str(tmp_path / "depth.mp4")}
    for (frames, fps), want in zip((written[p] for p in out["files"]), (color, depth)):
        assert fps == 5 and all(np.array_equal(a, b) for a, b in zip(frames, want))


def test_no_video_asked_writes_png_frames(tmp_path):
    vis, _ = _run(tvis, CascadeConfig(), tmp_path, write_video=False)
    out = vis.summarize()
    assert out["writer"] == "png" and len(out["files"]) == 3
    assert vis.summarize() == {"writer": None, "files": [], "frames": 0}
