"""The novel-view entries (``runner.render_novel_path``, ``python -m
boostmvsnerfs_torch.run --type visualize | path``) against JAX's, on the
CPU.

BoostENeRF from configs/exps/evaluate/enerf_ours/free_eval.yaml on the
Free fixture at 64x96 (6 source views, K=4 of 20), seeded weights as the
port's ``latest.pt`` and as JAX's variables. JAX runs its exact
``render_novel_path`` (gather warp and sampling, XLA head, float32 warp,
one jit per combination and frame). Bars: per frame the same greedy picks
and rgb over 45 dB.
"""

import os

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import run as trun
from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.synthetic import write_free_scene
from boostmvsnerfs_tpu import runner as jrunner
from boostmvsnerfs_tpu.utils.port_weights import port_enerf
from tests.test_torch_runner import FREE_EVAL, REPO, _cfgs, _save_weights

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


@pytest.fixture(scope="module")
def free(tmp_path_factory):
    """The Free fixture with the seeded weights saved as ``latest.pt``; the
    port's and JAX's configs."""
    ws = str(tmp_path_factory.mktemp("ws"))
    write_free_scene(f"{ws}/Free", "grass")
    cfg, jcfg = _cfgs(FREE_EVAL, ["workspace", ws, "scene", "grass",
                                  "test_dataset.input_h_w", "[64, 96]"])
    _save_weights(cfg, port_enerf)
    return cfg, jcfg


def _recording(monkeypatch, cls, seen):
    """``cls.visualize`` also keeps each frame's rgb and ``k_best``."""
    original = cls.visualize

    def visualize(self, output, batch):
        rgb = output["rgb_level1"]
        seen.append((np.asarray(rgb.numpy() if torch.is_tensor(rgb) else rgb),
                     np.asarray(batch["k_best"]).tolist()))
        return original(self, output, batch)

    monkeypatch.setattr(cls, "visualize", visualize)


@pytest.fixture(scope="module")
def paths(free):
    """``render_novel_path`` of both packages over the Free fixture, 3
    interpolated frames, the same weights: the port's from its
    ``latest.pt``, JAX's given to its run in place of its ``_init_or_load``
    (whose ``model.init`` alone, op by op on the CPU, takes ~80 s here)."""
    from boostmvsnerfs_torch.eval.visualizer import Visualizer
    from boostmvsnerfs_tpu.eval.visualizer import Visualizer as JaxVisualizer

    cfg, jcfg = free[:2]
    variables = port_enerf(random_state_dict(runner.make_network(cfg, "cpu"), 0))
    got, want = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jrunner, "_init_or_load", lambda *args: variables)
        _recording(mp, Visualizer, got)
        _recording(mp, JaxVisualizer, want)
        summary = runner.render_novel_path(cfg, n_frames=3, device="cpu")
        jrunner.render_novel_path(jcfg, n_frames=3)
    finally:
        mp.undo()
    return summary, got, want


def test_render_novel_path_matches_jax(paths):
    """Per frame the same greedy picks as JAX's and rgb over 45 dB."""
    summary, got, want = paths
    assert len(got) == len(want) == 3
    for (rgb, k_best), (jrgb, jk_best) in zip(got, want):
        assert k_best == jk_best
        assert -10 * np.log10(np.mean((rgb - jrgb) ** 2)) > 45.0
    assert [f["k_best"] for f in summary["per_frame"]] == [k[0] for _, k in got]


def test_render_novel_path_writes_the_videos(paths):
    """The recipe's ``write_video``: both videos through the first writer
    that works here (imageio has no video backend on this machine, OpenCV
    has), 3 frames, and each frame's times."""
    summary = paths[0]
    assert summary["writer"] in ("imageio", "cv2") and summary["frames"] == 3
    assert [os.path.basename(f) for f in summary["files"]] == ["color.mp4", "depth.mp4"]
    assert all(os.path.getsize(f) > 0 for f in summary["files"])
    assert all(f["select_ms"] > 0 and f["frame_ms"] > 0 for f in summary["per_frame"])


@pytest.mark.parametrize("kind", ["visualize", "path"])
def test_cli_visualize_and_path_on_the_cpu(free, kind, tmp_path):
    """``python -m boostmvsnerfs_torch.run --type visualize | path --device
    cpu``: PNG frames without video (``write_video false``), one per test
    view or per ``render_num`` frame of a spiral."""
    cfg = free[0]
    old = os.getcwd()
    os.chdir(REPO)
    try:
        out = trun.main(["--type", kind, "--device", "cpu", "--cfg_file", FREE_EVAL,
                         "workspace", cfg.workspace, "scene", "grass",
                         "test_dataset.input_h_w", "[64, 96]", "write_video", "false",
                         "render_num", "2", "path_type", "spiral", "save_tag", f"cli_{kind}"])
    finally:
        os.chdir(old)
    assert out["writer"] == "png" and out["frames"] == 2
    assert all(os.path.exists(f) for f in out["files"])
    if kind == "path":
        assert out["path_type"] == "spiral" and len(out["per_frame"]) == 2


def test_cli_gui_serves_the_viewer_on_the_cpu(free, monkeypatch):
    """``--type gui --device cpu`` builds the viewer and serves it on
    ``gui_host``:``gui_port``: a patched ``serve_forever`` serves it in a
    thread, fetches ``/meta`` and one frame, and stops it."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    cfg = free[0]
    serve_forever = ThreadingHTTPServer.serve_forever
    seen = {}

    def serve_briefly(server, *args, **kw):
        th = threading.Thread(target=serve_forever, args=(server,), daemon=True)
        th.start()
        host, port = server.server_address[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/meta", timeout=60) as r:
            seen["meta"] = json.loads(r.read())
        req = urllib.request.Request(f"http://{host}:{port}/event", method="POST",
                                     data=json.dumps({"kind": "none"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            seen["frame"] = (r.status, r.headers.get("Content-Type"), r.read()[:2])
        server.shutdown()
        th.join(timeout=10)

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", serve_briefly)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        trun.main(["--type", "gui", "--device", "cpu", "--cfg_file", FREE_EVAL,
                   "workspace", cfg.workspace, "scene", "grass",
                   "test_dataset.input_h_w", "[64, 96]", "gui_port", "0"])
    finally:
        os.chdir(old)
    assert seen["meta"]["window_hw"] == [64, 96] and seen["meta"]["has_path"] is True
    assert seen["frame"] == (200, "image/jpeg", b"\xff\xd8")
    assert sorted(trun.RUNS) == sorted(["dataset", "network", "preprocess", "evaluate",
                                        "visualize", "path", "gui"])


def test_new_entries_raise_without_cuda_unless_cpu_asked(free, monkeypatch):
    cfg = free[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: runner.render_novel_path(cfg, n_frames=1),
                 lambda: trun.run_visualize(cfg, None),
                 lambda: trun.run_gui(cfg, None),
                 lambda: trun.main(["--type", "path", "--cfg_file", FREE_EVAL,
                                    "workspace", cfg.workspace, "scene", "grass"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
