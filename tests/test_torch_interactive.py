"""The port's browser viewer (``interactive/``, ``python -m
boostmvsnerfs_torch.run --type gui``) against JAX's, on the CPU.

The camera against JAX's ``InteractiveCamera`` under one event sequence
(equal poses to 1e-12), the depth colormap bit for bit, the HTTP server
with a stub render function (as tests/test_interactive.py drives JAX's),
and the real render function: BoostENeRF from
configs/exps/evaluate/enerf_ours/free_eval.yaml on the Free fixture at
64x96 (6 source views, K=4 of 20), seeded weights as the port's
``latest.pt`` and as JAX's variables. Against JAX (its exact path: gather
warp and sampling, XLA head, float32 warp) at the middle pose of a 3-frame
interpolated path through the test views: the same greedy picks, rgb over
45 dB, depth within 1e-3 of its range. Not at the first pose: it is a test
view's camera, which is also one of its nearest source views, so the rays
along the frame's border project onto that view's border, where the
coverage masks step (ROADMAP fault 4) and flip between two builds by
rounding; there the depth of ~140 border pixels reads up to 2.7% of its
range apart, the rgb 55.7 dB. Against the port's own ``render_novel_path``
(the same build) at the path's first pose: within 1 uint8 level.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import runner
from boostmvsnerfs_torch.interactive import camera as tcamera
from boostmvsnerfs_torch.interactive import server
from boostmvsnerfs_torch.interactive.camera import InteractiveCamera, RenderOptions
from boostmvsnerfs_torch.utils.camera_paths import interpolate_path
from boostmvsnerfs_torch.utils.synthetic import write_free_scene
from boostmvsnerfs_tpu import runner as jrunner
from boostmvsnerfs_tpu.interactive import camera as jcamera
from boostmvsnerfs_tpu.interactive import server as jserver
from boostmvsnerfs_tpu.utils.port_weights import port_enerf
from tests.test_torch_runner import FREE_EVAL, _cfgs, _save_weights

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(angle=0.3, center=(1.0, 2.0, 3.0)):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m[:3, 3] = center
    return m


EVENTS = [
    ("rotate", (37.0, -12.0), {}),
    ("rotate", (80.0, 25.0), {"about_origin": True}),
    ("pan", (10.0, -4.0), {}),
    ("zoom", (2.0,), {}),
    ("move", (0.3, -0.2, 0.1), {}),
    ("rotate", (-5.0, 40.0), {"about_origin": True}),
]


def test_camera_matches_jax_under_one_event_sequence():
    anchors = np.stack([_pose(a, (a, 0.2 * a, 1.0)) for a in (0.0, 0.3, 0.6)])
    cams = [mod.InteractiveCamera.from_pose(_pose(), move_speed=0.7, rotate_speed=0.004)
            for mod in (tcamera, jcamera)]
    for cam in cams:
        cam.origin = np.array([0.5, 0.5, 0.5])
    for name, args, kw in EVENTS:
        for cam in cams:
            getattr(cam, name)(*args, **kw)
        np.testing.assert_allclose(cams[0].c2w(), cams[1].c2w(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(cams[0].w2c(), cams[1].w2c(), rtol=0, atol=1e-12)
    for cam in cams:
        cam.set_path(anchors, n=50)
    for speed in (0.0, 0.25, 0.5, 0.4):
        for cam in cams:
            cam.play(speed)
        assert cams[0].path_u == cams[1].path_u
        np.testing.assert_allclose(cams[0].c2w(), cams[1].c2w(), rtol=0, atol=1e-12)
    cams[0].goto_path(0.0)
    np.testing.assert_allclose(cams[0].c2w(), anchors[0], atol=1e-6)
    with pytest.raises(ValueError, match="no camera path"):
        InteractiveCamera().goto_path(0.5)
    assert RenderOptions() == RenderOptions(**vars(jcamera.RenderOptions()))


def test_depth_colormap_matches_jax(rng):
    for depth in (rng.uniform(2, 6, (24, 32)), np.full((8, 8), 3.0),
                  np.linspace(0, 1, 24 * 32).reshape(24, 32)):
        got, want = server._depth_colormap(depth), jserver._depth_colormap(depth)
        assert got.dtype == np.uint8 and got.shape == (*depth.shape, 3)
        np.testing.assert_array_equal(got, want)


def _serve(state):
    srv = server.make_server(state, port=0)  # an ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, ev):
    """(status, body, content type) of one event."""
    req = urllib.request.Request(url + "/event", data=json.dumps(ev).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _stub_render(calls):
    def render(c2w, opt):
        calls.append((np.asarray(c2w).copy(), opt.out_type, opt.level))
        if opt.out_type == "depth":
            return np.linspace(0, 1, 24 * 32).reshape(24, 32)
        return np.full((24, 32, 3), 128, np.uint8)

    render.stats = {"select_ms": 1.0}
    return render


@pytest.fixture()
def stub_viewer():
    calls = []
    cam = InteractiveCamera.from_pose(_pose())
    cam.set_path(np.stack([_pose(a) for a in (0.0, 0.4)]), n=16)
    state = server.ViewerState(_stub_render(calls), cam, RenderOptions())
    srv, url = _serve(state)
    yield url, state, calls
    srv.shutdown()
    srv.server_close()


def test_stub_server_serves_the_page_meta_events_options_and_play(stub_viewer):
    url, state, calls = stub_viewer
    with urllib.request.urlopen(url + "/", timeout=10) as r:
        page = r.read().decode()
    assert "canvas" in page and "/event" in page
    with urllib.request.urlopen(url + "/meta", timeout=10) as r:
        meta = json.loads(r.read())
    assert meta == {"window_hw": [512, 512], "has_path": True,
                    "center": list(map(float, state.camera.center))}
    with pytest.raises(urllib.error.HTTPError, match="404"):
        urllib.request.urlopen(url + "/nothing", timeout=10)

    c0 = state.camera.center.copy()
    status, body, ctype = _post(url, {"kind": "none"})
    assert (status, ctype) == (200, "image/jpeg") and body[:2] == b"\xff\xd8"  # JPEG SOI
    _post(url, {"kind": "rotate", "dx": 30, "dy": 0, "orbit": False})
    _post(url, {"kind": "zoom", "amount": 1.0})
    assert np.linalg.norm(state.camera.center - c0) > 0
    _post(url, {"kind": "options", "out_type": "depth", "level": 0})
    assert (state.options.out_type, state.options.level) == ("depth", 0)
    assert calls[-1][1:] == ("depth", 0)
    u0 = state.camera.path_u
    status, _, ctype = _post(url, {"kind": "play"})  # depth, colormapped then encoded
    assert (status, ctype) == (200, "image/jpeg") and state.camera.path_u > u0
    assert len(calls) == len(state.frame_times) == 5
    assert all(t["render_ms"] >= 0 and t["encode_ms"] > 0 and t["select_ms"] == 1.0
               for t in state.frame_times)


# ------------------------------------------------ the real render function


@pytest.fixture(scope="module")
def free(tmp_path_factory):
    """The Free fixture with seeded weights as ``latest.pt``; the port's
    config and JAX's, and JAX's variables."""
    ws = str(tmp_path_factory.mktemp("ws"))
    write_free_scene(f"{ws}/Free", "grass")
    cfg, jcfg = _cfgs(FREE_EVAL, ["workspace", ws, "scene", "grass",
                                  "test_dataset.input_h_w", "[64, 96]"])
    return cfg, jcfg, _save_weights(cfg, port_enerf)


@pytest.fixture(scope="module")
def viewer(free):
    """The port's render function, camera and options on the CPU; the
    model's outputs of each call kept."""
    render_fn, camera, options = server.build_render_fn(free[0], "cpu")
    outs = []
    render_fn.model.register_forward_hook(lambda m, inp, out: outs.append(out))
    return render_fn, camera, options, outs


def _middle_pose(cfg):
    anchors = runner.path_anchors(runner.make_dataset(cfg, "test"))[1]
    return interpolate_path(anchors, 3)[1]


@pytest.fixture(scope="module")
def jax_frame(free):
    """JAX's ``build_render_fn`` at ``_middle_pose``, the same weights given
    in place of its ``_init_or_load`` (whose ``model.init`` alone takes
    ~80 s here): the pose, its frame, picks and model outputs."""
    jcfg, variables = free[1:]
    c2w = _middle_pose(free[0])
    picks, outs = [], []
    select, sync = jrunner.greedy_select, jrunner.host_sync
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jrunner, "_init_or_load", lambda *args: variables)
        mp.setattr(jrunner, "greedy_select", lambda *a: picks.append(select(*a)) or picks[-1])
        mp.setattr(jrunner, "host_sync", lambda tree: outs.append(sync(tree)) or outs[-1])
        render_fn, camera, options = jserver.build_render_fn(jcfg)
        frame = render_fn(c2w, options)
    finally:
        mp.undo()
    out = outs[-1]  # the frame's (the selection syncs its masks through host_sync too)
    return c2w, frame, picks[0][0].tolist(), {k: np.asarray(v) for k, v in out.items()}


def test_render_fn_matches_jax(viewer, jax_frame):
    render_fn, camera, options, outs = viewer
    c2w, jframe, jpicks, jout = jax_frame
    frame = render_fn(c2w, options)
    assert frame.shape == jframe.shape == (64, 96, 3) and frame.dtype == np.uint8
    assert render_fn.stats["k_best"] == jpicks
    assert all(render_fn.stats[k] > 0 for k in ("batch_ms", "select_ms", "forward_ms"))
    out = {k: v.numpy() for k, v in outs[-1].items()}
    rgb, jrgb = out["rgb_level1"], jout["rgb_level1"]
    assert -10 * np.log10(np.mean((rgb - jrgb) ** 2)) > 45.0
    depth = render_fn(c2w, RenderOptions(out_type="depth", window_hw=options.window_hw))
    jdepth = jout["depth_level1"][0].reshape(64, 96)
    assert depth.shape == (64, 96) and depth.dtype == np.float32
    assert np.abs(depth - jdepth).max() <= 1e-3 * (jdepth.max() - jdepth.min())
    assert np.abs(frame.astype(int) - jframe).max() <= 1


def test_render_fn_matches_render_novel_path(free, viewer, monkeypatch):
    """The frame at the first pose of ``interpolate_path`` through the test
    views against ``render_novel_path``'s frame 0, the same weights."""
    from boostmvsnerfs_torch.eval.visualizer import Visualizer

    cfg = free[0]
    render_fn, camera, options, _ = viewer
    frames = []
    original = Visualizer.visualize

    def visualize(self, output, batch):
        original(self, output, batch)
        frames.append(self.color_frames[-1])

    monkeypatch.setattr(Visualizer, "visualize", visualize)
    path = runner.render_novel_path(cfg, n_frames=2, device="cpu")
    anchors = runner.path_anchors(runner.make_dataset(cfg, "test"))[1]
    frame = render_fn(interpolate_path(anchors, 2)[0], options)
    assert render_fn.stats["k_best"] == path["per_frame"][0]["k_best"]
    assert frames[0].shape == frame.shape and np.abs(frames[0].astype(int) - frame).max() <= 1


def test_level_0_of_a_level_1_config_answers_500(viewer):
    """``render_if (False, True)`` renders level 1 only: asking for level 0
    fails, as in JAX, and the server answers 500 with the reason."""
    render_fn, camera, options, _ = viewer
    state = server.ViewerState(render_fn, camera, RenderOptions(window_hw=options.window_hw))
    srv, url = _serve(state)
    try:
        status, body, _ = _post(url, {"kind": "options", "level": 0})
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 500 and b"rgb_level0" in body and state.frame_times == []


def test_build_render_fn_raises_without_cuda_unless_cpu_asked(free, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.build_render_fn(free[0])
