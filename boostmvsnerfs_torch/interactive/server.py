"""Browser-served interactive viewer (counterpart of
``boostmvsnerfs_tpu/interactive/server.py``, event for event).

Equivalent of the reference OpenGL viewer
(``lib/visualizers/enerf_interactive.py`` + ``lib/interactive/``): a
stdlib HTTP server renders frames on the card and streams JPEGs to a canvas
page; mouse and keyboard events post back and drive the camera interactions
the reference implements with GLFW callbacks (drag rotate / orbit, pan,
scroll dolly, WASD, camera-path autoplay) and the render options (level,
pred/depth).

Start with ``python -m boostmvsnerfs_torch.run --type gui --cfg_file
configs/...`` (on the card; ``--device cpu`` for the plain versions) and
open ``http://127.0.0.1:8008/`` (``gui_port`` / ``gui_host``), or
programmatically::

    render_fn, camera, options = build_render_fn(cfg)
    server = make_server(ViewerState(render_fn, camera, options), port=8008)
    server.serve_forever()

``render_fn(c2w, options) -> (H, W, 3) uint8`` (or an (H, W) depth map) is
the only coupling to the model: ``build_render_fn`` wires the real
pipeline; tests inject a stub. A render function may carry ``stats``, a dict
of its last frame's numbers, which ``ViewerState`` adds to that frame's
entry of ``frame_times``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from boostmvsnerfs_torch.interactive.camera import (
    InteractiveCamera,
    RenderOptions,
)
from boostmvsnerfs_torch.utils.profiling import collect, span

_PAGE = """<!DOCTYPE html>
<html><head><title>boostmvsnerfs viewer</title><style>
 body { margin: 0; background: #111; color: #ddd;
        font: 13px system-ui, sans-serif; }
 #bar { padding: 6px 10px; display: flex; gap: 14px; align-items: center; }
 canvas { display: block; margin: 0 auto; cursor: grab; }
 select, button { background: #222; color: #ddd; border: 1px solid #555; }
</style></head><body>
<div id="bar">
  <b>boostmvsnerfs</b>
  <label>type <select id="type">
    <option value="pred">pred</option><option value="depth">depth</option>
  </select></label>
  <label>level <select id="level">
    <option value="1">1</option><option value="0">0</option>
  </select></label>
  <button id="play">play path</button>
  <span id="fps"></span>
  <span>drag: rotate &middot; shift-drag: pan &middot; wheel: dolly &middot;
        WASD/QE: move &middot; O: orbit origin</span>
</div>
<canvas id="view"></canvas>
<script>
const canvas = document.getElementById('view');
const ctx2d = canvas.getContext('2d');
let busy = false, pending = null, playing = false, frames = 0, t0 = Date.now();
async function post(ev) {
  if (busy) { pending = ev; return; }
  busy = true;
  const r = await fetch('/event', {method: 'POST', body: JSON.stringify(ev)});
  const blob = await r.blob();
  const img = await createImageBitmap(blob);
  canvas.width = img.width; canvas.height = img.height;
  ctx2d.drawImage(img, 0, 0);
  frames++;
  if (Date.now() - t0 > 1000) {
    document.getElementById('fps').textContent = frames + ' fps';
    frames = 0; t0 = Date.now();
  }
  busy = false;
  if (pending) { const p = pending; pending = null; post(p); }
  else if (playing) post({kind: 'play'});
}
let drag = null, orbit = false;
canvas.onmousedown = e => { drag = [e.clientX, e.clientY, e.shiftKey]; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag) return;
  const [x0, y0, panning] = drag;
  drag = [e.clientX, e.clientY, panning];
  post({kind: panning ? 'pan' : 'rotate', dx: e.clientX - x0,
        dy: e.clientY - y0, orbit: orbit});
};
canvas.onwheel = e => { e.preventDefault();
  post({kind: 'zoom', amount: -e.deltaY * 0.001}); };
window.onkeydown = e => {
  const moves = {w: [1,0,0], s: [-1,0,0], d: [0,1,0], a: [0,-1,0],
                 e: [0,0,1], q: [0,0,-1]};
  const k = e.key.toLowerCase();
  if (k in moves) { const [f, r, u] = moves[k];
    post({kind: 'move', forward: f * 0.1, rightward: r * 0.1, upward: u * 0.1}); }
  if (k === 'o') orbit = !orbit;
};
document.getElementById('type').onchange = e =>
  post({kind: 'options', out_type: e.target.value});
document.getElementById('level').onchange = e =>
  post({kind: 'options', level: +e.target.value});
document.getElementById('play').onclick = () => {
  playing = !playing;
  document.getElementById('play').textContent =
    playing ? 'stop' : 'play path';
  if (playing) post({kind: 'play'});
};
post({kind: 'none'});
</script></body></html>"""


def _depth_colormap(depth: np.ndarray) -> np.ndarray:
    """JET-style colormap of a depth map (matches the visualizer's depth
    video convention)."""
    d = depth.astype(np.float32)
    lo, hi = float(d.min()), float(d.max())
    t = (d - lo) / max(hi - lo, 1e-9)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


class ViewerState:
    """Server-side state: camera + options + render closure, with a lock
    (one card: renders serialize). ``frame_times`` holds one dict per served
    frame: ``render_ms`` (the render function's call, the span
    ``viewer.render``), ``encode_ms`` (the colormap and the JPEG,
    ``viewer.encode``) and the render function's ``stats``."""

    def __init__(self, render_fn, camera: InteractiveCamera,
                 options: RenderOptions | None = None):
        self.render_fn = render_fn
        self.camera = camera
        self.options = options or RenderOptions()
        self.lock = threading.Lock()
        self.frame_times: list = []

    def handle(self, ev: dict) -> bytes:
        """Apply one UI event, render, return JPEG bytes."""
        import cv2

        with self.lock:
            cam, opt = self.camera, self.options
            kind = ev.get("kind", "none")
            if kind == "rotate":
                cam.rotate(ev.get("dx", 0.0), ev.get("dy", 0.0),
                           about_origin=bool(ev.get("orbit", False)))
            elif kind == "pan":
                cam.pan(ev.get("dx", 0.0), ev.get("dy", 0.0))
            elif kind == "zoom":
                cam.zoom(float(ev.get("amount", 0.0)))
            elif kind == "move":
                cam.move(float(ev.get("forward", 0.0)),
                         float(ev.get("rightward", 0.0)),
                         float(ev.get("upward", 0.0)))
            elif kind == "play" and cam.has_path:
                cam.play(opt.play_speed)
            elif kind == "options":
                if "out_type" in ev:
                    opt.out_type = str(ev["out_type"])
                if "level" in ev:
                    opt.level = int(ev["level"])

            with collect() as table:
                with span("viewer.render"):
                    frame = np.asarray(self.render_fn(cam.c2w(), opt))
                with span("viewer.encode"):
                    if frame.ndim == 2:  # depth map
                        frame = _depth_colormap(frame)
                    ok, buf = cv2.imencode(
                        ".jpg", frame[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92]
                    )
            assert ok
            self.frame_times.append({"render_ms": table.seconds("viewer.render") * 1e3,
                                     "encode_ms": table.seconds("viewer.encode") * 1e3,
                                     **getattr(self.render_fn, "stats", {})})
            return buf.tobytes()


class _Handler(BaseHTTPRequestHandler):
    state: ViewerState  # injected by make_server

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, _PAGE.encode(), "text/html")
        elif self.path == "/meta":
            cam = self.state.camera
            meta = {
                "window_hw": list(self.state.options.window_hw),
                "has_path": cam.has_path,
                "center": list(map(float, cam.center)),
            }
            self._send(200, json.dumps(meta).encode(), "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/event":
            self._send(404, b"not found", "text/plain")
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            ev = json.loads(self.rfile.read(n) or b"{}")
            jpeg = self.state.handle(ev)
        except Exception as e:  # surface render errors to the page
            self._send(500, str(e).encode(), "text/plain")
            return
        self._send(200, jpeg, "image/jpeg")


def make_server(state: ViewerState, port: int = 8008,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"state": state})
    return ThreadingHTTPServer((host, port), handler)


# ---------------------------------------------------------------------------
# wiring to the real pipeline
# ---------------------------------------------------------------------------

def build_render_fn(cfg, device=None):
    """Load the model, its weights (``runner._init_or_load``) and the test
    split per cfg and return (render_fn, camera, options) for
    ``ViewerState``: the per-frame flow of ``runner.render_novel_path`` (the
    batch of ``runner.pose_batch``, for boost models the greedy view
    selection per frame, the frame through ``runner.make_forward``). Runs
    on CUDA unless ``device`` says otherwise.

    ``render_fn`` runs under ``torch.no_grad()`` itself: the server renders
    in its handler threads, and grad mode is per thread. It times the
    batch (``batch_ms``: the source views read from disk, the span
    ``data.pose_batch``), the selection (``select_ms``, ``selection``) and
    the forward (``forward_ms``, ``eval.frame``) apart, the last two to a
    synchronisation of the card, and keeps them with the picks in
    ``render_fn.stats`` (``batch_ms``, ``select_ms``, ``forward_ms``,
    ``k_best``); ``render_fn.model`` is the
    network. A level
    the config does not render (level 0 under ``render_if (False, True)``)
    raises, as in JAX, and the server answers 500."""
    import torch

    from boostmvsnerfs_torch import resolve_device, runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.models.boost_enerf import view_combinations

    device = resolve_device(device)
    model = runner.make_network(cfg, device)
    runner._init_or_load(cfg, model)
    fwd = runner.make_forward(cfg, model)
    dataset = make_dataset(cfg, "test")
    boost = runner.requires_view_selection(cfg)
    n_views = int(cfg["enerf"]["test_input_views"])
    if boost:
        combos = view_combinations(n_views, int(cfg["enerf"].get("cost_volume_input_views", 3)))
        k = int(cfg["enerf"]["cas_config"]["k_best"])
    render_scale = cfg["enerf"]["cas_config"]["render_scale"]

    scene, anchors = runner.path_anchors(dataset)
    H, W = dataset.get_sample(0)["src_inps"].shape[1:3]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def render_fn(c2w: np.ndarray, opt: RenderOptions) -> np.ndarray:
        with torch.no_grad(), collect() as table:
            np_batch = runner.pose_batch(cfg, dataset, scene, c2w)
            if boost:
                np_batch["combos"] = combos
                np_batch["k_best"] = runner.greedy_select(
                    model, runner._device_batch(np_batch, device), combos, k)
            batch = runner._device_batch(np_batch, device)
            sync()
            with span("eval.frame"):
                out = fwd(batch)
                sync()
        render_fn.stats = {"batch_ms": table.seconds("data.pose_batch") * 1e3,
                           "select_ms": table.seconds("selection") * 1e3,
                           "forward_ms": table.seconds("eval.frame") * 1e3,
                           "k_best": np_batch["k_best"][0].tolist() if boost else None}
        level = opt.level
        r_s = float(render_scale[level])
        hw = (int(H * r_s), int(W * r_s))
        if opt.out_type == "depth" and f"depth_level{level}" in out:
            return out[f"depth_level{level}"][0].cpu().numpy().reshape(hw)
        rgb = out[f"rgb_level{level}"][0].cpu().numpy().reshape(*hw, 3)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    render_fn.model = model
    render_fn.stats = {}
    camera = InteractiveCamera.from_pose(
        anchors[0],
        move_speed=float(np.linalg.norm(
            anchors[:, :3, 3].max(0) - anchors[:, :3, 3].min(0)
        ) * 0.05 + 1e-3),
    )
    camera.origin = anchors[:, :3, 3].mean(0)
    camera.set_path(anchors)
    options = RenderOptions(window_hw=(H, W))
    return render_fn, camera, options


def run_gui(cfg, device=None, port: int = 8008, host: str = "127.0.0.1"):
    """Entry point for ``python -m boostmvsnerfs_torch.run --type gui``:
    serves until interrupted. Runs on CUDA unless ``device`` says
    otherwise."""
    render_fn, camera, options = build_render_fn(cfg, device)
    state = ViewerState(render_fn, camera, options)
    server = make_server(state, port=port, host=host)
    print(f"viewer on http://{host}:{server.server_address[1]}/ — ctrl-c to stop", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
