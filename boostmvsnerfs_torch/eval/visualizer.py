"""Render-result visualization: colour and depth videos, or per-frame PNGs
(counterpart of ``boostmvsnerfs_tpu/eval/visualizer.py``).

Reference lib/visualizers/enerf.py:21-48: collects frames during evaluation
or a camera path and writes ``color.mp4`` / ``depth.mp4`` (JET colormap on
normalized depth). The videos go through imageio where it can write them,
else through OpenCV's ``cv2.VideoWriter``; where neither can, the colour
frames go out as ``color_NNNN.png``, as the JAX visualizer does when its
video write fails. imageio and OpenCV are imported inside the functions, so
the package imports without them.
"""

from __future__ import annotations

import os

import numpy as np

from boostmvsnerfs_torch.data.formats import write_image_file


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """Normalize depth to [0, 255] and apply JET (uint8 RGB); grey without
    OpenCV."""
    d = depth.astype(np.float32)
    lo, hi = np.nanmin(d), np.nanmax(d)
    norm = np.zeros_like(d) if hi - lo < 1e-12 else (d - lo) / (hi - lo)
    u8 = (norm * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        return np.stack([u8] * 3, axis=-1)
    return cv2.applyColorMap(u8, cv2.COLORMAP_JET)[..., ::-1]


def _write_imageio(path: str, frames: list, fps: int) -> None:
    import imageio.v2 as imageio

    imageio.mimwrite(path, frames, fps=fps)


def _write_cv2(path: str, frames: list, fps: int) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise OSError(f"cv2.VideoWriter cannot open {path}")
    try:
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    finally:
        writer.release()


# video writers, in the order they are tried
VIDEO_WRITERS = {"imageio": _write_imageio, "cv2": _write_cv2}


class Visualizer:
    def __init__(self, cas_cfg, result_dir: str, write_video: bool = True, fps: int = 10):
        self.cas = cas_cfg
        self.result_dir = result_dir
        self.write_video = write_video
        self.fps = fps
        self.color_frames: list[np.ndarray] = []
        self.depth_frames: list[np.ndarray] = []
        os.makedirs(result_dir, exist_ok=True)

    def visualize(self, output: dict, batch: dict):
        """Collect the last level's rgb and depth of every batch entry
        (numpy arrays or tensors)."""
        metas = batch["meta"]
        last = self.cas.num - 1
        h, w = metas[0][f"h_{last}"], metas[0][f"w_{last}"]
        B = len(metas)
        rgb = _numpy(output[f"rgb_level{last}"]).reshape(B, h, w, 3)
        depth = _numpy(output[f"depth_level{last}"]).reshape(B, h, w)
        for b in range(B):
            self.color_frames.append((np.clip(rgb[b], 0, 1) * 255).astype(np.uint8))
            self.depth_frames.append(depth_colormap(depth[b]))

    def summarize(self) -> dict:
        """Write the collected frames: {'writer': 'imageio' | 'cv2' | 'png'
        (or None without frames), 'files': paths written, 'frames': count}.
        The first video writer that writes both videos wins; the PNG frames
        are the fallback."""
        n = len(self.color_frames)
        out = {"writer": None, "files": [], "frames": n}
        if not n:
            return out
        if self.write_video:
            paths = [os.path.join(self.result_dir, f"{k}.mp4") for k in ("color", "depth")]
            for name, write in VIDEO_WRITERS.items():
                try:
                    write(paths[0], self.color_frames, self.fps)
                    write(paths[1], self.depth_frames, self.fps)
                except Exception:  # the writer or its backend is missing
                    continue
                out.update(writer=name, files=paths)
                break
        if out["writer"] is None:
            for i, f in enumerate(self.color_frames):
                path = os.path.join(self.result_dir, f"color_{i:04d}.png")
                write_image_file(path, f)
                out["files"].append(path)
            out["writer"] = "png"
        self.color_frames, self.depth_frames = [], []
        print(f"Visualization written to {self.result_dir} ({out['writer']}, {n} frames)")
        return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
