"""Interactive camera state + render options (counterpart of
``boostmvsnerfs_tpu/interactive/camera.py``, the same poses under the same
events).

Python port of the behaviors of the reference viewer camera
(``lib/interactive/camera.py``: glm-based center/front/
world-up state, drag rotation optionally about the origin, panning along
the image plane, WASD movement, and B-spline camera-path playback keyed by
a [0, 1] parameter) — re-implemented on numpy with OpenCV-convention
matrices so it plugs straight into the dataset extrinsics.

Conventions: ``c2w`` columns are [right, down, front] with the camera
center in the last column (x right, y down, z forward — the convention of
the datasets' ``exts``)."""

from __future__ import annotations

import dataclasses

import numpy as np

from boostmvsnerfs_torch.utils.camera_paths import interpolate_path


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-9)


@dataclasses.dataclass
class RenderOptions:
    """Modifiable render options (reference
    lib/interactive/render_options.py: render level, output type, window
    size, autoplay along the dataset camera path)."""

    level: int = 1
    out_type: str = "pred"  # 'pred' | 'depth'
    window_hw: tuple = (512, 512)
    autoplay: bool = False
    play_speed: float = 0.005  # path-parameter increment per frame


class InteractiveCamera:
    """Orbit/fly camera over (center, front, world-up) state."""

    def __init__(
        self,
        center=(0.0, 0.0, 0.0),
        front=(0.0, 0.0, 1.0),
        world_up=(0.0, -1.0, 0.0),
        origin=(0.0, 0.0, 0.0),
        move_speed: float = 1.0,
        rotate_speed: float = 0.005,
    ):
        self.center = np.asarray(center, np.float64).copy()
        self.front = _normalize(np.asarray(front, np.float64))
        self.world_up = _normalize(np.asarray(world_up, np.float64))
        self.origin = np.asarray(origin, np.float64).copy()
        self.move_speed = float(move_speed)
        self.rotate_speed = float(rotate_speed)
        self._path: np.ndarray | None = None
        self.path_u = 0.0

    # -- pose ------------------------------------------------------------
    @classmethod
    def from_pose(cls, c2w: np.ndarray, **kw) -> "InteractiveCamera":
        c2w = np.asarray(c2w, np.float64)
        return cls(
            center=c2w[:3, 3],
            front=c2w[:3, 2],
            world_up=-c2w[:3, 1],
            **kw,
        )

    @property
    def right(self) -> np.ndarray:
        return _normalize(np.cross(self.front, self.world_up))

    @property
    def down(self) -> np.ndarray:
        return np.cross(self.front, self.right)

    def c2w(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, 0] = self.right
        m[:3, 1] = self.down
        m[:3, 2] = self.front
        m[:3, 3] = self.center
        return m

    def w2c(self) -> np.ndarray:
        m = self.c2w()
        out = np.eye(4)
        out[:3, :3] = m[:3, :3].T
        out[:3, 3] = -m[:3, :3].T @ m[:3, 3]
        return out

    # -- interactions ------------------------------------------------------
    def rotate(self, dx: float, dy: float, about_origin: bool = False):
        """Drag rotation (reference camera.py: yaw about world-up, pitch
        about the right axis; ``about_origin`` orbits the scene origin
        instead of turning in place)."""
        yaw = -dx * self.rotate_speed
        pitch = -dy * self.rotate_speed
        R = _axis_angle(self.world_up, yaw) @ _axis_angle(self.right, pitch)
        if about_origin:
            self.center = self.origin + R @ (self.center - self.origin)
        self.front = _normalize(R @ self.front)

    def pan(self, dx: float, dy: float):
        """Translate along the image plane."""
        step = self.move_speed * 1e-3
        self.center = self.center + (
            -dx * step * self.right + -dy * step * self.down
        )

    def move(self, forward=0.0, rightward=0.0, upward=0.0):
        """WASD-style movement."""
        self.center = self.center + self.move_speed * (
            forward * self.front
            + rightward * self.right
            + upward * self.world_up
        )

    def zoom(self, amount: float):
        """Dolly along the viewing direction."""
        self.center = self.center + amount * self.move_speed * self.front

    # -- camera path -------------------------------------------------------
    def set_path(self, anchors: np.ndarray, n: int = 240):
        """Load a dataset camera path (anchor c2ws); ``play`` then
        interpolates through it with the [0, 1] parameter (reference
        camera.py cam_path_u / B-spline playback)."""
        self._path = np.asarray(interpolate_path(np.asarray(anchors), n))
        self.path_u = 0.0

    @property
    def has_path(self) -> bool:
        return self._path is not None

    def goto_path(self, u: float):
        if self._path is None:
            raise ValueError("no camera path loaded")
        u = float(u) % 1.0
        self.path_u = u
        pose = self._path[int(u * (len(self._path) - 1))]
        self.center = pose[:3, 3].astype(np.float64).copy()
        self.front = _normalize(pose[:3, 2].astype(np.float64))
        self.world_up = _normalize(-pose[:3, 1].astype(np.float64))

    def play(self, speed: float = 0.005):
        self.goto_path(self.path_u + speed)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix."""
    a = _normalize(np.asarray(axis, np.float64))
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
