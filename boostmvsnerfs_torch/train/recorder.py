"""Training metrics recorder: tensorboard scalars and windowed console
statistics (counterpart of ``boostmvsnerfs_tpu/train/recorder.py``).

Reference lib/train/recorder.py: SmoothedValue medians over a deque window.
Under a process group rank 0 alone writes (JAX's ``enabled``).
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from boostmvsnerfs_torch.parallel.mesh import rank


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)

    def update(self, value: float):
        self.deque.append(value)

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0


class Recorder:
    """Scalars go to tensorboard under ``record_dir`` when ``tensorboardX``
    is installed (on rank 0), and to the console through ``str``."""

    def __init__(self, record_dir: str | None = None):
        self.step = 0
        self.stats = defaultdict(SmoothedValue)
        self.writer = None
        if record_dir and rank() == 0:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(log_dir=record_dir)

    def update(self, scalars: dict):
        for k, v in scalars.items():
            self.stats[k].update(float(v))

    def record(self, prefix: str = "train"):
        if self.writer is None:
            return
        for k, v in self.stats.items():
            self.writer.add_scalar(f"{prefix}/{k}", v.median, self.step)

    def close(self):
        if self.writer is not None:
            self.writer.close()

    def __str__(self):
        return "  ".join(f"{k}: {v.median:.4f}" for k, v in sorted(self.stats.items()))
