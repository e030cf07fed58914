"""Batch iteration: shuffling, per-process sharding, view-count sampling
(counterpart of ``boostmvsnerfs_tpu/data/loader.py``, the same batches in
the same order).

Replacement for the reference's torch samplers and multi-worker
DataLoader (lib/datasets/samplers.py, lib/datasets/make_dataset.py:81-104):
* categorical input-view-count resampling per batch (``EnerfBatchSampler``
  :9-35)
* per-batch random target image size (``ImageSizeBatchSampler`` :38-75,
  sizes rounded up to the next multiple of 32)
* fixed-iteration epochs (``IterationBasedBatchSampler`` :78-100)
* per-process index sharding with epoch-seeded shuffle
  (``DistributedSampler`` :103-159) — keyed on the ``num_processes`` /
  ``process_index`` arguments (one process by default).
* sample building fans out over a thread pool with bounded lookahead
  (the reference's ``num_workers`` processes; image decode and numpy
  resizes release the GIL) while batches are yielded strictly in order.

Host-side numpy RNG drives every data decision (ray pixels, view counts,
view jitter) so model computation stays deterministic; each batch draws
from an independent deterministic stream so pool scheduling cannot
reorder randomness.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from boostmvsnerfs_torch.data.base import collate


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        ep_iter: int = -1,
        input_views_num=None,
        input_views_prob=None,
        num_processes: int = 1,
        process_index: int = 0,
        seed: int = 0,
        prefetch: int = 4,
        num_workers: int = 4,
        image_size_meta: dict | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.ep_iter = ep_iter
        self.input_views_num = input_views_num
        self.input_views_prob = input_views_prob
        self.num_processes = num_processes
        self.process_index = process_index
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        # {'strategy': 'range'|'origin', 'min_hw': [h,w], 'max_hw': [h,w]}
        self.image_size_meta = image_size_meta
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        # pad so every process sees the same count (reference samplers.py:131-137)
        per = int(np.ceil(n / self.num_processes))
        pad = per * self.num_processes - n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.process_index::self.num_processes]

    def __len__(self):
        if self.ep_iter > 0:
            return self.ep_iter
        return len(self._indices()) // self.batch_size

    def _batch_indices(self):
        idx = self._indices()
        nb = len(idx) // self.batch_size
        batches = [
            idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)
        ]
        if self.ep_iter > 0:
            # wrap around to exactly ep_iter batches (reference samplers.py:78-100)
            out = []
            k = 0
            while len(out) < self.ep_iter:
                if k >= len(batches):
                    k = 0
                    self.epoch += 1  # reshuffle for wrap
                    idx = self._indices()
                    batches = [
                        idx[i * self.batch_size:(i + 1) * self.batch_size]
                        for i in range(len(idx) // self.batch_size)
                    ]
                    if not batches:
                        break
                out.append(batches[k])
                k += 1
            batches = out
        return batches

    def _sample_hw(self, rng) -> tuple | None:
        """Per-batch target size (reference ImageSizeBatchSampler
        generate_height_width, lib/datasets/samplers.py:50-57: uniform in
        [min, max] rounded up to the next multiple of 32)."""
        meta = self.image_size_meta
        if not meta or meta.get("strategy", "origin") == "origin":
            return None
        hmin, wmin = meta["min_hw"]
        hmax, wmax = meta["max_hw"]
        h = int(rng.integers(hmin, hmax + 1))
        w = int(rng.integers(wmin, wmax + 1))
        return (h | 31) + 1, (w | 31) + 1

    def __iter__(self):
        plan_rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        batches = self._batch_indices()

        # all per-batch random decisions are drawn up front, in order, so
        # the pool's completion order cannot perturb the random stream
        plan = []
        for k, b in enumerate(batches):
            vn = (
                int(plan_rng.choice(self.input_views_num,
                                    p=self.input_views_prob))
                if self.input_views_num is not None
                else None
            )
            hw = self._sample_hw(plan_rng)
            plan.append((b, vn, hw, int(plan_rng.integers(0, 2**31))))

        def build(entry):
            b, vn, hw, sample_seed = entry
            rng = np.random.default_rng(sample_seed)
            samples = [
                self.dataset.get_sample(int(i), vn, rng, size_hw=hw)
                for i in b
            ]
            return collate(samples)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            lookahead = self.num_workers + self.prefetch
            futures = [pool.submit(build, e) for e in plan[:lookahead]]
            nxt = len(futures)
            for k in range(len(plan)):
                out = futures[k].result()
                if nxt < len(plan):
                    futures.append(pool.submit(build, plan[nxt]))
                    nxt += 1
                yield out
