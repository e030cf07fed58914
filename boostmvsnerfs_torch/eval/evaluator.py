"""Per-scene evaluation with PSNR/SSIM/LPIPS and DTU depth metrics
(counterpart of ``boostmvsnerfs_tpu/eval/evaluator.py``: the same keys and
per-scene aggregation).

Re-design of reference lib/evaluators/enerf.py: masked full-render metrics
per cascade level, per-scene aggregation with a summary table, optional
center crop (LLFF protocol, reference :50-54), and DTU depth abs/acc@2/acc@10
for both NeRF and MVS depth (reference :89-103). The metrics run on the
rendered outputs' device; the ground truth comes from the numpy batch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from boostmvsnerfs_torch.data.base import resize_nearest
from boostmvsnerfs_torch.data.formats import write_image_file
from boostmvsnerfs_torch.eval import metrics


class Evaluator:
    def __init__(
        self,
        cas_cfg,
        lpips_fn=None,
        lpips_key: str = "lpips",
        eval_depth: bool = False,
        eval_center: bool = False,
        save_result: bool = False,
        result_dir: str | None = None,
    ):
        self.cas = cas_cfg
        # None: no LPIPS
        self.lpips_fn = lpips_fn
        # 'lpips_uncalibrated' when running on fixture weights
        self.lpips_key = lpips_key
        self.eval_depth = eval_depth
        self.eval_center = eval_center
        self.save_result = save_result
        self.result_dir = result_dir
        if save_result and result_dir:
            os.makedirs(result_dir, exist_ok=True)
        self.reset()

    def reset(self):
        self.psnrs, self.ssims, self.lpips = [], [], []
        self.scene_psnrs, self.scene_ssims, self.scene_lpips = {}, {}, {}
        self.depth_stats = {k: [] for k in
                            ["abs", "acc_2", "acc_10", "mvs_abs", "mvs_acc_2", "mvs_acc_10"]}

    def evaluate(self, output: dict, batch: dict):
        """``output``: the render's tensors (or arrays); ``batch``: the
        numpy batch, whose 'meta' is a list of per-sample meta dicts."""
        metas = batch["meta"]
        B = len(metas)
        last = self.cas.num - 1
        for i in range(self.cas.num):
            if not self.cas.render_if[i]:
                continue
            h, w = metas[0][f"h_{i}"], metas[0][f"w_{i}"]
            pred = torch.as_tensor(output[f"rgb_level{i}"]).reshape(B, h, w, 3)
            gt = torch.as_tensor(np.asarray(batch[f"rgb_{i}"]), device=pred.device)
            gt = gt.reshape(B, h, w, 3)
            msk = torch.as_tensor(np.asarray(batch[f"msk_{i}"]), device=pred.device)
            msk = msk.reshape(B, h, w) >= 1

            if self.eval_center:
                hc, wc = int(h * 0.1), int(w * 0.1)
                pred = pred[:, hc:-hc, wc:-wc]
                gt = gt[:, hc:-hc, wc:-wc]
                msk = msk[:, hc:-hc, wc:-wc]

            for b in range(B):
                scene = metas[b]["scene"]
                key = f"{scene}_level{i}"
                for d in (self.scene_psnrs, self.scene_ssims, self.scene_lpips):
                    d.setdefault(key, [])

                if self.save_result and i == last and self.result_dir:
                    self._save_image(gt[b], pred[b], metas[b])

                p = torch.where(msk[b][..., None], pred[b], 0.0)
                g = torch.where(msk[b][..., None], gt[b], 0.0)
                psnr_v = float(metrics.masked_psnr(p, g, msk[b]))
                ssim_v = float(metrics.ssim(p, g))
                self.scene_psnrs[key].append(psnr_v)
                self.scene_ssims[key].append(ssim_v)
                if i == last:
                    self.psnrs.append(psnr_v)
                    self.ssims.append(ssim_v)
                if self.lpips_fn is not None:
                    lp = float(self.lpips_fn((g * 2 - 1)[None], (p * 2 - 1)[None])[0])
                    self.scene_lpips[key].append(lp)
                    if i == last:
                        self.lpips.append(lp)

                if self.eval_depth and i == last and "tar_dpt" in batch:
                    self._depth_eval(output, batch, b, h, w)

    def _depth_eval(self, output, batch, b, h, w):
        last = self.cas.num - 1
        nerf_depth = torch.as_tensor(output[f"depth_level{last}"])[b].reshape(h, w)
        mvs_depth = torch.as_tensor(output[f"depth_mvs_level{last}"])[b]
        gt = np.asarray(batch["tar_dpt"])[b].reshape(h, w)
        # INTER_NEAREST matches the reference's MVS-depth GT downsample
        # (reference lib/evaluators/enerf.py:95)
        mvs_gt = resize_nearest(gt, *mvs_depth.shape)
        dev = nerf_depth.device
        d = metrics.depth_metrics(nerf_depth, torch.as_tensor(gt, device=dev))
        m = metrics.depth_metrics(mvs_depth, torch.as_tensor(mvs_gt, device=dev))
        for k, v in d.items():
            self.depth_stats[k].append(v)
        for k, v in m.items():
            self.depth_stats[f"mvs_{k}"].append(v)

    def _save_image(self, gt, pred, meta):
        img = torch.cat([gt, pred], dim=1).cpu().numpy()
        path = os.path.join(
            self.result_dir,
            "{}_{}_{}.png".format(meta["scene"], meta["tar_view"], meta["frame_id"]),
        )
        write_image_file(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))

    def summarize(self) -> dict:
        ret = {"psnr": float(np.mean(self.psnrs)) if self.psnrs else float("nan"),
               "ssim": float(np.mean(self.ssims)) if self.ssims else float("nan")}
        if self.lpips:
            ret[self.lpips_key] = float(np.mean(self.lpips))
        print("=" * 30)
        for scene in self.scene_psnrs:
            line = "{} psnr: {:.2f} ssim: {:.3f}".format(
                scene.ljust(16),
                np.mean(self.scene_psnrs[scene]),
                np.mean(self.scene_ssims[scene]),
            )
            if self.scene_lpips.get(scene):
                line += " {}: {:.3f}".format(self.lpips_key, np.mean(self.scene_lpips[scene]))
            print(line)
        print("=" * 30)
        print(ret)
        if self.eval_depth and self.depth_stats["abs"]:
            depth_ret = {k: float(np.mean(v)) for k, v in self.depth_stats.items() if v}
            print(depth_ret)
            ret.update(depth_ret)
        self.reset()
        return ret
