"""Shared multi-view dataset machinery (counterpart of
``boostmvsnerfs_tpu/data/base.py``, the same arrays for the same files and
``rng``).

The reference builds per-target-view samples with CPU-side ray tensors
(lib/datasets/enerf_utils.py:25-71). Here a sample carries *pixel indices*
per cascade level instead of 8-float ray tensors: rays are reconstructed on
device from the camera matrices (ops/geometry.rays_from_pixels), so the
host->device payload per level shrinks from N x 8 floats to N x int32.
OpenCV is optional, as in the JAX package: without it the resizes take
their numpy fallbacks.
"""

from __future__ import annotations

import numpy as np


def _cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def nearest_src_views(c2ws_train, c2w_tar, n, exclude_self: bool):
    """Nearest-camera source-view selection (reference
    lib/datasets/free/enerf_base.py:62-70)."""
    dist = np.linalg.norm(c2ws_train[:, :3, 3] - c2w_tar[:3, 3][None], axis=-1)
    order = np.argsort(dist)
    if exclude_self:
        order = order[1:]
    return order[:n]


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    if img.shape[0] == H and img.shape[1] == W:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    # coarse fallback: strided subsample
    ys = (np.linspace(0, img.shape[0] - 1, H)).astype(int)
    xs = (np.linspace(0, img.shape[1] - 1, W)).astype(int)
    return img[ys][:, xs]


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2 INTER_NEAREST semantics (sample at floor(dst * src/dst scale))."""
    if img.shape[0] == H and img.shape[1] == W:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)
    ys = np.minimum(
        (np.arange(H) * img.shape[0] / H).astype(int), img.shape[0] - 1
    )
    xs = np.minimum(
        (np.arange(W) * img.shape[1] / W).astype(int), img.shape[1] - 1
    )
    return img[ys][:, xs]


def sample_patch_pixels(rng, num_patch, patch_size, H, W, msk_sample):
    """(X, Y) pixel coords of ``num_patch`` contiguous square patches.

    Reference lib/datasets/enerf_utils.py:5-23 ``sample_patch``: patch
    centers drawn from the foreground mask when it is non-empty (clipped so
    the patch stays in-frame), uniformly otherwise; each patch contributes
    its full patch_size^2 pixel grid, offsets -half .. patch_size-1-half.
    The clip's upper bound is the last centre whose patch stays in-frame.
    The JAX package clips to W - half and H - half, one pixel too far for
    odd sizes (a patch there wraps into the next row, or past the image on
    the last row); the two agree wherever JAX's patch is in-frame.
    """
    half = patch_size // 2
    fg = int(msk_sample.sum())
    if fg > 0:
        num_fg = num_patch
        ys, xs = msk_sample.nonzero()
        perm = rng.permutation(fg)[:num_fg]
        X_ = np.clip(xs[perm], half, W - patch_size + half)
        Y_ = np.clip(ys[perm], half, H - patch_size + half)
    else:
        num_fg = 0
    n_uniform = num_patch - num_fg
    X = rng.integers(half, W - half, n_uniform)
    Y = rng.integers(half, H - half, n_uniform)
    if num_fg > 0:
        X = np.concatenate([X, X_]).astype(np.int32)
        Y = np.concatenate([Y, Y_]).astype(np.int32)
    gx, gy = np.meshgrid(
        np.arange(patch_size) - half, np.arange(patch_size) - half
    )
    X_all = np.concatenate([gx.reshape(-1) + x for x in X])
    Y_all = np.concatenate([gy.reshape(-1) + y for y in Y])
    return X_all.astype(np.int32), Y_all.astype(np.int32)


def sample_train_pixels(
    rng, H, W, num_rays, msk, sample_on_mask=False, num_patchs=0,
    patch_size=-1,
):
    """Flat pixel indices for one training level.

    Reference lib/datasets/enerf_utils.py:35-51 (train branch of
    ``build_rays``): with ``sample_on_mask``, up to 75% of the ray budget
    (capped at 95% of the foreground) is drawn from mask pixels and the
    rest uniformly; ``num_patchs`` contiguous patches are appended on top.
    The returned count is static per config: ``num_rays`` +
    ``num_patchs * patch_size**2`` (mask sampling replaces uniform rays,
    it does not add any).
    """
    if sample_on_mask:
        msk_sample = np.asarray(msk).astype(bool)
        num_fg = int(min(num_rays * 0.75, msk_sample.sum() * 0.95))
        ys, xs = msk_sample.nonzero()
        perm = rng.permutation(msk_sample.sum())[:num_fg]
        X_, Y_ = xs[perm], ys[perm]
    else:
        num_fg = 0
        msk_sample = np.zeros((H, W), dtype=bool)
    n_uniform = num_rays - num_fg
    X = rng.integers(0, W, n_uniform)
    Y = rng.integers(0, H, n_uniform)
    if num_fg > 0:
        X = np.concatenate([X, X_]).astype(np.int32)
        Y = np.concatenate([Y, Y_]).astype(np.int32)
    if num_patchs > 0:
        X_, Y_ = sample_patch_pixels(
            rng, num_patchs, patch_size, H, W, msk_sample
        )
        X = np.concatenate([X, X_]).astype(np.int32)
        Y = np.concatenate([Y, Y_]).astype(np.int32)
    return (Y.astype(np.int64) * W + X).astype(np.int32)


class MultiViewDataset:
    """Base for Free / ScanNet / DTU / custom datasets.

    Subclasses populate ``self.scene_infos`` ({scene: {'c2ws', 'ixts',
    'img_paths', 'depth_ranges', ...}}) and ``self.metas``
    ([(scene, tar_view, src_views)]), and implement ``read_image``.
    """

    def __init__(self, cas_cfg, split: str, input_h_w=None):
        self.cas = cas_cfg
        self.split = split
        self.input_h_w = tuple(input_h_w) if input_h_w else None
        self.scene_infos = {}
        self.metas = []

    # -- subclass hooks -------------------------------------------------
    def read_image(self, scene_info, view_idx, for_target: bool):
        raise NotImplementedError

    def scene_near_far(self, scene_info, tar_view) -> np.ndarray:
        dr = np.asarray(scene_info["depth_ranges"])
        return np.array([dr[:, 0].min(), dr[:, 1].max()], dtype=np.float32)

    def camera(self, scene_info, view_idx, orig_size):
        """(ixt scaled to input size, w2c ext)."""
        c2w = scene_info["c2ws"][view_idx]
        ixt = scene_info["ixts"][view_idx].copy()
        if self.input_h_w is not None:
            ixt[0] *= self.input_h_w[1] / orig_size[0]
            ixt[1] *= self.input_h_w[0] / orig_size[1]
        return ixt.astype(np.float32), np.linalg.inv(c2w).astype(np.float32)

    # -- sample assembly ------------------------------------------------
    def __len__(self):
        return len(self.metas)

    def get_sample(
        self, index: int, input_views_num: int | None = None, rng=None,
        size_hw: tuple | None = None,
    ) -> dict:
        """Build one training/eval sample.

        ``size_hw`` overrides the target image size for this sample (the
        per-batch random resolution of the reference's ImageSizeBatchSampler,
        lib/datasets/samplers.py:38-75): images resize to (h, w) and the
        intrinsics rescale with them.
        """
        rng = rng or np.random.default_rng()
        scene, tar_view, src_views = self.metas[index]
        src_views = self.jitter_src_views(src_views, input_views_num, rng)
        info = self.scene_infos[scene]

        def with_size(img, ixt):
            if size_hw is None:
                return img, ixt
            h0, w0 = img.shape[:2]
            h, w = size_hw
            ixt = ixt.copy()
            ixt[0] *= w / w0
            ixt[1] *= h / h0
            return resize_area(img, h, w), ixt

        imgs, exts, ixts = [], [], []
        for v in src_views:
            img, orig = self.read_image(info, v, for_target=False)
            ixt, ext = self.camera(info, v, orig)
            img, ixt = with_size(img, ixt)
            imgs.append((img * 2.0 - 1.0).astype(np.float32))
            ixts.append(ixt)
            exts.append(ext)
        src_inps = np.stack(imgs)  # (S, H, W, 3) in [-1, 1]

        tar_img, orig = self.read_image(info, tar_view, for_target=True)
        tar_ixt, tar_ext = self.camera(info, tar_view, orig)
        tar_img, tar_ixt = with_size(tar_img, tar_ixt)
        tar_msk = self.target_mask(info, tar_view, tar_img)

        sample = {
            "src_inps": src_inps,
            "src_exts": np.stack(exts),
            "src_ixts": np.stack(ixts),
            "all_src_inps": src_inps,
            "all_src_exts": np.stack(exts),
            "all_src_ixts": np.stack(ixts),
            "tar_ext": tar_ext,
            "tar_ixt": tar_ixt,
            "near_far": self.scene_near_far(info, tar_view),
            # per-source-view depth ranges (MVSNeRF per-cost-volume near/far,
            # reference lib/datasets/free/mvsnerf_base.py adds these)
            "depth_ranges": self.view_depth_ranges(info, src_views),
            "meta": {"scene": scene, "tar_view": int(tar_view), "frame_id": 0},
        }
        if self.split != "train":
            sample["tar_img"] = tar_img.astype(np.float32)
            sample["tar_msk"] = tar_msk

        H, W = tar_img.shape[:2]
        for i in range(self.cas.num):
            scale = self.cas.render_scale[i]
            H_r, W_r = int(H * scale), int(W * scale)
            img_i = resize_area(tar_img, H_r, W_r)
            msk_i = resize_area(tar_msk.astype(np.float32), H_r, W_r) >= 0.5
            if self.split == "train" and not self.cas.train_img[i]:
                idx = sample_train_pixels(
                    rng, H_r, W_r, self.cas.num_rays[i], msk_i,
                    sample_on_mask=self.cas.sample_on_mask,
                    num_patchs=self.cas.num_patchs[i],
                    patch_size=self.cas.patch_size[i],
                )
            else:
                idx = np.arange(H_r * W_r, dtype=np.int32)
            sample[f"ray_idx_{i}"] = idx
            sample[f"rgb_{i}"] = img_i.reshape(-1, 3)[idx].astype(np.float32)
            sample[f"msk_{i}"] = msk_i.reshape(-1)[idx]
            sample["meta"][f"h_{i}"] = H_r
            sample["meta"][f"w_{i}"] = W_r
        self.add_extra_fields(info, tar_view, sample)
        return sample

    def add_extra_fields(self, scene_info, tar_view, sample):
        """Dataset-specific extras (e.g. DTU ground-truth depth for eval)."""

    def jitter_src_views(self, src_views, input_views_num, rng):
        """Train-time source-view subsampling; default: truncate to the
        requested count. DTU overrides with random jitter."""
        if input_views_num is not None and len(src_views) > input_views_num:
            return list(src_views)[:input_views_num]
        return list(src_views)

    def target_mask(self, scene_info, tar_view, tar_img) -> np.ndarray:
        return np.ones(tar_img.shape[:2], dtype=np.uint8)

    def view_depth_ranges(self, scene_info, views) -> np.ndarray:
        if "depth_ranges" in scene_info:
            return np.asarray(
                [scene_info["depth_ranges"][v] for v in views], np.float32
            )
        nf = self.scene_near_far(scene_info, views[0] if views else 0)
        return np.tile(nf, (len(views), 1)).astype(np.float32)


def collate(samples: list[dict]) -> dict:
    """Stack samples into a batch; 'meta' entries become lists."""
    out = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out
