"""The eval executors (counterpart of ``boostmvsnerfs_tpu/parallel/
staged.py``): ``StagedENeRF`` on the ranks of a mesh, ``StagedMVSNeRF`` in
blocks of raster rows. ``runner.make_forward`` picks one for a model.

``StagedENeRF(model, mesh)`` renders one frame across ranks that each hold
the whole batch:

* without a mesh it is the model's forward;
* on a (data, rays) mesh (``parallel/mesh.make_mesh``) each rank renders
  its tile of its ``data`` shard's rays, gathered at the end
  (``mesh.gather_rays``: JAX's ray-sharded ``make_eval_step``);
* a BoostENeRF on a (cv, rays) mesh (``mesh.make_cv_mesh``) shards the K
  folded cost volumes over ``cv``, as JAX partitions the folded batch axis:
  each ``cv`` rank takes its contiguous ``B * K / cv`` of the fold
  (``BoostENeRF.fold_views``), builds their cascade volumes and renders its
  ``rays`` tile of each rendered level. One gather of the tile's
  ``net_output``, ``mask`` and ``z_vals`` over ``cv`` precedes the cross-K
  ``blend``, the only cross-``cv`` collective of the render, as in JAX;
  ``depth_mvs`` and ``std`` take volume 0, whose holder supplies it through
  a gather of the regressed depths. The rays are gathered at the end.

Every rank computes the FPN over all source views (JAX shards it over the
views).

``StagedMVSNeRF(model, row_chunk)`` renders an MVSNeRF or BoostMVSNeRF frame
as the reference's serial ray chunks do (reference
lib/networks/boost_mvsnerf/network.py:97-135): the features and the (K
folded) volume once (``frame_volume``), then the rays in blocks of
``row_chunk`` whole raster rows (``render_rays``, with the cross-K blend per
block), concatenated. The monolithic forward holds every sample's features
at once (with the v1, v2 and color_fusion heads 23-26 GiB at 224x352 on the
H100, PERF.md section 6); a block holds one block's.

Not carried from JAX: the stage granularity options ``fuse_levels``,
``fuse_frame`` and ``fold_inside``, ``StagedENeRF.coverage_mask`` and the
stages' jits. They exist for XLA's compile time and the TPU's per-dispatch
cost; PyTorch runs eagerly, and a frame in CUDA graphs is speed work, not a
port (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import torch

from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.parallel import mesh as mesh_lib


class StagedENeRF:
    """An ENeRF / BoostENeRF eval forward, sharded over ``mesh`` (module
    docstring). Call it on a batch of numpy arrays or tensors: every rank
    returns the whole frame's outputs."""

    def __init__(self, model, mesh=None):
        self.model = model
        self.mesh = mesh
        self.cv = mesh is not None and "cv" in mesh.mesh_dim_names
        if self.cv and not isinstance(model, BoostENeRF):
            raise ValueError("a (cv, rays) mesh shards the K cost volumes of a BoostENeRF")

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict:
        model = self.model
        if self.mesh is None:
            return model(batch)
        batch = to_tensors(batch, model.device)
        if not self.cv:
            tile = mesh_lib.shard_batch(self.mesh, batch)
            return mesh_lib.gather_rays(self.mesh, model(tile))
        return self._forward_cv(batch)

    def _forward_cv(self, batch: dict) -> dict:
        model, cas = self.model, self.model.cas
        n_cv, i_cv, cv = mesh_lib.axis(self.mesh, "cv")
        B, K = batch["all_src_inps"].shape[0], cas.k_best
        feats, sub = model.fold_views(batch, model.extract_features(batch["all_src_inps"]),
                                      batch["combos"][batch["k_best"]])
        share = B * K // n_cv
        lo = i_cv * share

        def mine(x):
            return x[lo:lo + share]

        feats = {k: mine(v) for k, v in feats.items()}
        sub = mesh_lib.shard_batch(self.mesh, {k: mine(v) for k, v in sub.items()}, ("rays",))
        ret = {}
        prev = None
        for i in range(cas.num):
            feat_vol, depth, std, nf_map = model.build_level_volume(
                i, feats, sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"],
                sub["near_far"], prev,
            )
            prev = (depth, std, nf_map)
            if not cas.render_if[i]:
                continue
            raw = model.render_level(i, feats, feat_vol, depth, std, nf_map, sub,
                                     sub[f"ray_idx_{i}"], return_raw=True)
            raw = {k: mesh_lib.all_gather(v, cv) for k, v in raw.items()}
            out = model.blend(raw, B)
            depth0 = mesh_lib.all_gather(depth, cv).reshape(B, K, *depth.shape[1:])[:, 0]
            out["depth_mvs"] = 1.0 / depth0 if cas.depth_inv[i] else depth0
            out["std"] = mesh_lib.all_gather(std, cv).reshape(B, K, *std.shape[1:])[:, 0]
            ret.update({f"{key}_level{i}": v for key, v in out.items()})
        return mesh_lib.gather_rays(self.mesh, ret, ("rays",))


def ray_blocks(ray_idx: torch.Tensor, W: int, row_chunk: int) -> list:
    """JAX's rule (``StagedMVSNeRF._ray_blocks``): ray ids (B, N) that hold
    whole raster rows of width ``W`` (N % W == 0), more than ``row_chunk``
    rows and a multiple of it, split into contiguous blocks of ``row_chunk *
    W`` ids; any others (random rays, a raster of other rows) stay one
    block."""
    N = ray_idx.shape[1]
    rows = N // W if N % W == 0 else 0
    if rows <= row_chunk or rows % row_chunk:
        return [ray_idx]
    return list(ray_idx.split(row_chunk * W, dim=1))


class StagedMVSNeRF:
    """An MVSNeRF / BoostMVSNeRF eval forward in blocks of ``row_chunk``
    raster rows (module docstring). Call it on a batch of numpy arrays or
    tensors; it returns the model's outputs. A block that does not fit the
    card raises, as the model's forward would."""

    def __init__(self, model, row_chunk: int = 32):
        self.model = model
        self.row_chunk = row_chunk

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict:
        model = self.model
        batch = to_tensors(batch, model.device)
        sub, volume, near, far = model.frame_volume(batch)
        W = batch["all_src_inps"].shape[3]
        outs = [model.render_rays(sub, volume, ids, near, far)
                for ids in ray_blocks(batch["ray_idx_0"], W, self.row_chunk)]
        return {f"{k}_level0": torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}
