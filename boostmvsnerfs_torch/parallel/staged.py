"""The eval forward on the ranks of a mesh (counterpart of the mesh path of
``boostmvsnerfs_tpu/parallel/staged.py::StagedENeRF``).

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
views). JAX's stage devices for XLA's compile time and the TPU's dispatch
cost stay out: ``fuse_levels``, ``fuse_frame`` and ``fold_inside``, and with
them the frame in CUDA graphs (ROADMAP queue 1 item 4).
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
