"""Train and eval steps (counterpart of ``boostmvsnerfs_tpu/parallel/train.py``),
for the ENeRF and MVSNeRF families, on one device or on the ranks of a
(data, rays) mesh (``parallel/mesh.make_mesh``).

One step puts the model in train mode and computes the forward with
batch-statistics BatchNorm, the cascade loss, the gradients, the clip at 40
and the optimizer update (reference
lib/train/trainers/trainer.py:44-93). ``make_blocked_train_step`` bounds the
memory of full-image fine-tuning by rendering in blocks of rays whose
activations are recomputed in the backward.

With a mesh each rank takes its shard of the batch (``place``,
``parallel/mesh.shard_batch``): N ranks then compute what one process
computes on the whole batch, as JAX's GSPMD step does (the reference: DDP
and SyncBatchNorm). The BatchNorms reduce their statistics over ``data``
(``mesh.sync_batchnorm``; ranks of one ``rays`` group hold the same
images); after the backward the gradients are averaged over the world in
flat all-reduces, before the clip, as JAX clips the reduced gradient. The
models' methods are called directly (``render``, and the blocked loss's
stages under ``checkpoint``), so no ``DistributedDataParallel`` wrapper
could see them. Each rank's loss is the mean over its tile, and the tiles
are equal, so the world's mean of the losses is the whole batch's; a level
with the perceptual term, which needs whole images, gathers its rgb and
targets over ``rays`` first, and every rank of the group then takes the
group's loss for that level (the gather's backward sums the ranks'
gradients, which the world mean divides again). The stats come back as the
world's means (each ``psnr_*`` from the mean ``color_mse_*``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import to_tensors
from boostmvsnerfs_torch.parallel import mesh as mesh_lib
from boostmvsnerfs_torch.train.loss import enerf_loss, mse2psnr
from boostmvsnerfs_torch.train.schedule import apply_update
from boostmvsnerfs_torch.utils.profiling import spanned


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters and BatchNorm statistics)
    and the optimizer with its lr schedule."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def create_train_state(model: nn.Module, tx: Callable) -> TrainState:
    """``tx`` is ``train.schedule.make_optimizer(...)``: it builds the
    optimizer (moments at zero) and schedule over the model's parameters."""
    optimizer, scheduler = tx(model.parameters())
    return TrainState(step=0, model=model, optimizer=optimizer, scheduler=scheduler)


@spanned("train.step")
def _update(state: TrainState, loss_fn: Callable, batch: dict, mesh=None) -> dict:
    state.model.train()
    param = next(state.model.parameters())
    batch = to_tensors(batch, param.device, param.dtype)
    state.optimizer.zero_grad(set_to_none=True)
    loss, stats = loss_fn(batch)
    loss.backward()
    stats = {k: v.detach() for k, v in stats.items()}
    if mesh is not None:
        mesh_lib.average_gradients(state.model.parameters())
        stats = _world_mean(stats)
    apply_update(state.optimizer, state.scheduler)
    state.step += 1
    return stats


def _world_mean(stats: dict) -> dict:
    """The stats averaged over the world in one all-reduce; each
    ``psnr_{i}`` recomputed from the mean ``color_mse_{i}``."""
    keys = sorted(stats)
    flat = torch.stack([stats[k].reshape(()) for k in keys])
    torch.distributed.all_reduce(flat)
    flat /= torch.distributed.get_world_size()
    out = dict(zip(keys, flat))
    for k in keys:
        if k.startswith("psnr_"):
            out[k] = mse2psnr(out[f"color_mse_{k[5:]}"])
    return out


def _prepare(model, mesh) -> None:
    """A model under a mesh: its BatchNorms reduce over ``data``."""
    if mesh is not None:
        mesh_lib.sync_batchnorm(model, mesh_lib.axis(mesh, "data")[2])


def _mesh_loss(out: dict, batch: dict, cas, perceptual_fn, image_hw, mesh):
    """``enerf_loss`` on a rank's tile. Under a mesh with ``rays`` > 1 the
    levels with the perceptual term (whole images) first gather their rgb
    and targets over ``rays``."""
    n_rays, _, rays = mesh_lib.axis(mesh, "rays")
    if n_rays > 1 and perceptual_fn is not None and image_hw is not None:
        out, batch = dict(out), dict(batch)
        for i in range(cas.num):
            if cas.render_if[i] and (cas.train_img is None or cas.train_img[i]):
                out[f"rgb_level{i}"] = mesh_lib.all_gather(out[f"rgb_level{i}"], rays, dim=1)
                with torch.no_grad():
                    batch[f"rgb_{i}"] = mesh_lib.all_gather(batch[f"rgb_{i}"], rays, dim=1)
    return enerf_loss(out, batch, cas.loss_weight, cas.num, cas.render_if,
                      perceptual_fn, image_hw, cas.train_img)


def make_train_step(model, perceptual_fn: Callable | None = None,
                    image_hw: tuple | None = None, cas=None, mesh=None) -> Callable:
    """``step(state, batch) -> stats``: one update of ``state`` in place from
    the whole forward's loss (every activation kept for the backward). The
    loss settings (``loss_weight``, ``num``, ``render_if``, ``train_img``)
    come from ``cas``, a ``CascadeConfig``, or else from the model's own:
    an MVSNeRF has none, so its step takes the config's (JAX's step reads
    ``model.cas`` and fails on every MVSNeRF, ROADMAP fault 15). With a
    (data, rays) ``mesh`` the step takes this rank's shard of the batch
    (module docstring)."""
    cas = model.cas if cas is None else cas
    _prepare(model, mesh)

    def loss_fn(batch):
        return _mesh_loss(model.render(batch), batch, cas, perceptual_fn, image_hw, mesh)

    return lambda state, batch: _update(state, loss_fn, batch, mesh)


def make_blocked_train_step(model, ray_blocks: int, perceptual_fn: Callable | None = None,
                            image_hw: tuple | None = None, mesh=None) -> Callable:
    """The memory-bounded step: ``make_train_step`` with the loss of
    ``make_blocked_loss``. Full-image fine-tuning otherwise keeps every
    per-sample render activation from the forward to the backward (65 GB at
    480x736 K=4 in the JAX package). ``mesh`` as in ``make_train_step``."""
    _prepare(model, mesh)
    loss_fn = make_blocked_loss(model, ray_blocks, perceptual_fn, image_hw, mesh)
    return lambda state, batch: _update(state, loss_fn, batch, mesh)


def place(mesh, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
    """A distributed step's inputs: ``state`` as it is, after checking that
    every rank holds the same model (``mesh.assert_replicated``), and this
    rank's shard of the whole ``batch`` (``mesh.shard_batch``)."""
    mesh_lib.assert_replicated(state.model)
    return state, mesh_lib.shard_batch(mesh, batch)


def level_ray_blocks(ray_blocks: int, n_rays: int, n_max: int, rows: int,
                     full_raster: bool) -> int:
    """The number of ray blocks of a level with ``n_rays`` of the finest
    level's ``n_max`` rays: max(1, ray_blocks * n_rays // n_max), rounded
    down to a divisor of the level's row count when it renders its whole
    raster (whole-row blocks), or of ``n_rays`` otherwise."""
    target = max(1, (ray_blocks * n_rays) // max(n_max, 1))
    return next(d for d in range(target, 0, -1) if (rows if full_raster else n_rays) % d == 0)


def make_blocked_loss(model, ray_blocks: int, perceptual_fn: Callable | None = None,
                      image_hw: tuple | None = None, mesh=None) -> Callable:
    """``loss(batch) -> (loss, stats)`` of the ray-blocked step, on a batch
    of tensors on the model's device.

    The ray-independent stages (FPN, every level's cost volume, U-Net and
    depth regression) run once, and so does each level's ray-bounds map
    and per-view feature map (``level_maps``; the JAX step rebuilds the
    maps inside each block, the same values). Each level's rays are then
    rendered in blocks through ``torch.utils.checkpoint`` (non-reentrant):
    the backward recomputes a block's render instead of keeping it, so
    render activations shrink by the number of blocks, for one more render
    forward. ``ray_blocks`` is sized for the finest level (of a rank's tile
    under a ``mesh``, whose tiles are not whole rasters); coarser levels
    take fewer blocks (``level_ray_blocks``), and a level of one block
    renders without recomputation. The BatchNorms sit outside the blocks,
    so recomputation never updates their statistics twice. The assembled
    ``rgb_level{i}`` feed the unchanged ``enerf_loss``.
    """
    cas = model.cas
    boost = isinstance(model, BoostENeRF)

    def blocked_loss(batch):
        if boost:
            B, K = batch["all_src_inps"].shape[0], cas.k_best
            feats, sub = model.fold_combinations(batch)
        else:
            B, K = batch["src_inps"].shape[0], 1
            feats, sub = model.extract_features(batch["src_inps"]), batch
        n_max = max(batch[f"ray_idx_{j}"].shape[1] for j in range(cas.num)
                    if cas.render_if[j] and f"ray_idx_{j}" in batch)
        H, W = batch["all_src_inps" if boost else "src_inps"].shape[2:4]
        out = {}
        prev = None
        for i in range(cas.num):
            feat_vol, depth, std, nf_map = model.build_level_volume(
                i, feats, sub["src_exts"], sub["src_ixts"], sub["tar_ext"], sub["tar_ixt"],
                sub["near_far"], prev,
            )
            prev = (depth, std, nf_map)
            if not cas.render_if[i]:
                continue
            ray_idx = batch[f"ray_idx_{i}"]
            N = ray_idx.shape[1]
            H_r, W_r = int(H * cas.render_scale[i]), int(W * cas.render_scale[i])
            nb = level_ray_blocks(ray_blocks, N, n_max, H_r, N == H_r * W_r and cas.train_img[i])
            maps = model.level_maps(i, feats, depth, std, nf_map, sub["src_inps"])

            def block(ridx, feat_vol, bounds_map, img_feat_rgb, i=i):
                o = model.render_rays(i, (bounds_map, img_feat_rgb), feat_vol, sub,
                                      ridx.repeat_interleave(K, dim=0), return_raw=boost)
                return model.blend(o, B)["rgb"] if boost else o["rgb"]

            if nb == 1:
                rgb = block(ray_idx, feat_vol, *maps)
            else:
                rgb = torch.cat([
                    checkpoint(block, ridx, feat_vol, *maps, use_reentrant=False)
                    for ridx in ray_idx.chunk(nb, dim=1)
                ], dim=1)
            out[f"rgb_level{i}"] = rgb
        return _mesh_loss(out, batch, cas, perceptual_fn, image_hw, mesh)

    return blocked_loss


def make_eval_step(model) -> Callable:
    """``eval(batch) -> outputs``: the model's eval render (no gradients,
    BatchNorm running statistics)."""

    def eval_step(batch):
        model.eval()
        return model(batch)

    return eval_step
