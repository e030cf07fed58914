"""Process groups, device meshes and the batch split of multi-GPU training
and sharded eval (counterpart of ``boostmvsnerfs_tpu/parallel/mesh.py``).

One process per rank, launched by ``torch.distributed.run`` (torchrun),
which sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. The ranks form a
``DeviceMesh`` with JAX's axis names and factorisation:

* ``(data, rays)`` (``make_mesh``): training and ray-split eval. ``data``
  splits the batch entries (the reference's DDP axis); gradients and
  BatchNorm statistics reduce over it. ``rays`` splits each image's rays
  into tiles; ranks of one ``rays`` group hold the same images.
* ``(cv, rays)`` (``make_cv_mesh``): the fused boost frame
  (``parallel/staged.StagedENeRF``). ``cv`` splits the K folded cost
  volumes, ``rays`` the rays.

Where JAX lets GSPMD insert the collectives, the port calls them itself:
``all_reduce_sum`` and ``all_gather`` are differentiable, and a gather is an
all-reduce into a zeroed buffer, which every backend (NCCL; gloo on CPU and
on CUDA tensors) runs.
"""

from __future__ import annotations

import contextlib
import hashlib
import os

import torch
import torch.distributed as dist

MESH_AXES = ("data", "rays")
CV_AXES = ("cv", "rays")


def init_distributed(device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device. On CUDA the backend is ``nccl`` unless
    ``backend`` says otherwise and the rank takes card ``LOCAL_RANK`` (modulo
    the card count: gloo ranks may share a card, NCCL refuses to); on the
    CPU it is ``gloo``. Raises when the variables are missing: a world is
    never started here on its own."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment; {missing} unset "
                           "(launch with python -m torch.distributed.run)")
    dev = torch.device(device)
    if dev.type == "cuda":
        from boostmvsnerfs_torch import resolve_device

        resolve_device(dev)
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


@contextlib.contextmanager
def process_group(on: bool, device="cuda", backend: str | None = None):
    """The entries' ``--distributed``: yields this rank's device
    (``init_distributed``) and leaves the process group at the end; with
    ``on`` false, yields ``device`` as it is."""
    if not on:
        yield device
        return
    dev = init_distributed(device, backend)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the world, 0 without a process group."""
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if distributed():
        dist.barrier()


# ------------------------------------------------------------------ meshes


def mesh_shape(n: int, n_data: int = 1, n_rays: int | None = None) -> tuple[int, int]:
    """The (data, rays) shape JAX's ``make_mesh`` gives ``n`` devices: all
    of them on ``rays`` unless ``n_rays`` is given."""
    return n_data, max(1, n // n_data) if n_rays is None else n_rays


def cv_mesh_shape(n: int, k_best: int = 4, batch: int = 1) -> tuple[int, int]:
    """The (cv, rays) shape of JAX's ``make_cv_mesh``: ``cv`` is the largest
    divisor of ``batch * k_best`` that divides ``n``, the rest go to
    ``rays``."""
    bk = batch * k_best
    cv = next(d for d in range(min(n, bk), 0, -1) if n % d == 0 and bk % d == 0)
    return cv, n // cv


def _device_mesh(shape: tuple[int, int], names: tuple[str, str]):
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {shape[0] * shape[1]} ranks; "
                         f"the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_mesh(n_data: int = 1, n_rays: int | None = None):
    """The world as a (data, rays) ``DeviceMesh`` (``mesh_shape``; its size
    must be the world's)."""
    return _device_mesh(mesh_shape(world_size(), n_data, n_rays), MESH_AXES)


def make_cv_mesh(n: int | None = None, k_best: int = 4, batch: int = 1):
    """The world as a (cv, rays) ``DeviceMesh`` (``cv_mesh_shape`` of ``n``
    ranks, by default the world's)."""
    return _device_mesh(cv_mesh_shape(n or world_size(), k_best, batch), CV_AXES)


def axis(mesh, name: str) -> tuple[int, int, object]:
    """(size, this rank's index, process group) of a mesh axis; (1, 0,
    None) when the mesh has no such axis."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1, 0, None
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


# --------------------------------------------------------------- the batch


def batch_pspecs(keys) -> dict:
    """The mesh axes each batch key splits over, per dimension (JAX's
    rules): ray-indexed keys (``ray_idx_*``, ``rgb_*``, ``msk_*``, shape
    (B, N, ...)) over (data, rays), ``combos`` over none (replicated),
    every other key over data."""
    out = {}
    for k in keys:
        if k.startswith(("ray_idx_", "rgb_", "msk_")):
            out[k] = ("data", "rays")
        elif k == "combos":
            out[k] = ()
        else:
            out[k] = ("data",)
    return out


def _split(x, dim: int, n: int, i: int):
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split into {n} equal shards")
    s = size // n
    return x[(slice(None),) * dim + (slice(i * s, (i + 1) * s),)]


def shard_batch(mesh, batch: dict, axes=MESH_AXES) -> dict:
    """This rank's slice of a batch (numpy arrays or tensors) under
    ``batch_pspecs``: each split dimension in equal shards, this rank's
    index along the axis. ``axes`` names the mesh axes to split over: a
    process's loader share already holds its ``data`` entries, so the
    training and eval entries split ``("rays",)`` only."""
    specs = batch_pspecs(batch.keys())
    out = {}
    for k, v in batch.items():
        for dim, name in enumerate(specs[k]):
            if name in axes:
                n, i, _ = axis(mesh, name)
                v = _split(v, dim, n, i)
        out[k] = v
    return out


def per_ray(key: str) -> bool:
    """Whether a render output holds one entry per ray (B, N, ...): every
    key but the levels' image-wide ``depth_mvs_level*`` and ``std_level*``."""
    return not key.startswith(("depth_mvs_level", "std_level"))


def gather_rays(mesh, out: dict, axes=MESH_AXES) -> dict:
    """The inverse of ``shard_batch`` for render outputs: per-ray outputs
    gathered over ``rays`` along dimension 1, then every output over
    ``data`` along dimension 0 (for the axes of ``axes``)."""
    n_rays, _, rays = axis(mesh, "rays")
    n_data, _, data = axis(mesh, "data")
    res = {}
    for k, v in out.items():
        if n_rays > 1 and "rays" in axes and per_ray(k):
            v = all_gather(v, rays, dim=1)
        if n_data > 1 and "data" in axes:
            v = all_gather(v, data, dim=0)
        res[k] = v
    return res


# ------------------------------------------------------------- collectives


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; the backward sums the upstream gradients
    over the ranks, as the gradient of the ranks' summed losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``'s ranks."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable concatenation of every rank's ``x`` (equal shapes)
    along ``dim``, in rank order: each rank writes its ``x`` into a zeroed
    buffer of the group's size, and the buffers are summed
    (``all_reduce_sum``). gloo has no all-gather of CUDA tensors; its
    all-reduce takes them."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x
    buf = torch.stack([x if j == i else torch.zeros_like(x) for j in range(n)])
    return torch.cat(all_reduce_sum(buf, group).unbind(0), dim=dim)


def average_gradients(params, group=None) -> None:
    """Replace each gradient by its mean over ``group``'s ranks, in one
    flat all-reduce per dtype (parameters without a gradient are left out;
    every rank must have the same set)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def broadcast_state(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Copy rank ``src``'s parameters and floating-point buffers to every
    rank (what ``DistributedDataParallel`` does at construction)."""
    with torch.no_grad():
        for t in module.state_dict().values():
            if t.is_floating_point():
                dist.broadcast(t, src, group=group)


def state_digest(module: torch.nn.Module) -> str:
    """SHA-256 of every parameter's and buffer's bytes, in ``state_dict``
    order."""
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def assert_replicated(module: torch.nn.Module, group=None) -> None:
    """Raise unless every rank holds rank 0's parameters and buffers, bit
    for bit (their digests, gathered as objects)."""
    digests = [None] * dist.get_world_size(group)
    dist.all_gather_object(digests, state_digest(module), group=group)
    differ = [r for r, d in enumerate(digests) if d != digests[0]]
    if differ:
        raise RuntimeError(f"the model's state on ranks {differ} differs from rank 0's")


def sync_batchnorm(model: torch.nn.Module, group) -> torch.nn.Module:
    """Set ``group`` on every BatchNorm of ``model`` (``models/blocks``):
    in train mode they normalise with the statistics of the group's whole
    batch and update their running statistics from them (flax's biased
    variance). ``None`` restores per-rank statistics."""
    from boostmvsnerfs_torch.models.blocks import _FlaxStats

    for m in model.modules():
        if isinstance(m, _FlaxStats):
            m.sync_group = group
    return model

