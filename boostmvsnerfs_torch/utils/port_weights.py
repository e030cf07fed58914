"""JAX parameter trees -> the port's ``state_dict``.

The inverses of ``boostmvsnerfs_tpu/utils/port_weights.py::port_enerf`` and
``port_mvsnerf``, with their own copies of the name maps: the port's
modules carry the reference checkpoints' names, so a reference
``state_dict`` goes into JAX through ``port_enerf`` / ``port_mvsnerf`` and a
JAX ``{'params', 'batch_stats'}`` tree comes back here for
``load_state_dict(strict=True)``. ``random_state_dict`` makes seeded
weights in that form for smoke runs and tests. Layout conversions:

* flax Conv (kh,kw,I,O) / (kd,kh,kw,I,O) -> torch (O,I,kh,kw) / (O,I,kd,kh,kw)
* flax ConvTranspose, transpose_kernel (kd,kh,kw,O,I) -> torch (I,O,kd,kh,kw)
* flax Dense (I,O) -> torch Linear (O,I)
* BatchNorm scale/bias (params), mean/var (batch_stats) -> weight/bias,
  running_mean/running_var (and a zero ``num_batches_tracked``)
"""

from __future__ import annotations

import numpy as np
import torch

_FPN_CBRS = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv2.0", "conv2.1")
_FPN_CONVS = ("toplayer", "lat1", "lat0", "smooth1", "smooth0")
_HEAD_DENSES = (
    ("agg.view_fc.0", ("agg", "view_fc")),
    ("agg.global_fc.0", ("agg", "global_fc")),
    ("agg.agg_w_fc.0", ("agg", "agg_w_fc")),
    ("agg.fc.0", ("agg", "fc")),
    ("lr0.0", ("lr0",)),
    ("sigma.0", ("sigma",)),
    ("color.0", ("color0",)),
    ("color.2", ("color1",)),
)


def _get(tree: dict, path) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _conv(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(4, 3, 0, 1, 2)


def _bn(sd, prefix, params, stats, path):
    sd[f"{prefix}.weight"] = _get(params, path + ("scale",))
    sd[f"{prefix}.bias"] = _get(params, path + ("bias",))
    sd[f"{prefix}.running_mean"] = _get(stats, path + ("mean",))
    sd[f"{prefix}.running_var"] = _get(stats, path + ("var",))
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def enerf_state_dict_from_jax(variables: dict) -> dict:
    """A JAX ENeRF/BoostENeRF ``{'params', 'batch_stats'}`` tree (numpy or
    jax arrays) -> the port's ``state_dict`` (CPU tensors). The number of
    cascade levels and the view-direction conditioning are read from the
    tree."""
    params, stats = variables["params"], variables["batch_stats"]
    num_levels = sum(k.startswith("cost_regs_") for k in params)
    viewdir_agg = "view_fc" in params["nerf_heads_0"]["agg"]
    sd: dict = {}
    for i, t in enumerate(_FPN_CBRS):
        path = ("feature_net", f"ConvBnReLU_{i}")
        sd[f"feature_net.{t}.conv.weight"] = _conv(_get(params, path + ("Conv_0", "kernel")))
        _bn(sd, f"feature_net.{t}.bn", params, stats, path + ("BatchNorm_0",))
    for name in _FPN_CONVS:
        sd[f"feature_net.{name}.weight"] = _conv(_get(params, ("feature_net", name, "kernel")))
        sd[f"feature_net.{name}.bias"] = _get(params, ("feature_net", name, "bias"))
    for lvl in range(num_levels):
        base, jax_name = f"cost_reg_{lvl}", f"cost_regs_{lvl}"
        n_cbr, deconvs = (5, ("conv9", "conv11")) if lvl == 0 else (7, ("conv7", "conv9", "conv11"))
        for j in range(n_cbr):
            path = (jax_name, f"ConvBnReLU_{j}")
            sd[f"{base}.conv{j}.conv.weight"] = _conv(_get(params, path + ("Conv_0", "kernel")))
            _bn(sd, f"{base}.conv{j}.bn", params, stats, path + ("BatchNorm_0",))
        for j, t in enumerate(deconvs):
            path = (jax_name, f"DeconvBn_{j}")
            # (kd,kh,kw,O,I) -> (I,O,kd,kh,kw)
            sd[f"{base}.{t}.0.weight"] = _get(
                params, path + ("ConvTranspose_0", "kernel")).transpose(4, 3, 0, 1, 2)
            _bn(sd, f"{base}.{t}.1", params, stats, path + ("BatchNorm_0",))
        for head in ("feat_conv", "depth_conv"):
            sd[f"{base}.{head}.0.weight"] = _conv(_get(params, (jax_name, head, "kernel")))
        for t, path in _HEAD_DENSES:
            if t.startswith("agg.view_fc") and not viewdir_agg:
                continue
            path = (f"nerf_heads_{lvl}",) + path
            sd[f"nerf_{lvl}.{t}.weight"] = _get(params, path + ("kernel",)).T
            sd[f"nerf_{lvl}.{t}.bias"] = _get(params, path + ("bias",))
    return {k: torch.tensor(v) for k, v in sd.items()}


_MVS_FEATURE_BLOCKS = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
                       "conv2.0", "conv2.1", "conv2.2")
_MVS_HEADS = (("pts_bias", "pts_bias"), ("alpha_linear", "alpha"),
              ("feature_linear", "feature"), ("views_linears.0", "views_0"), ("rgb_linear", "rgb"))


def mvsnerf_state_dict_from_jax(variables: dict) -> dict:
    """A JAX MVSNeRF/BoostMVSNeRF (``v0`` renderer) ``{'params',
    'batch_stats'}`` tree -> the port's ``state_dict`` (CPU tensors); the
    inverse of ``boostmvsnerfs_tpu/utils/port_weights.py::port_mvsnerf``.
    The MLP depth is read from the tree."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i, t in enumerate(_MVS_FEATURE_BLOCKS):
        path = ("feature", f"ConvBnLeaky_{i}")
        sd[f"feature.{t}.conv.weight"] = _conv(_get(params, path + ("Conv_0", "kernel")))
        _bn(sd, f"feature.{t}.bn", params, stats, path + ("BatchNorm_0",))
    sd["feature.toplayer.weight"] = _conv(_get(params, ("feature", "toplayer", "kernel")))
    sd["feature.toplayer.bias"] = _get(params, ("feature", "toplayer", "bias"))
    for i in range(7):
        path = ("cost_reg", f"ConvBnLeaky_{i}")
        sd[f"cost_reg_2.conv{i}.conv.weight"] = _conv(_get(params, path + ("Conv_0", "kernel")))
        _bn(sd, f"cost_reg_2.conv{i}.bn", params, stats, path + ("BatchNorm_0",))
    for i, t in enumerate(("conv7", "conv9", "conv11")):
        path = ("cost_reg", f"DeconvBnLeaky_{i}")
        # (kd,kh,kw,O,I) -> (I,O,kd,kh,kw)
        sd[f"cost_reg_2.{t}.0.weight"] = _get(
            params, path + ("ConvTranspose_0", "kernel")).transpose(4, 3, 0, 1, 2)
        _bn(sd, f"cost_reg_2.{t}.1", params, stats, path + ("BatchNorm_0",))
    mlp = params["renderer"]
    depth = sum(k.startswith("pts_") and k != "pts_bias" for k in mlp)
    for t, name in _MVS_HEADS + tuple((f"pts_linears.{i}", f"pts_{i}") for i in range(depth)):
        sd[f"nerf.nerf.{t}.weight"] = np.asarray(mlp[name]["kernel"]).T
        sd[f"nerf.nerf.{t}.bias"] = np.asarray(mlp[name]["bias"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def random_state_dict(module: torch.nn.Module, seed: int, prefix: str = "") -> dict:
    """Seeded numpy weights for every entry of ``module.state_dict()``, keys
    prefixed by ``prefix``: conv/linear weights N(0, 1/fan_in), biases
    N(0, 0.1), BatchNorm scale and running_var U(0.5, 1.5), running_mean
    N(0, 0.1), ``num_batches_tracked`` 0."""
    rng = np.random.default_rng(seed)
    ref = module.state_dict()
    sd = {}
    for k, v in ref.items():
        shape, stem = tuple(v.shape), k.rsplit(".", 1)[0]
        if k.endswith("num_batches_tracked"):
            sd[prefix + k] = np.zeros((), np.int64)
            continue
        if k.endswith("running_var") or (k.endswith(".weight") and f"{stem}.running_var" in ref):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", ".bias")):
            a = rng.normal(0.0, 0.1, shape)
        else:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        sd[prefix + k] = a.astype(np.float32)
    return sd
