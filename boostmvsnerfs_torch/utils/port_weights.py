"""JAX parameter trees <-> the port's ``state_dict``.

The inverses of ``boostmvsnerfs_tpu/utils/port_weights.py::port_enerf`` and
``port_mvsnerf``, with their own copies of the name maps: the port's
modules carry the reference checkpoints' names, so a reference
``state_dict`` goes into JAX through ``port_enerf`` / ``port_mvsnerf`` and a
JAX ``{'params', 'batch_stats'}`` tree comes back here for
``load_state_dict(strict=True)``. Both carriers also run the other way
(``enerf_variables_from_state_dict``, ``mvsnerf_variables_from_state_dict``,
every MVSNeRF renderer head), so trained weights and BatchNorm statistics
move between the packages in both directions (optimizer moments start at
zero in both). ``random_state_dict`` makes seeded
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


def _put(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _conv(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(4, 3, 0, 1, 2)


def _conv_back(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.transpose(2, 3, 4, 1, 0)


# layout of each kind of leaf: JAX -> torch, torch -> JAX
_LAYOUT = {
    "conv": (_conv, _conv_back),
    # flax ConvTranspose, transpose_kernel (kd,kh,kw,O,I) <-> torch (I,O,kd,kh,kw)
    "deconv": (lambda k: k.transpose(4, 3, 0, 1, 2), lambda w: w.transpose(2, 3, 4, 1, 0)),
    "dense": (lambda k: k.T, lambda w: w.T),
    "same": (lambda a: a, lambda a: a),
}


def _bn_leaves(prefix, path):
    return [(f"{prefix}.weight", "params", path + ("scale",), "same"),
            (f"{prefix}.bias", "params", path + ("bias",), "same"),
            (f"{prefix}.running_mean", "batch_stats", path + ("mean",), "same"),
            (f"{prefix}.running_var", "batch_stats", path + ("var",), "same")]


def _enerf_leaves(num_levels: int, viewdir_agg: bool) -> list:
    """Every leaf of an ENeRF/BoostENeRF: (torch key, JAX collection, JAX
    path, layout kind)."""
    out = []
    for i, t in enumerate(_FPN_CBRS):
        path = ("feature_net", f"ConvBnReLU_{i}")
        out.append((f"feature_net.{t}.conv.weight", "params", path + ("Conv_0", "kernel"), "conv"))
        out += _bn_leaves(f"feature_net.{t}.bn", path + ("BatchNorm_0",))
    for name in _FPN_CONVS:
        out.append((f"feature_net.{name}.weight", "params", ("feature_net", name, "kernel"), "conv"))
        out.append((f"feature_net.{name}.bias", "params", ("feature_net", name, "bias"), "same"))
    for lvl in range(num_levels):
        base, jax_name = f"cost_reg_{lvl}", f"cost_regs_{lvl}"
        n_cbr, deconvs = (5, ("conv9", "conv11")) if lvl == 0 else (7, ("conv7", "conv9", "conv11"))
        for j in range(n_cbr):
            path = (jax_name, f"ConvBnReLU_{j}")
            out.append((f"{base}.conv{j}.conv.weight", "params", path + ("Conv_0", "kernel"), "conv"))
            out += _bn_leaves(f"{base}.conv{j}.bn", path + ("BatchNorm_0",))
        for j, t in enumerate(deconvs):
            path = (jax_name, f"DeconvBn_{j}")
            out.append((f"{base}.{t}.0.weight", "params", path + ("ConvTranspose_0", "kernel"),
                        "deconv"))
            out += _bn_leaves(f"{base}.{t}.1", path + ("BatchNorm_0",))
        for head in ("feat_conv", "depth_conv"):
            out.append((f"{base}.{head}.0.weight", "params", (jax_name, head, "kernel"), "conv"))
        for t, path in _HEAD_DENSES:
            if t.startswith("agg.view_fc") and not viewdir_agg:
                continue
            path = (f"nerf_heads_{lvl}",) + path
            out.append((f"nerf_{lvl}.{t}.weight", "params", path + ("kernel",), "dense"))
            out.append((f"nerf_{lvl}.{t}.bias", "params", path + ("bias",), "same"))
    return out


def enerf_state_dict_from_jax(variables: dict) -> dict:
    """A JAX ENeRF/BoostENeRF ``{'params', 'batch_stats'}`` tree (numpy or
    jax arrays; a JAX ``TrainState``'s ``params`` and ``batch_stats`` after
    training steps as well) -> the port's ``state_dict`` (CPU tensors). The
    number of cascade levels and the view-direction conditioning are read
    from the tree."""
    params = variables["params"]
    num_levels = sum(k.startswith("cost_regs_") for k in params)
    viewdir_agg = "view_fc" in params["nerf_heads_0"]["agg"]
    sd = {}
    for key, col, path, kind in _enerf_leaves(num_levels, viewdir_agg):
        sd[key] = torch.tensor(_LAYOUT[kind][0](_get(variables[col], path)))
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


def enerf_variables_from_state_dict(state_dict: dict) -> dict:
    """The inverse of ``enerf_state_dict_from_jax``: the port's ENeRF /
    BoostENeRF ``state_dict`` (after training steps too) -> a JAX
    ``{'params', 'batch_stats'}`` tree of numpy arrays."""
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    num_levels = sum(k.startswith("cost_reg_") and k.endswith("conv0.conv.weight") for k in sd)
    viewdir_agg = "nerf_0.agg.view_fc.0.weight" in sd
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, col, path, kind in _enerf_leaves(num_levels, viewdir_agg):
        _put(tree[col], path, np.ascontiguousarray(_LAYOUT[kind][1](sd[key])))
    return tree


_MVS_FEATURE_BLOCKS = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
                       "conv2.0", "conv2.1", "conv2.2")
# each head kind's dense layers: (torch name under nerf.nerf, JAX name
# under renderer), and the attention block it holds, if any
_MVS_DENSES = {
    "mlp": (("pts_bias", "pts_bias"), ("alpha_linear", "alpha"), ("feature_linear", "feature"),
            ("views_linears.0", "views_0"), ("rgb_linear", "rgb")),
    "attention": (("pts_bias", "pts_bias"), ("alpha_linear", "alpha"),
                  ("feature_linear", "feature"), ("views_linears.0", "views_0"),
                  ("rgb_linear", "rgb"), ("weight_out", "weight_out")),
    "color_fusion": (("pts_bias", "pts_bias"), ("alpha_linear.0", "alpha"),
                     ("feature_linear.0", "feature"), ("rgb_out.0", "rgb_out")),
}
_MVS_ATTENTION = {"mlp": None, "attention": "color_attention", "color_fusion": "ray_attention"}


def _mvsnerf_leaves(depth: int, head: str) -> list:
    """Every leaf of an MVSNeRF/BoostMVSNeRF with a renderer head of kind
    ``head`` ('mlp' for v0 / v2, 'attention' for v1, 'color_fusion') and
    ``depth`` trunk layers: (torch key, JAX collection, JAX path, layout)."""
    out = []
    for i, t in enumerate(_MVS_FEATURE_BLOCKS):
        path = ("feature", f"ConvBnLeaky_{i}")
        out.append((f"feature.{t}.conv.weight", "params", path + ("Conv_0", "kernel"), "conv"))
        out += _bn_leaves(f"feature.{t}.bn", path + ("BatchNorm_0",))
    out.append(("feature.toplayer.weight", "params", ("feature", "toplayer", "kernel"), "conv"))
    out.append(("feature.toplayer.bias", "params", ("feature", "toplayer", "bias"), "same"))
    for i in range(7):
        path = ("cost_reg", f"ConvBnLeaky_{i}")
        out.append((f"cost_reg_2.conv{i}.conv.weight", "params", path + ("Conv_0", "kernel"),
                    "conv"))
        out += _bn_leaves(f"cost_reg_2.conv{i}.bn", path + ("BatchNorm_0",))
    for i, t in enumerate(("conv7", "conv9", "conv11")):
        path = ("cost_reg", f"DeconvBnLeaky_{i}")
        out.append((f"cost_reg_2.{t}.0.weight", "params", path + ("ConvTranspose_0", "kernel"),
                    "deconv"))
        out += _bn_leaves(f"cost_reg_2.{t}.1", path + ("BatchNorm_0",))
    denses = _MVS_DENSES[head] + tuple((f"pts_linears.{i}", f"pts_{i}") for i in range(depth))
    for t, name in denses:
        out.append((f"nerf.nerf.{t}.weight", "params", ("renderer", name, "kernel"), "dense"))
        out.append((f"nerf.nerf.{t}.bias", "params", ("renderer", name, "bias"), "same"))
    att = _MVS_ATTENTION[head]
    if att:
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            out.append((f"nerf.nerf.{att}.{name}.weight", "params",
                        ("renderer", att, name, "kernel"), "dense"))
        for t, leaf in (("weight", "scale"), ("bias", "bias")):
            out.append((f"nerf.nerf.{att}.layer_norm.{t}", "params",
                        ("renderer", att, "layer_norm", leaf), "same"))
    return out


def _mvs_head_kind(names) -> str:
    names = " ".join(names)
    return ("attention" if "color_attention" in names
            else "color_fusion" if "ray_attention" in names else "mlp")


def mvsnerf_state_dict_from_jax(variables: dict) -> dict:
    """A JAX MVSNeRF/BoostMVSNeRF ``{'params', 'batch_stats'}`` tree, any
    ``net_type`` -> the port's ``state_dict`` (CPU tensors); for ``v0``
    the inverse of ``boostmvsnerfs_tpu/utils/port_weights.py::
    port_mvsnerf``. The head and the MLP depth are read from the tree:
    ``color_attention`` marks the attention head (v1), ``ray_attention``
    the colour-fusion head; v0 and v2 share one tree. A LayerNorm's
    ``scale`` is the port's ``weight``.

    The reference's ``Renderer_attention`` ties ``pts_linears.1..D-1`` to
    one module, so its checkpoint holds one tensor under each of those
    names; JAX keeps separate ``pts_{i}`` and so does the port. Each name
    maps to its own layer here, so a reference checkpoint loads with the
    tied values, and training then moves the layers apart, as in JAX."""
    mlp = variables["params"]["renderer"]
    depth = sum(k.startswith("pts_") and k != "pts_bias" for k in mlp)
    sd = {}
    for key, col, path, kind in _mvsnerf_leaves(depth, _mvs_head_kind(mlp)):
        sd[key] = torch.tensor(_LAYOUT[kind][0](_get(variables[col], path)))
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


def mvsnerf_variables_from_state_dict(state_dict: dict) -> dict:
    """The inverse of ``mvsnerf_state_dict_from_jax``: the port's MVSNeRF /
    BoostMVSNeRF ``state_dict``, any ``net_type`` (after training steps
    too) -> a JAX ``{'params', 'batch_stats'}`` tree of numpy arrays."""
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    depth = sum(k.startswith("nerf.nerf.pts_linears.") and k.endswith(".weight") for k in sd)
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, col, path, kind in _mvsnerf_leaves(depth, _mvs_head_kind(sd)):
        _put(tree[col], path, np.ascontiguousarray(_LAYOUT[kind][1](sd[key])))
    return tree


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


def vgg_state_dict_from_jax(variables: dict) -> dict:
    """A JAX ``VGG16Features`` ``{'params': {'conv{i}': {'kernel', 'bias'}}}``
    tree -> the port's ``eval/vgg.py::VGG16Features`` state dict (CPU
    tensors)."""
    params = variables["params"]
    sd = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = torch.tensor(_conv(np.asarray(p["kernel"])))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(p["bias"]))
    return sd
