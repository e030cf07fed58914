"""The ENeRF variants and the modules they bring, against the JAX package.

``CompositeENeRF`` (1 and 2 foreground layers) and ``HumanENeRF`` (with and
without ``mask_at_box``) at 64x64, 3 views on the forward rig, planes
(16, 8), samples (4, 2), both levels rendered, foreground crops 32x32
(JAX tests/test_variants.py's geometry); the image-feature-only head
(``use_vox_feat=False``) against flax and the Pallas kernel in interpret
mode; ``resize_trilinear``, ``CostRegNet(interp_upsample=True)`` and
``ResUNet`` against flax; the weight port of every new tree; the random-ray
and patch HumanENeRF step. Weights: ``random_state_dict`` of the port's
module, carried into JAX by the port's weight port. JAX takes its exact
paths (gather warp and sampling, XLA head, float32 warp).

Bars: forwards rtol 1e-4 / atol 1e-5 (float32 on both sides, sums in
other orders); ``composite_outputs`` 1e-6; the composite's gradients in
float64 at relative L2 1e-3 per tensor (tests/test_torch_train.py's bar
and float64 set-up: JAX's float32 linspace values and the float32 outputs
of its FPN and U-Nets); the bf16 head at the card check's bar (1e-2 of
the output's magnitude); the step's loss at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch.data.base import sample_train_pixels
from boostmvsnerfs_torch.models.cost_reg_net import CostRegNet, MinCostRegNet
from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
from boostmvsnerfs_torch.models.feature_net import FeatureNet, ResUNet
from boostmvsnerfs_torch.models.nerf_head import NeRFHead
from boostmvsnerfs_torch.models.variants import CompositeENeRF, HumanENeRF, composite_outputs
from boostmvsnerfs_torch.ops import sampling
from boostmvsnerfs_torch.ops.cuda.enerf_head import nerf_head_plain, pack_head_weights
from boostmvsnerfs_torch.parallel.train import create_train_state, make_train_step
from boostmvsnerfs_torch.train.schedule import make_optimizer
from boostmvsnerfs_torch.utils import port_weights as pw
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch
from boostmvsnerfs_tpu.data.base import sample_train_pixels as jax_sample_train_pixels
from boostmvsnerfs_tpu.models import cost_reg_net as jcr
from boostmvsnerfs_tpu.models import feature_net as jfn
from boostmvsnerfs_tpu.models import variants as jv
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from boostmvsnerfs_tpu.models.nerf_head import NeRFHead as FlaxHead
from boostmvsnerfs_tpu.ops.sampling import resize_trilinear as jax_resize_trilinear
from boostmvsnerfs_tpu.train.loss import enerf_loss as jax_enerf_loss

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SLICE = dict(volume_planes=(16, 8), num_samples=(4, 2), render_if=(True, True))
JAX_EXACT = dict(warp_mode="gather", eval_sampling="gather", eval_head="xla",
                 warp_dtype="float32")
HW, FG_HW = (64, 64), (32, 32)
# crop origins (x, y), multiples of 8: the second layer's x crosses the
# frame's right edge, so its scatter clamps (at both render scales)
BBOX = {1: [[8, 8]], 2: [[8, 8], [40, 24]]}
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this module (as
    tests/test_torch_train_entry.py: test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch(batch: dict, dtype=jnp.float32) -> dict:
    return {k: jnp.asarray(v, dtype if np.issubdtype(np.asarray(v).dtype, np.floating) else None)
            for k, v in batch.items()}


def _composite_batch(L: int) -> dict:
    b = make_scene_batch(B=1, n_views=3, H=HW[0], W=HW[1], seed=3, rig="forward")
    nf = b["near_far"]  # (1, 2); foreground bands inside the background's range
    b["near_far"] = np.stack([nf * np.array([1.2, 0.8])] * L + [nf], 1).astype(np.float32)
    b["bbox"] = np.asarray(BBOX[L], np.int32)[None]
    return b


def _human_batch(masked: bool) -> dict:
    b = make_scene_batch(B=1, n_views=3, H=HW[0], W=HW[1], seed=5, rig="forward")
    if masked:
        mask = np.zeros((1, *HW), np.float32)
        mask[:, 8:40, 10:50] = 1.0
        b["mask_at_box"] = mask
    return b


def _models(kind: str, seed: int = 0, **cas_kw):
    """(port model on the CPU with seeded weights, JAX model, JAX variables)."""
    cas = CascadeConfig(**{**SLICE, **cas_kw})
    jcas = JaxCascadeConfig(**JAX_EXACT, **{**SLICE, **cas_kw})
    if kind == "human":
        model, jmodel = HumanENeRF(cas, device="cpu"), jv.HumanENeRF(cas=jcas)
    else:
        L = int(kind[-1])
        model = CompositeENeRF(cas, num_fg_layers=L, fg_hw=FG_HW, device="cpu")
        jmodel = jv.CompositeENeRF(cas=jcas, num_fg_layers=L, fg_hw=FG_HW)
    sd = {k: torch.from_numpy(v) for k, v in pw.random_state_dict(model, seed).items()}
    model.load_state_dict(sd, strict=True)
    return model, jmodel, pw.enerf_variables_from_state_dict(sd)


@pytest.fixture(scope="module")
def renders():
    """{case: (port outputs, JAX outputs)} of the four forwards. JAX runs
    each model in one jit: compiling the model takes most of this file's
    time, and the human forwards with and without the mask share theirs."""
    np_out = lambda o: {k: np.asarray(v) for k, v in o.items()}  # noqa: E731
    out = {}
    for L in (1, 2):
        model, jmodel, variables = _models(f"composite_{L}")
        batch = _composite_batch(L)
        want = jax.jit(lambda v, b, m=jmodel: m.apply(v, b, False))(variables, _jax_batch(batch))
        out[f"composite_{L}"] = np_out(model(batch)), np_out(want)
    model, jmodel, variables = _models("human")
    batches = [_human_batch(False), _human_batch(True)]
    wants = jax.jit(lambda v, bs: [jmodel.apply(v, b, False) for b in bs])(
        variables, [_jax_batch(b) for b in batches])
    for case, batch, want in zip(("human", "human_masked"), batches, wants):
        out[case] = np_out(model(batch)), np_out(want)
    return out


@pytest.mark.parametrize("case", ["composite_1", "composite_2", "human", "human_masked"])
def test_variant_forward_matches_jax(renders, case):
    got, want = renders[case]
    assert got.keys() == want.keys()
    assert {"rgb_level0", "rgb_level1", "depth_level0", "depth_level1"} <= got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_human_mask_zeroes_the_last_level_only(renders):
    plain, masked = renders["human"][0], renders["human_masked"][0]
    mask = _human_batch(True)["mask_at_box"].reshape(1, -1, 1)
    np.testing.assert_array_equal(masked["rgb_level1"], plain["rgb_level1"] * mask)
    np.testing.assert_array_equal(masked["rgb_level0"], plain["rgb_level0"])
    assert np.abs(plain["rgb_level1"][mask[..., 0] == 0]).max() > 0


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_outputs_match_jax(white_bkgd):
    """Two layers whose depths interleave (each sample's z drawn from one
    range), an origin that clamps at the frame edge, and the background."""
    rng = np.random.default_rng(4)
    B, (h, w), (H, W), Ns = 2, (4, 6), (8, 12), 3
    fg = [{"net_output": rng.uniform(0, 2, (B, h * w, Ns, 4)).astype(np.float32),
           "z_vals": np.sort(rng.uniform(2, 4, (B, h * w, Ns)), -1).astype(np.float32)}
          for _ in range(2)]
    bg = {"net_output": rng.uniform(0, 1, (B, H * W, 5, 4)).astype(np.float32),
          "z_vals": np.sort(rng.uniform(4, 6, (B, H * W, 5)), -1).astype(np.float32)}
    origins = np.array([[[2, 1], [9, 3]], [[0, 6], [5, 0]]], np.int32)  # x 9 and y 6 clamp
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    got = composite_outputs([t(f) for f in fg], t(bg), torch.from_numpy(origins).long(), (h, w),
                            (H, W), white_bkgd)
    want = jv.composite_outputs([j(f) for f in fg], j(bg), jnp.asarray(origins), (h, w), (H, W),
                                white_bkgd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------ the composite's gradients


def _jax_float32_linspace(start, stop, num, device=None, dtype=torch.float32):
    """``jnp.linspace``'s float32 values, which the JAX model uses in float64
    mode too (as tests/test_torch_train.py)."""
    if dtype != torch.float32:
        return _port_linspace(start, stop, num, device, dtype)
    with jax.enable_x64(True):
        return torch.from_numpy(np.array(jnp.linspace(start, stop, num, dtype=jnp.float32)))


_port_linspace = sampling.linspace


def _round_outputs_like_jax(model):
    """The JAX FPN and U-Nets cast their outputs (and so the cotangents
    coming back) to float32 in float64 mode too: the port's float64 ones
    do the same."""
    def f32(out):
        if isinstance(out, dict):
            return {k: f32(v) for k, v in out.items()}
        if isinstance(out, tuple):
            return tuple(f32(v) for v in out)
        return out.float().double()

    for m in model.modules():
        if isinstance(m, (FeatureNet, CostRegNet, MinCostRegNet)):
            m.register_forward_hook(lambda m, args, out: f32(out))


def _loss_targets(batch: dict) -> dict:
    rng = np.random.default_rng(9)
    return {f"rgb_{i}": rng.uniform(0, 1, (1, int(HW[0] * s) * int(HW[1] * s), 3))
            for i, s in enumerate(CascadeConfig().render_scale)}


def test_composite_gradients_match_jax_float64():
    """A float64 train-mode forward of the 1-layer composite rendering level
    1 (the eval cascade's ``render_if``; the float64 JAX gradient takes
    ~30 s to compile, twice that with both levels and two layers) and the
    mean squared error of its rgb against seeded targets: every
    parameter's gradient within 1e-3 (relative L2) of JAX's."""
    model, jmodel, variables = _models("composite_1", seed=1, render_if=(False, True))
    batch = _composite_batch(1)
    targets = {"rgb_1": _loss_targets(batch)["rgb_1"]}

    model.double().train()
    _round_outputs_like_jax(model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampling, "linspace", _jax_float32_linspace)
        out = model.render(to_tensors(batch, torch.device("cpu"), torch.float64))
    loss = sum(((out[f"rgb_level{k[-1]}"] - torch.from_numpy(t)) ** 2).mean()
               for k, t in targets.items())
    loss.backward()
    # the foreground heads read no voxel features: their volumes' feat_conv
    # gets no gradient (JAX's reads 0)
    got = {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()}

    # JAX's ``_scatter_full`` mixes its int32 crop origins with int64
    # zeros under x64 and fails in ``dynamic_update_slice``: give it int64
    scatter = jv._scatter_full
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "_scatter_full", lambda u, y0, x0, H, W: scatter(
            u, y0.astype(jnp.int64), x0.astype(jnp.int64), H, W))
        jb = _jax_batch(batch, jnp.float64)
        var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params):
            o = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, jb, True,
                             mutable=["batch_stats"])[0]
            return sum(jnp.mean((o[f"rgb_level{k[-1]}"] - t) ** 2) for k, t in targets.items())

        want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(var["params"])
        want = pw.enerf_state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, grads),
             "batch_stats": variables["batch_stats"]})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    top = max(np.linalg.norm(g) for g in got.values())
    errs = {k: np.linalg.norm(g - want[k].numpy()) / max(np.linalg.norm(want[k].numpy()),
                                                        1e-5 * top)
            for k, g in got.items()}
    assert max(errs.values()) <= 1e-3, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert all(np.abs(g).sum() > 0 for k, g in got.items()
               if k.startswith("fg_0.nerf_1.") or k.startswith("bg.nerf_1."))


# ------------------------------------------- the image-feature-only head


def _no_vox_heads(seed: int, feat_ch: int, viewdir_agg: bool = True):
    """(port head, flax head, flax variables) with the same seeded weights."""
    head = NeRFHead(feat_ch, viewdir_agg=viewdir_agg, use_vox_feat=False)
    sd = pw.random_state_dict(head, seed)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params: dict = {}
    for name, path in pw._HEAD_DENSES:
        if f"{name}.weight" in sd:
            pw._put(params, path + ("kernel",), sd[f"{name}.weight"].T)
            pw._put(params, path + ("bias",), sd[f"{name}.bias"])
    fhead = FlaxHead(feat_ch=feat_ch, viewdir_agg=viewdir_agg, use_vox_feat=False)
    return head, fhead, {"params": params}


def _head_inputs(seed, B=2, S=3, P=60, C=11):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, S, P, C)).astype(np.float32)
    feat[..., -3:] = rng.uniform(0, 1, (B, S, P, 3))  # RGB
    dirs = rng.standard_normal((B, S, P, 4)).astype(np.float32)
    return feat, dirs


def _flax_no_vox(fhead, variables, feat, dirs):
    ifrd = np.concatenate([feat, dirs], -1).transpose(0, 2, 1, 3)  # (B, P, S, C+4)
    vox = jnp.zeros((*ifrd.shape[:2], 8))  # ignored by the head
    return np.asarray(fhead.apply(variables, vox, jnp.asarray(ifrd)))


@pytest.mark.parametrize("feat_ch,viewdir_agg,S", [(11, True, 3), (35, True, 3), (11, False, 2),
                                                   (35, False, 4)])
def test_no_vox_head_plain_matches_flax(feat_ch, viewdir_agg, S):
    head, fhead, variables = _no_vox_heads(5, feat_ch, viewdir_agg)
    assert tuple(head.lr0[0].weight.shape) == (64, 16)
    assert tuple(head.color[0].weight.shape) == (64, 64 + 16 + feat_ch + 4)
    feat, dirs = _head_inputs(6, S=S, C=feat_ch)
    with torch.no_grad():
        got = head(None, *map(torch.from_numpy, (feat, dirs)))
    np.testing.assert_allclose(got.numpy(), _flax_no_vox(fhead, variables, feat, dirs),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("feat_ch", [11, 35])
def test_no_vox_head_plain_matches_pallas_interpret(feat_ch):
    head, fhead, variables = _no_vox_heads(7, feat_ch)
    B, S, R, T = 2, 3, 3, 40
    feat, dirs = _head_inputs(8, B=B, S=S, P=R * T, C=feat_ch)
    with torch.no_grad():
        got = nerf_head_plain(head.head_params(), None, *map(torch.from_numpy, (feat, dirs)))
    def rows(a):
        return jnp.asarray(np.moveaxis(a.reshape(*a.shape[:-2], R, T, a.shape[-1]), -1, -2))

    out = fhead.apply(variables, None, rows(feat), rows(dirs), interpret=True,
                      method=FlaxHead.fused)  # (B, R, 4, T)
    want = np.asarray(jnp.moveaxis(out, 2, 3).reshape(B, R * T, 4))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("feat_ch", [11, 35])
def test_no_vox_head_plain_bf16_matches_flax(feat_ch):
    """The kernel's contract (bf16 operands, f32 sums) against the flax head
    in f32, at tests/test_torch_kernels.py's HEAD_BF16_BAR."""
    head, fhead, variables = _no_vox_heads(5, feat_ch)
    feat, dirs = _head_inputs(6, C=feat_ch)
    with torch.no_grad():
        got = nerf_head_plain(head.head_params(), None, *map(torch.from_numpy, (feat, dirs)),
                              compute_dtype=torch.bfloat16).numpy()
    want = _flax_no_vox(fhead, variables, feat, dirs)
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * max(1.0, float(np.abs(want).max()))
    assert err.max() > 1e-5  # the operands were rounded


def test_no_vox_head_buffers_hold_each_layer_where_the_kernel_reads_it():
    """``pack_head_weights`` for the image-feature-only instance: lr0 over
    [agg 16] (one k16 step), color0's per-sample part over [x 64, agg 16]
    (80 wide), rows 8 elements longer (the kernel's Layout<C, _, false>)."""
    head, _, _ = _no_vox_heads(9, 11)
    p = {k: (w.detach(), b.detach()) for k, (w, b) in head.head_params().items()}
    mats, _ = pack_head_weights(p)
    C, CP, CV = 11, 16, 16
    shapes = [("view_fc", CP, 16), ("global_fc", 32, 3 * CP), ("fc", 16, 32), ("lr0", 64, 16),
              ("color0", 64, 80), ("color0_view", 64, CV)]
    assert mats.numel() == sum(r * (k + 8) for _, r, k in shapes)
    at, m = 0, {}
    for name, r, k in shapes:
        m[name] = mats[at:at + r * (k + 8)].reshape(r, k + 8).float()
        at += r * (k + 8)
    bf = lambda w: w.to(torch.bfloat16).float()  # noqa: E731
    kc = p["color0"][0]
    assert torch.equal(m["lr0"][:, :16], bf(p["lr0"][0])) and not m["lr0"][:, 16:].any()
    assert torch.equal(m["color0"][:, :80], bf(kc[:, :80])) and not m["color0"][:, 80:].any()
    assert torch.equal(m["color0_view"][:, :C + 4], bf(kc[:, 80:]))


def test_head_forward_takes_no_voxels_without_use_vox_feat():
    head, _, _ = _no_vox_heads(3, 11)
    feat, dirs = map(torch.from_numpy, _head_inputs(4))
    with torch.no_grad():
        a = head(torch.zeros(2, 60, 8), feat, dirs)
        b = head(torch.full((2, 60, 8), 100.0), feat, dirs)
    assert torch.equal(a, b)


# ---------------------------------------- resize, interp U-Net and ResUNet


def test_resize_trilinear_matches_jax():
    vol = np.random.default_rng(0).standard_normal((2, 4, 6, 5, 3)).astype(np.float32)
    got = sampling.resize_trilinear(torch.from_numpy(vol), 8, 12, 10).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize_trilinear(jnp.asarray(vol), 8, 12, 10)),
                               rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    ref = torch.nn.functional.interpolate(t, size=(8, 12, 10), mode="trilinear",
                                          align_corners=True).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-6)


def _flax_vs_port(fmodule, port, x_np, train: bool):
    """Outputs of the flax module and of the port's (weights: the port's
    seeded ones through the weight port ``to_jax``), in eval or train mode
    (batch statistics; the updated running statistics compared too)."""
    to_jax, from_jax = {CostRegNet: (pw.cost_reg_variables_from_state_dict,
                                     pw.cost_reg_state_dict_from_jax),
                        ResUNet: (pw.res_unet_variables_from_state_dict,
                                  pw.res_unet_state_dict_from_jax)}[type(port)]
    sd = {k: torch.from_numpy(v) for k, v in pw.random_state_dict(port, 2).items()}
    port.load_state_dict(sd, strict=True)
    variables = to_jax(sd)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x_np))
    if train:
        want, upd = fmodule.apply(variables, jnp.asarray(x_np), True, mutable=["batch_stats"])
        new = from_jax({"params": variables["params"], "batch_stats": upd["batch_stats"]})
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    else:
        want = fmodule.apply(variables, jnp.asarray(x_np), False)
    return got, want


@pytest.mark.parametrize("train", [False, True])
def test_interp_upsample_cost_reg_matches_flax(train):
    x = np.random.default_rng(1).standard_normal((1, 8, 16, 16, 8)).astype(np.float32)
    (feat, depth), (wf, wd) = _flax_vs_port(jcr.CostRegNet(interp_upsample=True),
                                            CostRegNet(8, interp_upsample=True), x, train)
    assert feat.shape == (1, 8, 16, 16, 8) and depth.shape == (1, 8, 16, 16)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_res_unet_matches_flax(train):
    x = np.random.default_rng(2).standard_normal((2, 32, 48, 3)).astype(np.float32)
    got, want = _flax_vs_port(jfn.ResUNet(), ResUNet(), x, train)
    assert got.keys() == want.keys() == {"level_0"}
    assert got["level_0"].shape == (2, 8, 12, 32)
    np.testing.assert_allclose(got["level_0"].numpy(), np.asarray(want["level_0"]), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------- the weight port


def _jax_shapes(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _weight_cases():
    cas = CascadeConfig(**SLICE)
    jcas = JaxCascadeConfig(**JAX_EXACT, **SLICE)
    batch = _jax_batch(_composite_batch(2))
    vol = jnp.zeros((1, 8, 16, 16, 8))
    return {
        "composite_2": (CompositeENeRF(cas, num_fg_layers=2, fg_hw=FG_HW, device="cpu"),
                        jv.CompositeENeRF(cas=jcas, num_fg_layers=2, fg_hw=FG_HW), batch,
                        pw.enerf_variables_from_state_dict, pw.enerf_state_dict_from_jax),
        "human_min_cost_reg_all_no_vox": (
            HumanENeRF(dataclasses.replace(cas, min_cost_reg_all=True, use_vox_feat=False),
                       device="cpu"),
            jv.HumanENeRF(cas=dataclasses.replace(jcas, min_cost_reg_all=True,
                                                  use_vox_feat=False)),
            _jax_batch(_human_batch(False)), pw.enerf_variables_from_state_dict,
            pw.enerf_state_dict_from_jax),
        "cost_reg_interp": (CostRegNet(8, interp_upsample=True),
                            jcr.CostRegNet(interp_upsample=True), vol,
                            pw.cost_reg_variables_from_state_dict,
                            pw.cost_reg_state_dict_from_jax),
        "res_unet": (ResUNet(), jfn.ResUNet(), jnp.zeros((1, 32, 48, 3)),
                     pw.res_unet_variables_from_state_dict, pw.res_unet_state_dict_from_jax),
    }


@pytest.mark.parametrize("case", ["composite_2", "human_min_cost_reg_all_no_vox",
                                  "cost_reg_interp", "res_unet"])
def test_weight_port_round_trip(case):
    """port -> JAX gives exactly the tree flax creates (names and shapes,
    from ``jax.eval_shape`` of its init), and JAX -> port gives back every
    tensor."""
    port, jmodel, example, to_jax, from_jax = _weight_cases()[case]
    sd = {k: torch.from_numpy(v) for k, v in pw.random_state_dict(port, 3).items()}
    variables = to_jax(sd)
    init = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), example, False))
    assert _jax_shapes(variables) == _jax_shapes(dict(init))
    back = from_jax(variables)
    assert back.keys() == port.state_dict().keys()
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    port.load_state_dict(back, strict=True)


def test_composite_foreground_layers_share_one_feature_net():
    model = CompositeENeRF(CascadeConfig(**SLICE), num_fg_layers=3, fg_hw=FG_HW, device="cpu")
    names = {k.split(".")[0] + "." + k.split(".")[1] for k in model.state_dict()}
    assert {n for n in names if n.endswith(".feature_net")} == {"fg_0.feature_net",
                                                                 "bg.feature_net"}
    assert not model.fg(1).cas.use_vox_feat and model.bg.cas.use_vox_feat
    assert model.bg.cas.volume_planes == (16, 4)
    assert all(isinstance(getattr(model.fg(li), f"cost_reg_{i}"), MinCostRegNet)
               for li in range(3) for i in range(2))


# ------------------------------------------- random rays and patches, human


def test_human_random_ray_patch_step_matches_jax():
    """One HumanENeRF train step on random rays drawn on a mask plus
    patches (tests/test_variants.py's batch, 64x64): the pixels equal to
    JAX's ``sample_train_pixels``, and the port step's loss within 1e-4 of
    JAX's train-mode loss on the same batch and weights."""
    H, W = HW
    cas = dataclasses.replace(CascadeConfig(**SLICE), train_img=(False, False),
                              num_rays=(32, 64), num_patchs=(0, 2), patch_size=(-1, 4),
                              sample_on_mask=True)
    batch = _human_batch(False)
    msk = np.zeros((H, W), bool)
    msk[8:40, 10:50] = True
    for i, scale in enumerate((0.25, 1.0)):
        H_r, W_r, step = int(H * scale), int(W * scale), int(1 / scale)
        args = (H_r, W_r, cas.num_rays[i], msk[::step, ::step][:H_r, :W_r])
        kw = dict(sample_on_mask=True, num_patchs=cas.num_patchs[i], patch_size=cas.patch_size[i])
        idx = sample_train_pixels(np.random.default_rng(11 + i), *args, **kw)
        np.testing.assert_array_equal(
            idx, jax_sample_train_pixels(np.random.default_rng(11 + i), *args, **kw))
        batch[f"ray_idx_{i}"] = idx[None]
        batch[f"rgb_{i}"] = np.random.default_rng(13).uniform(
            0, 1, (1, idx.shape[0], 3)).astype(np.float32)
    assert batch["ray_idx_1"].shape[1] == 64 + 2 * 16

    model = HumanENeRF(cas, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in pw.random_state_dict(model, 2).items()}
    model.load_state_dict(sd, strict=True)
    variables = pw.enerf_variables_from_state_dict(sd)
    state = create_train_state(model, make_optimizer({"lr": 1e-4, "optim": "adam", "eps": 1e-8},
                                                     500))
    stats = make_train_step(model)(state, batch)

    jmodel = jv.HumanENeRF(cas=JaxCascadeConfig(
        **JAX_EXACT, **SLICE, train_img=cas.train_img, num_rays=cas.num_rays,
        num_patchs=cas.num_patchs, patch_size=cas.patch_size, sample_on_mask=True))
    jb = _jax_batch(batch)
    out = jax.jit(lambda v, b: jmodel.apply(v, b, True, mutable=["batch_stats"])[0])(variables, jb)
    want, _ = jax_enerf_loss(out, jb, cas.loss_weight, cas.num, cas.render_if, None, None,
                             cas.train_img)
    np.testing.assert_allclose(float(stats["loss"]), float(want), rtol=1e-4)
    assert state.step == 1
