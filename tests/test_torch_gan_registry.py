"""The rest of the GAN tree's registry in the port against ssl_tpu's: the
five discriminators and two RRDB variants, the ten pixel and distribution
losses and the two GAN losses, and the Real-ESRGAN datasets, on identical
weights and inputs (fp32, CPU).

Tolerances: the archs within rtol 1e-5 and atol 1e-5 (outputs O(1), as
tests/test_torch_recipe_archs.py holds them), and the discriminators'
train-mode state after one call (batch-norm running statistics, spectral
norms' u and sigma) likewise; every loss's value within rtol 1e-6 and its
gradient within rtol 1e-6 of each element plus 1e-6 of the gradient's
largest element (elements that cancel to ~0 through a softmax keep only
float32's absolute error), SSIMLoss in float64 on both sides (its float32
gradient, 121-tap windows summed in other orders, reads 1.3e-6 of the
largest element off); the datasets' items equal, under one seed of the
global ``random`` and ``np.random``."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs import discriminator_arch as jd
from ssl_tpu.archs import rrdbnet_arch as jr
from ssl_tpu.data.extra_datasets import RealESRGANPairedDataset as JPaired
from ssl_tpu.data.realesrgan_dataset import RealESRGANDataset as JRealESRGANDataset
from ssl_tpu.losses import basic_loss as jbl
from ssl_tpu.losses import gan_loss as jgl
from ssl_tpu_torch.archs import discriminator_arch as td
from ssl_tpu_torch.archs import rrdbnet_arch as tr
from ssl_tpu_torch.data.extra_datasets import RealESRGANPairedDataset
from ssl_tpu_torch.data.realesrgan_dataset import RealESRGANDataset
from ssl_tpu_torch.losses import basic_loss as tbl
from ssl_tpu_torch.losses import gan_loss as tgl
from ssl_tpu_torch.utils.png import encode_png
from ssl_tpu_torch.utils.registry import build_loss, build_network
from ssl_tpu_torch.utils.weight_port import params_from_jax

RTOL = ATOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-6, 1e-9


def _close_grad(got, want, what="gradient"):
    want = np.asarray(want)
    _close(got, want, LOSS_RTOL, LOSS_RTOL * float(np.abs(want).max()), what)

# name: (JAX module, port module, (h, w), is a discriminator with train-mode state)
ARCHS = {
    "UNetDiscriminatorSNv1_odd": (jd.UNetDiscriminatorSNv1(num_feat=4),
                                  td.UNetDiscriminatorSNv1(num_feat=4), (13, 11), True),
    "UNetDiscriminatorSNv1_even": (jd.UNetDiscriminatorSNv1(num_feat=4, skip_connection=False),
                                   td.UNetDiscriminatorSNv1(num_feat=4, skip_connection=False),
                                   (12, 16), True),
    "MOD": (jd.MOD(num_feat=4, num_expert=3), td.MOD(num_feat=4, num_expert=3), (16, 12), True),
    "Discriminator_VGG_192": (jd.Discriminator_VGG_192(num_feat=2),
                              td.Discriminator_VGG_192(num_feat=2), (192, 192), True),
    "DiscriminatorSN_VGG_192": (jd.DiscriminatorSN_VGG_192(num_feat=2),
                                td.DiscriminatorSN_VGG_192(num_feat=2), (192, 192), True),
    "NLayerDiscriminator": (jd.NLayerDiscriminator(ndf=4), td.NLayerDiscriminator(ndf=4),
                            (32, 24), True),
    "RRDBPSNet": (jr.RRDBPSNet(num_feat=8, num_block=2, num_grow_ch=4),
                  tr.RRDBPSNet(num_feat=8, num_block=2, num_grow_ch=4), (6, 5), False),
    "RRDBPSNet_x3": (jr.RRDBPSNet(scale=3, num_feat=8, num_block=1, num_grow_ch=4),
                     tr.RRDBPSNet(scale=3, num_feat=8, num_block=1, num_grow_ch=4), (5, 7), False),
    "RRDBMeanNet": (jr.RRDBMeanNet(num_feat=8, num_block=2, num_grow_ch=4),
                    tr.RRDBMeanNet(num_feat=8, num_block=2, num_grow_ch=4), (6, 5), False),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _seeded_variables(jnet, x, seed):
    """Seeded variables in the JAX module's tree (its shapes from
    ``jax.eval_shape``, which skips flax's slow eager init): kernels from
    N(0, 1 / fan_in), biases N(0, 0.01), norm scales 1 + N(0, 0.01), batch
    statistics around (0, 1), spectral norms' u from N(0, 1) and sigma 1, the
    MOD's gating and transform weights from N(0, 1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def leaf(path, a):
        name, shape = str(path[-1].key), a.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = 1 + 0.2 * rng.rand(*shape)
        elif name.endswith("sigma"):
            v = np.ones(shape)
        else:                                              # u, w_gating1, cr_weight
            v = rng.randn(*shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_gan_arch_matches_jax(name):
    """Forward on weights carried by ``params_from_jax``; a discriminator in
    train mode, its updated statistics against the JAX call's mutated
    ``batch_stats``, then in eval mode on them."""
    jnet, net, (h, w), is_d = ARCHS[name]
    family = type(net).__name__
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.rand(2, h, w, 3).astype(np.float32)
    variables = _seeded_variables(jnet, x, sum(map(ord, name)) + 1)
    stats = variables.get("batch_stats")
    missing, unexpected = net.load_state_dict(params_from_jax(family, variables["params"], stats),
                                              strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    assert type(build_network({"type": family})).__name__ == family

    def nchw(v):
        v = np.asarray(v)
        return v.transpose(0, 3, 1, 2) if v.ndim == 4 else v
    if not is_d:
        net.eval()
        _close(net(_nchw(x)), nchw(jax.jit(jnet.apply)(variables, x)))
        return
    ref, new_vars = jax.jit(lambda v, a: jnet.apply(v, a, True, mutable=["batch_stats"]))(
        variables, x)
    net.train()
    out = net(_nchw(x))
    if name == "MOD":
        logits, routing, parts, ortho = out
        jlogits, jrouting, jparts, jortho = ref
        for a, b, what in ((logits, jlogits, "logits"), (routing, jrouting, "routing"),
                           (ortho, jortho, "ortho_weight"), *[(p, q, f"part {i}") for i, (p, q)
                                                              in enumerate(zip(parts, jparts))]):
            _close(a, b, what=what)
        assert len(parts) == len(jparts) == 3
    else:
        _close(out, nchw(ref))
    want = params_from_jax(family, variables["params"], _np(new_vars["batch_stats"]))
    got = net.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean", "running_var", ".u", ".sigma"))]
    assert stat_keys
    for k in stat_keys:
        _close(got[k], want[k], what=k)
    net.eval()
    jeval = jax.jit(lambda v, a: jnet.apply(v, a, False))(
        {**variables, "batch_stats": _np(new_vars["batch_stats"])}, x)
    got_eval = net(_nchw(x))
    if name == "MOD":
        got_eval, jeval = got_eval[0], jeval[0]
    _close(got_eval, nchw(jeval), what="eval")


# ---------------------------------------------------------------------- losses

def _images(seed, shape=(2, 6, 7, 3)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _rows(seed, shape=(4, 7)):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _probs(seed, shape=(4, 7)):
    rng = np.random.RandomState(seed)
    return (0.05 + 0.9 * rng.rand(*shape)).astype(np.float32), rng.rand(*shape).astype(np.float32)


# name: (loss options, kind of inputs); each is held at every reduction it takes
LOSSES = {
    **{f"MSELoss_{r}": ({"type": "MSELoss", "loss_weight": 0.7, "reduction": r}, "image")
       for r in ("none", "mean", "sum")},
    "MSELoss_weighted": ({"type": "MSELoss", "reduction": "mean"}, "image_weight"),
    **{f"CharbonnierLoss_{r}": ({"type": "CharbonnierLoss", "reduction": r, "eps": 1e-6},
                                "image") for r in ("none", "mean", "sum")},
    "CharbonnierLoss_weighted": ({"type": "CharbonnierLoss", "reduction": "sum"}, "image_weight"),
    **{f"WeightedTVLoss_{r}": ({"type": "WeightedTVLoss", "loss_weight": 0.5, "reduction": r},
                               "tv") for r in ("mean", "sum")},
    "WeightedTVLoss_weighted": ({"type": "WeightedTVLoss", "reduction": "mean"}, "tv_weight"),
    "CrossEntropyLoss": ({"type": "CrossEntropyLoss", "loss_weight": 0.3}, "logits"),
    "SSIMLoss": ({"type": "SSIMLoss", "loss_weight": 1.0}, "ssim"),
    "CosineDistanceLoss": ({"type": "CosineDistanceLoss", "loss_weight": 0.1}, "rows"),
    **{f"BCELoss_{r}": ({"type": "BCELoss", "reduction": r}, "probs")
       for r in ("none", "mean", "sum")},
    **{f"KLDistanceLoss1_{r}_{s}": ({"type": "KLDistanceLoss1", "reduction": r, "softmax": s},
                                    "rows" if s else "probs")
       for r in ("none", "mean", "sum") for s in (False, True)},
    **{f"MaxDistanceLoss_{r}": ({"type": "MaxDistanceLoss", "reduction": r}, "rows")
       for r in ("none", "mean")},
    **{f"SmoothL2Loss_{r}": ({"type": "SmoothL2Loss", "delta": 0.5, "reduction": r}, "rows")
       for r in ("none", "mean")},
}


def _loss_inputs(kind, seed):
    """(JAX args, port args, index of the argument the gradient is taken of)."""
    if kind in ("image", "image_weight", "ssim"):
        p, t = _images(seed, (2, 13, 12, 3) if kind == "ssim" else (2, 6, 7, 3))
        jargs, targs = [p, t], [_nchw(p), _nchw(t)]
        if kind == "image_weight":
            wgt = np.random.RandomState(seed + 1).rand(2, 6, 7, 1).astype(np.float32)
            jargs.append(wgt)
            targs.append(_nchw(wgt))
        return jargs, targs
    if kind in ("tv", "tv_weight"):
        p, _ = _images(seed)
        if kind == "tv":
            return [p], [_nchw(p)]
        wgt = np.random.RandomState(seed + 1).rand(2, 6, 7, 3).astype(np.float32)
        return [p, wgt], [_nchw(p), _nchw(wgt)]
    if kind == "logits":
        logits, _ = _rows(seed, (6, 5))
        labels = np.random.RandomState(seed).randint(0, 5, 6)
        return [logits, labels], [torch.from_numpy(logits), torch.from_numpy(labels)]
    x, y = _rows(seed) if kind == "rows" else _probs(seed)
    return [x, y], [torch.from_numpy(x), torch.from_numpy(y)]


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient_match_jax(name):
    opt, kind = LOSSES[name]
    kw = {k: v for k, v in opt.items() if k != "type"}
    jloss, tloss = getattr(jbl, opt["type"])(**kw), build_loss(opt)
    assert type(tloss) is getattr(tbl, opt["type"])
    jargs, targs = _loss_inputs(kind, sum(map(ord, name)))
    if kind == "ssim":
        jargs, targs = [a.astype(np.float64) for a in jargs], [t.double() for t in targs]
    with jax.enable_x64(kind == "ssim"):
        jargs = [jnp.asarray(a) for a in jargs]
        want, jgrad = jax.jit(lambda *a: (jloss(*a), jax.grad(
            lambda p: jnp.sum(jloss(p, *a[1:])))(a[0])))(*jargs)
        want, jgrad = np.asarray(want), np.asarray(jgrad)
    x = targs[0].clone().requires_grad_(True)
    got = tloss(x, *targs[1:])
    image_out = kind in ("image", "image_weight") and np.asarray(want).ndim == 4
    _close(got, np.asarray(want).transpose(0, 3, 1, 2) if image_out else want,
           LOSS_RTOL, LOSS_ATOL, "value")
    got.sum().backward()
    if jgrad.ndim == 4:
        jgrad = jgrad.transpose(0, 3, 1, 2)
    _close_grad(x.grad, jgrad)


GAN_CASES = [(t, real, disc, nested) for t in ("vanilla", "lsgan", "wgan_softplus", "hinge")
             for real in (True, False) for disc in (True, False) for nested in (False, True)]


@pytest.mark.parametrize("gan_type,real,disc,nested", GAN_CASES)
def test_multiscale_gan_loss_matches_jax(gan_type, real, disc, nested):
    """Over three scales (of a nested list, the last entry of each), value
    and the gradient of every scale's prediction."""
    rng = np.random.RandomState(len(gan_type) + 2 * real + disc)
    preds = [rng.randn(2, s, s, 1).astype(np.float32) for s in (8, 4, 2)]
    jl = jgl.MultiScaleGANLoss(gan_type, loss_weight=0.3)
    tl = build_loss({"type": "MultiScaleGANLoss", "gan_type": gan_type, "loss_weight": 0.3})
    assert isinstance(tl, tgl.MultiScaleGANLoss)
    xs = [_nchw(p).requires_grad_(True) for p in preds]

    def wrap(v, junk):
        return [[junk, u] for u in v] if nested else v
    got = tl(wrap(xs, torch.zeros(1)), real, disc)
    want, jgrads = jax.jit(jax.value_and_grad(lambda ps: jl(wrap(ps, jnp.zeros(1)), real, disc)))(
        [jnp.asarray(p) for p in preds])
    _close(got, want, LOSS_RTOL, LOSS_ATOL, "value")
    got.backward()
    for x, g in zip(xs, jgrads):
        _close_grad(x.grad, np.asarray(g).transpose(0, 3, 1, 2))
    single = tl(xs[0], real, disc)                     # a bare tensor: GANLoss itself
    _close(single, jl(jnp.asarray(preds[0]), real, disc), LOSS_RTOL, LOSS_ATOL, "single")


@pytest.mark.parametrize("criterion", ["l1", "l2", "charbonnier"])
def test_gan_feat_loss_matches_jax(criterion):
    """Two Ds of three features and logits; the gradient reaches the fake
    features only."""
    rng = np.random.RandomState(len(criterion))
    shapes = [(2, 8, 8, 4), (2, 4, 4, 8), (2, 2, 2, 8), (2, 2, 2, 1)]
    fake = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(2)]
    real = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(2)]
    jl = jgl.GANFeatLoss(criterion, loss_weight=2.0)
    tl = build_loss({"type": "GANFeatLoss", "criterion": criterion, "loss_weight": 2.0})
    tf = [[_nchw(a).requires_grad_(True) for a in d] for d in fake]
    tr_ = [[_nchw(a).requires_grad_(True) for a in d] for d in real]
    got = tl(tf, tr_)
    jf = [[jnp.asarray(a) for a in d] for d in fake]
    jr_ = [[jnp.asarray(a) for a in d] for d in real]
    want, jgrads = jax.jit(jax.value_and_grad(jl))(jf, jr_)
    _close(got, want, LOSS_RTOL, LOSS_ATOL, "value")
    got.backward()
    for d in range(2):
        for j in range(3):
            _close_grad(tf[d][j].grad, np.asarray(jgrads[d][j]).transpose(0, 3, 1, 2),
                        f"gradient {d} {j}")
        assert tf[d][3].grad is None or not tf[d][3].grad.any()
        assert all(t.grad is None for t in tr_[d])


# -------------------------------------------------------------------- datasets

def _write_png(path, rng, h, w):
    with open(path, "wb") as f:
        f.write(encode_png(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Three GT PNGs of 32 x 24 (and one of 40 x 36) with LQ at x4, and a
    meta_info file listing two of them in another order."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(0)
    for d in ("gt", "lq"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(32, 24), (32, 24), (40, 36)]):
        _write_png(root / "gt" / f"im{i}.png", rng, h, w)
        _write_png(root / "lq" / f"im{i}.png", rng, h // 4, w // 4)
    (root / "meta.txt").write_text("im2.png (40,36,3)\nim0.png (32,24,3)\n")
    return root


def _same_item(got, want, keys):
    for k in keys:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).transpose(2, 0, 1),
                                          err_msg=k)


@pytest.mark.parametrize("source,phase", [("meta_info", "train"), ("folders", "train"),
                                          ("folders", "val")])
def test_realesrgan_paired_dataset_matches_jax(pairs, source, phase):
    """Items under one seed: the same files, crops, flips and rotations."""
    opt = {"dataroot_gt": str(pairs / "gt"), "dataroot_lq": str(pairs / "lq"), "scale": 4,
           "gt_size": 16, "phase": phase, "use_hflip": True, "use_rot": True}
    if source == "meta_info":
        opt["meta_info"] = str(pairs / "meta.txt")
    jds, tds = JPaired(dict(opt)), RealESRGANPairedDataset(dict(opt))
    assert len(tds) == len(jds) == (2 if source == "meta_info" else 3)
    for seed in range(3):
        for i in range(len(tds)):
            random.seed(seed)
            want = jds[i]
            random.seed(seed)
            got = tds[i]
            _same_item(got, want, ("lq", "gt", "lq_path", "gt_path"))
            if phase == "train":
                assert tuple(got["gt"].shape) == (3, 16, 16)


def test_realesrgan_dataset_without_mask_matches_jax(pairs):
    """GT-only items (flips, rotations, the two-stage and sinc kernels) under
    one seed of both global streams."""
    opt = {"dataroot_gt": str(pairs / "gt"), "use_hflip": True, "use_rot": True,
           "sinc_prob": 0.3, "final_sinc_prob": 0.5}
    jds, tds = JRealESRGANDataset(dict(opt)), RealESRGANDataset(dict(opt))
    for seed in range(4):
        for i in range(len(tds)):
            random.seed(seed)
            np.random.seed(seed)
            want = jds[i]
            random.seed(seed)
            np.random.seed(seed)
            got = tds[i]
            _same_item(got, want, ("gt", "gt_path"))
            for k in ("kernel1", "kernel2", "sinc_kernel"):
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
