"""The port's strategy zoo (``losses/simself_strategies.py``) against
``ssl_tpu``'s on identical numpy inputs (CPU).

Every key of the reference's dispatch goes through ``similarity_map`` once,
and every key that ``simself_strategy_loss`` takes goes through ``ssl_loss``
(value and d_sr) at a capacity below the image's edge count; two keys also
in float32 with an empty-mask image in the batch.  Cases:
tests/torch_zoo_cases.py.

Tolerances.  Float64 on both sides (``jax.enable_x64``, the port in float64):
rtol 1e-9 with an atol of 1e-9 of the largest element, for the maps (a row
of tiny softmax weights, such as the 1e-176 of mask_trans's variance-scaled
logits, carries the absolute error of its logits) and for d_sr (the two
packages sum in other orders; float64 leaves ~1e-15 of that).  Float32: l1
rel 1e-4 and kl rel 1e-3, as tests/test_torch_losses.py holds the SSL loss,
and d_sr within a relative L2 of 1e-4 with an atol of 1e-6 of its largest
element.

JAX's masked families slice each tile with a literal 0 beside int32
positions (``lax.dynamic_slice``), which x64 mode turns into mixed index
types that JAX refuses; the fixture ``x64_slices`` casts the start indices
to the literal's type around those calls, which leaves every value as it
is."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torch_zoo_cases as Z
from ssl_tpu.losses import simself_strategies as J
from ssl_tpu_torch.losses import simself_strategies as T

jssl = importlib.import_module("ssl_tpu.losses.ssl_loss")
tssl = importlib.import_module("ssl_tpu_torch.losses.ssl_loss")

RTOL = 1e-9


@pytest.fixture(autouse=True)
def x64_slices(monkeypatch):
    orig = lax.dynamic_slice

    def dynamic_slice(operand, start_indices, slice_sizes):
        literal = jnp.asarray(0).dtype                 # int64 in x64 mode, else int32
        return orig(operand, tuple(jnp.asarray(i).astype(literal) for i in start_indices),
                    slice_sizes)
    monkeypatch.setattr(lax, "dynamic_slice", dynamic_slice)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(v):
    return None if v is None else np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("key", Z.KEYS)
def test_similarity_map_matches_jax(key):
    """s, s1, index and valid of one image, the masked families at a capacity
    of 40 rows an image (a tile in the ``_patch`` variants), above every
    count, so that the padding rows come in too (JAX under ``jit``)."""
    gt, sr, mask = Z.images(1, mask_channels=3 if key == Z.RGB else 1)
    kw = Z.map_kwargs(key)
    with jax.enable_x64():
        ref = jax.jit(lambda g, m, s: J.similarity_map(
            g, mask=m, img_sr=s, simself_strategy=key, capacity=40, **kw))(
                jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(sr))
        ref = [_np(v) for v in ref]
    got = [_np(v) for v in T.similarity_map(
        torch.from_numpy(gt), mask=torch.from_numpy(mask), img_sr=torch.from_numpy(sr),
        simself_strategy=key, capacity=40, **kw)]
    for name, a, b in zip(T.SimMap._fields, got, ref):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape, (name, a.shape, b.shape)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("capacity", [None, "below", "above"])
def test_masked_rows_at_a_capacity_match_jax(capacity):
    """A masked family with rows sized from the concrete mask (None), at an
    int capacity below the edge count (rows cut in row-major order) and above
    it (padding rows of pixel (0, 0), valid off); JAX under ``jit`` where
    the capacity is an int."""
    gt, _, mask = Z.images(2)
    count = int(mask.sum())
    cap = {None: None, "below": count - 3, "above": count + 5}[capacity]
    key = "areaarea_mask_nonlocal_cuda_v1"

    def ref_map(g, m):
        return J.similarity_map(g, mask=m, simself_strategy=key, capacity=cap,
                                **Z.map_kwargs(key))
    with jax.enable_x64():
        ref = (ref_map if cap is None else jax.jit(ref_map))(jnp.asarray(gt), jnp.asarray(mask))
    got = T.similarity_map(torch.from_numpy(gt), mask=torch.from_numpy(mask),
                           simself_strategy=key, capacity=cap, **Z.map_kwargs(key))
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(ref.s), rtol=RTOL, atol=0)


def test_dead_strategy_raises_in_both():
    gt, _, mask = Z.images(0)
    with pytest.raises(NotImplementedError):
        J.similarity_map(jnp.asarray(gt), mask=jnp.asarray(mask), simself_strategy=Z.DEAD)
    with pytest.raises(NotImplementedError, match="dead in the reference"):
        T.similarity_map(torch.from_numpy(gt), mask=torch.from_numpy(mask),
                         simself_strategy=Z.DEAD)


def _settings(key, **change):
    opts = dict(strategy=key, strategy_opts=Z.loss_opts(key), mask_stride=3, capacity=6,
                l1_weight=0.5, kl_weight=0.25)
    opts.update(change)
    return (jssl.SSLSetting(**opts), tssl.SSLSetting(**opts))


def _batch(dtype, b=1):
    """One image, or two with the second's mask empty (zero-weighted in both)."""
    gt, sr, mask = Z.images(3, b=b, density=0.5)
    mask[1:] = 0.0
    return gt.astype(dtype), sr.astype(dtype), mask.astype(dtype)


def _both_losses(key, dtype, b=1, **change):
    """(l1, kl, d_sr of l1 + kl) from both packages' ``ssl_loss``."""
    gt, sr, mask = _batch(dtype, b)
    js, ts = _settings(key, **change)

    def f(s):
        l1, kl = jssl.ssl_loss(s, jnp.asarray(gt.transpose(0, 2, 3, 1)),
                               jnp.asarray(mask.transpose(0, 2, 3, 1)), js)
        return l1 + kl, (l1, kl)
    with jax.enable_x64(dtype == np.float64):
        (_, (l1, kl)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(sr.transpose(0, 2, 3, 1)))
        ref = float(l1), float(kl), np.asarray(g).transpose(0, 3, 1, 2)
    x = torch.from_numpy(sr).requires_grad_(True)
    t1, tk = tssl.ssl_loss(x, torch.from_numpy(gt), torch.from_numpy(mask), ts)
    (t1 + tk).backward()
    return (t1.item(), tk.item(), x.grad.numpy()), ref


@pytest.mark.parametrize("key", Z.LOSS_KEYS)
def test_ssl_loss_strategy_matches_jax(key):
    (l1, kl, d), (r1, rk, rd) = _both_losses(key, np.float64)
    np.testing.assert_allclose(l1, r1, rtol=RTOL)
    np.testing.assert_allclose(kl, rk, rtol=RTOL)
    # gradfilter's map is a uniform softmax whatever the image (the
    # reference's column-0 gather), so its d_sr is zero in both
    assert np.abs(rd).max() > 0 or key == "areaarea_gradfilter"
    np.testing.assert_allclose(d, rd, rtol=RTOL, atol=RTOL * np.abs(rd).max())


@pytest.mark.parametrize("key", ["areaarea", "areaarea_mask_nonlocal_cuda_v1"])
def test_ssl_loss_strategy_float32_matches_jax(key):
    """In float32, with an image whose mask is empty in the batch."""
    (l1, kl, d), (r1, rk, rd) = _both_losses(key, np.float32, b=2)
    assert not d[1].any()
    np.testing.assert_allclose(l1, r1, rtol=1e-4)
    np.testing.assert_allclose(kl, rk, rtol=1e-3)
    err = np.abs(d - rd) - 1e-6 * np.abs(rd).max()
    assert np.linalg.norm(np.maximum(err, 0)) <= 1e-4 * np.linalg.norm(rd)


@pytest.mark.parametrize("key", Z.PAIRED)
def test_paired_strategies_need_img_sr(key):
    """simself_strategy_loss passes no img_sr: both packages refuse these."""
    gt, sr, mask = _batch(np.float32, b=2)
    js, ts = _settings(key)
    with pytest.raises(AssertionError):
        jssl.ssl_loss(jnp.asarray(sr.transpose(0, 2, 3, 1)), jnp.asarray(gt.transpose(0, 2, 3, 1)),
                      jnp.asarray(mask[:, 0]), js)
    with pytest.raises(ValueError, match="img_sr"):
        tssl.ssl_loss(torch.from_numpy(sr), torch.from_numpy(gt), torch.from_numpy(mask), ts)


def test_trainable_sigma_rows_and_sigma_gradient_match_jax():
    gt, sr, mask = Z.images(4)
    ys, xs = np.nonzero(mask[0, 0] == 1)
    pos = np.stack([ys, xs], -1).astype(np.int32)
    kw = dict(ks=Z.SEARCH, kc=Z.WINDOW, softmax=True)

    def f(sigma):
        s, s1 = J.trainable_sigma_rows(jnp.asarray(gt[0]), jnp.asarray(sr[0]),
                                       jnp.asarray(pos), sigma=sigma, **kw)
        return jnp.sum(s * s1), (s, s1)
    with jax.enable_x64():
        (_, (s, s1)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(2.5))
        ref = np.asarray(s), np.asarray(s1), float(g)
    sigma = torch.nn.Parameter(torch.tensor(2.5, dtype=torch.float64))
    ts, ts1 = T.trainable_sigma_rows(torch.from_numpy(gt[0]), torch.from_numpy(sr[0]),
                                     torch.from_numpy(pos), sigma=sigma, **kw)
    torch.sum(ts * ts1).backward()
    np.testing.assert_allclose(ts.detach().numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(ts1.detach().numpy(), ref[1], rtol=RTOL)
    np.testing.assert_allclose(float(sigma.grad), ref[2], rtol=RTOL)


def test_judge_abnormal_pixel_matches_jax():
    gt, sr, _ = Z.images(5)
    sr[0, :, 5, 7] += 0.8                                   # a few clear outliers
    with jax.enable_x64():
        ref = [np.asarray(v) for v in J.judge_abnormal_pixel(jnp.asarray(sr), jnp.asarray(gt))]
    got = [v.numpy() for v in T.judge_abnormal_pixel(torch.from_numpy(sr), torch.from_numpy(gt))]
    assert ref[3].sum() > 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_module_level_helpers_match_jax():
    """``self_similarity`` and ``gradient_img_similarity`` (always softmax)."""
    gt, _, _ = Z.images(6)
    kw = dict(is_shift=True, shift_h=4, shift_w=4, dh=Z.TILE, dw=Z.TILE)
    with jax.enable_x64():
        ref = jax.jit(lambda g: (J.self_similarity(g, **kw), J.gradient_img_similarity(
            g, dh=Z.TILE, dw=Z.TILE, gray=True, threshold=1e-3)))(jnp.asarray(gt))
        ref = [np.asarray(v) for v in ref]
    got = [T.self_similarity(torch.from_numpy(gt), **kw).numpy(),
           T.gradient_img_similarity(torch.from_numpy(gt), dh=Z.TILE, dw=Z.TILE, gray=True,
                                     threshold=1e-3).numpy()]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())
