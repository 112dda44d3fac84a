"""The port's gather API (``ops/ssg.py``: ``mask_to_positions``,
``ssg_ssd_maps_scan``, ``ssg_matrix``, ``ssg_from_mask``) against
``ssl_tpu``'s on identical numpy inputs (CPU).

Positions exactly, also where the edge count exceeds the capacity.  Rows and
their gradient (a vector-Jacobian product with a seeded cotangent) in
float64 on both sides at rtol 1e-9, with an atol of 1e-9 of the largest
element for the gradient: the two compute each window sum differently (JAX
by prefix-sum differences, the port by sums of the non-negative terms), and
in float64 both sit ~1e-15 from the exact value.  In float32 the prefix-sum
differences cancel: at sigma 0.004 a raw SSD's absolute error becomes q's
relative error divided by c window^2 sigma, so the rows are held at rtol
1e-4 with an atol of 1e-6 of the largest row value (measured at 25 / 9 on
the q above 1e-6 of the largest: JAX 2.3e-5 relative from float64, the port
3.3e-6).  Most cases at search 7 / window 3 on 16-24^2 images, one at the
shipped 25 / 9 on 32^2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.ops import ssg as J
from ssl_tpu_torch.ops import ssg as T

RTOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# (search, window, sigma, generalization, h, w)
CASES = {"s7w3": (7, 3, 0.05, True, 16, 20), "s9w5_raw": (9, 5, 0.1, False, 24, 17),
         "s25w9": (25, 9, 0.004, True, 32, 32)}


def _inputs(case, dtype=np.float64):
    search, window, sigma, gen, h, w = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))]) * 0.3 + 0.5
    img = np.clip(base + 0.05 * rng.randn(3, h, w), 0, 1).astype(dtype)
    mask = (rng.rand(h, w) < 0.3).astype(dtype)
    cfg = dict(search=search, window=window, sigma=sigma, generalization=gen)
    return img, mask, cfg


@pytest.mark.parametrize("capacity", [5, 40, 400])
def test_mask_to_positions_matches_jax_exactly(capacity):
    """Capacity below the count (row-major truncation), near it and above it
    (padding rows (0, 0)), and an empty mask."""
    mask = (np.random.RandomState(capacity).rand(13, 11) < 0.3).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        ref = [np.asarray(v) for v in J.mask_to_positions(jnp.asarray(m), capacity)]
        got = [v.numpy() for v in T.mask_to_positions(torch.from_numpy(m), capacity)]
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssg_matrix_rows_and_gradient_match_jax(case):
    img, mask, cfg = _inputs(case)
    cap = int(mask.sum()) + 3                          # three padding rows
    cot = np.random.RandomState(7).randn(cap, cfg["search"] ** 2)

    def rows_and_vjp(x, c, pos):
        q, vjp = jax.vjp(lambda y: J.ssg_matrix(y, pos, J.SSGConfig(**cfg)), x)
        return q, vjp(c)[0]
    with jax.enable_x64():
        pos, _, _ = J.mask_to_positions(jnp.asarray(mask), cap)
        ref, ref_d = jax.jit(rows_and_vjp)(jnp.asarray(img), jnp.asarray(cot), pos)
        ref = np.asarray(ref)
    x = torch.from_numpy(img).requires_grad_(True)
    tq, valid, count = T.ssg_from_mask(x, torch.from_numpy(mask), cap, T.SSGConfig(**cfg))
    assert int(count) == cap - 3 and int(valid.sum()) == cap - 3
    (tq * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tq.detach().numpy(), ref, rtol=RTOL, atol=0)
    ref_d = np.asarray(ref_d)
    np.testing.assert_allclose(x.grad.numpy(), ref_d, rtol=RTOL, atol=RTOL * np.abs(ref_d).max())


def test_ssg_matrix_float32_matches_jax():
    img, mask, cfg = _inputs("s25w9", np.float32)
    pos, _, _ = J.mask_to_positions(jnp.asarray(mask), 64)
    ref = np.asarray(J.ssg_matrix(jnp.asarray(img), pos, J.SSGConfig(**cfg)))
    got = T.ssg_matrix(torch.from_numpy(img), torch.from_numpy(np.array(pos)),
                       T.SSGConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max())


def test_batching_computes_one_function():
    """A batch of images equals each image alone."""
    img, mask, cfg = _inputs("s7w3")
    cfg = T.SSGConfig(**cfg)
    pos, _, _ = T.mask_to_positions(torch.from_numpy(mask), 30)
    one = T.ssg_matrix(torch.from_numpy(img), pos, cfg)
    two = torch.from_numpy(np.stack([img, img[:, ::-1].copy()]))
    batch = T.ssg_matrix(two, torch.stack([pos, pos]), cfg)
    np.testing.assert_allclose(batch[0].numpy(), one.numpy(), rtol=1e-12)
    np.testing.assert_allclose(batch[1].numpy(), T.ssg_matrix(two[1], pos, cfg).numpy(),
                               rtol=1e-12)


def test_chunked_rows_equal_one_chunk(monkeypatch):
    """Rows formed a search row at a time (a small ``SSD_CHUNK_BYTES``) equal
    those of one chunk, and so does their gradient."""
    img, mask, cfg = _inputs("s9w5_raw")
    pos, _, _ = T.mask_to_positions(torch.from_numpy(mask), 50)
    out = []
    for chunk in (T.SSD_CHUNK_BYTES, 1):
        monkeypatch.setattr(T, "SSD_CHUNK_BYTES", chunk)
        x = torch.from_numpy(img).requires_grad_(True)
        rows = T.ssg_ssd_maps_scan(x, T.SSGConfig(**cfg), pos)
        rows.square().sum().backward()
        out.append((rows.detach(), x.grad))
    assert torch.equal(out[0][0], out[1][0])
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(), rtol=1e-12)
