"""K1's two kernels of the bf16 q store, in their plain versions, against
ssl_tpu's stored route (fp32 and bf16 streams, CPU).

With ``q_store_dtype="bfloat16"`` (the stored route) K1 is a walk, which
writes the inverse maps and a q stack, and a stream over that stack, which
takes the loss sums and the maps.  Their plain versions,
``ssl_tpu_torch/ops/ssg.py::q_stack_reference`` and ``q_stream_reference``,
are held here against ``ssl_tpu/ops/ssg.py``'s ``_q_stack`` /
``_q_stack_paired`` (reordered to the port's offset-major layout, the
paired stack's analytic centre offset put back) and ``_q_decode``, and the
two together against ``_ssl_loss_dense_core_stored``, on the smooth images of
tests/test_torch_bf16.py (search 9, window 5, sigma 0.004 on 2x3x20x24).

Tolerances.  The two packages' float32 q differ by ~1e-4 relative at sigma
0.004 (q = exp(-S / 0.3) turns S's rounding into q's), so a value within
that of a bf16 rounding boundary may round to the neighbouring bf16 value
(measured: 0.07% of the first values, 0.4% of the differences): every stored
value lies within one bf16 ulp of JAX's (the spacing of bf16 values at the
larger of the two first values, and at the larger of q_sr and q_gt for the
difference, whose own ulp is no larger; 2^-133 among the subnormals), and
at most 1% of them differ.  The inverse maps sum the float32 q: rtol
1e-4 (measured 1.0e-5).  The losses: tests/test_torch_bf16.py's LOSS_RTOL
for the store modes (measured at most 1.5e-5); the count exact.  The walk
and the stream together equal ``ssl_loss_sums_reference`` bit for bit: the
same arithmetic in the same order."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.ops import ssg as jssg
from ssl_tpu_torch.ops import ssg as tssg
from test_torch_bf16 import LOSS_RTOL, smooth_inputs

SEARCH, WINDOW, SIGMA = 9, 5, 0.004
FLIP_SHARE = 1e-2
# tests/test_torch_bf16.py's knob names for (store, stream)
KNOB = {"float32": "store", "bfloat16": "both"}


def _configs(stream: str, pair: bool = True):
    common = dict(search=SEARCH, window=WINDOW, sigma=SIGMA, q_store_dtype="bfloat16",
                  stream_dtype=stream)
    return jssg.SSGConfig(**common, pair_offsets=pair), tssg.SSGConfig(**common)


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (2^(e - 7) in the binade [2^e,
    2^(e+1)), 2^-133 among the subnormals)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@functools.lru_cache(maxsize=None)
def _jax_stored(stream: str, pair: bool):
    """JAX's stored core on the smooth inputs, with its stack in the port's
    layout: (search^2, b, h, w, 2) of (q_sr', q_sr - q_gt rounded) in
    float32."""
    sr, gt, mask = smooth_inputs(3)
    jcfg, _ = _configs(stream, pair)
    out = jssg._ssl_loss_dense_core_stored(jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(mask),
                                           jcfg)
    qs = np.asarray(out[7].astype(jnp.float32))
    n2, b = SEARCH * SEARCH, sr.shape[0]
    if pair:      # (n2 // 2, 2, 2b, h, w): offsets s and n2 - 1 - s; the centre q = 1
        half = n2 // 2
        full = np.empty((n2,) + qs.shape[2:], np.float32)
        full[:half] = qs[:, 0]
        full[n2 - 1 - np.arange(half)] = qs[:, 1]
        full[half, :b], full[half, b:] = 1.0, 0.0
        qs = full
    stack = np.stack([qs[:, :b], qs[:, b:]], axis=-1)
    return stack, tuple(np.array(v) for v in out[:7])


@functools.lru_cache(maxsize=None)
def _port_stack(stream: str):
    sr, gt, _ = smooth_inputs(3)
    return tssg.q_stack_reference(torch.from_numpy(sr), torch.from_numpy(gt),
                                  _configs(stream)[1])


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_q_stack_matches_jax(stream, pair):
    """The walk's stack and inverse maps against JAX's ``_q_stack`` /
    ``_q_stack_paired`` and its row sums."""
    ref, jout = _jax_stored(stream, pair)
    stack, inv_sr, inv_gt = _port_stack(stream)
    got = stack.float().numpy()
    assert stack.dtype == torch.bfloat16 and got.shape == ref.shape
    q_sr = ref[..., 0]
    q_gt = np.maximum(q_sr - ref[..., 1], 0.0)          # JAX's _q_decode
    off = np.abs(got - ref)
    assert (off[..., 0] <= bf16_ulp(np.maximum(np.abs(q_sr), np.abs(got[..., 0])))).all()
    assert (off[..., 1] <= bf16_ulp(np.maximum(q_sr, q_gt))).all()
    assert (off > 0).mean() <= FLIP_SHARE
    centre = got[SEARCH * SEARCH // 2]
    assert (centre[..., 0] == 1.0).all() and (centre[..., 1] == 0.0).all()
    for mine, theirs in ((inv_sr, jout[3]), (inv_gt, jout[4])):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_stack_then_stream_match_jax_stored_route(stream, pair):
    """The stream over the walk's stack against ``_ssl_loss_dense_core_stored``:
    l1 and kl within LOSS_RTOL, the count exact, and JAX's own stack decoded
    through the port's stream gives JAX's sums (the stream's decode is
    ``_q_decode``)."""
    ref, jout = _jax_stored(stream, pair)
    _, _, mask = smooth_inputs(3)
    stack, inv_sr, inv_gt = _port_stack(stream)
    mask_t = torch.from_numpy(mask)
    l1, kl, count, a_map, b_map = tssg.q_stream_reference(stack, inv_sr, inv_gt, mask_t)
    rtol = LOSS_RTOL[KNOB[stream]]
    for mine, theirs in ((l1, jout[0]), (kl, jout[1])):
        assert abs(float(mine) - float(theirs)) <= rtol * abs(float(theirs))
    assert float(count) == float(jout[2])
    assert a_map.shape == b_map.shape == mask_t.shape
    # JAX's stack and maps through the port's stream: only the order of the sums differs
    jstack = torch.from_numpy(ref).to(torch.bfloat16)
    assert torch.equal(jstack.float(), torch.from_numpy(ref))     # JAX's values are bf16
    l1_j, kl_j, _, a_j, b_j = tssg.q_stream_reference(
        jstack, torch.from_numpy(jout[3]), torch.from_numpy(jout[4]), mask_t)
    np.testing.assert_allclose([float(l1_j), float(kl_j)], [float(jout[0]), float(jout[1])],
                               rtol=1e-5)
    np.testing.assert_allclose(a_j.numpy(), jout[5], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_j.numpy(), jout[6], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("generalization", [True, False])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_stack_then_stream_equal_the_sums_reference(stream, generalization):
    """The walk's and the stream's plain versions together give what
    ``ssl_loss_sums_reference`` gives in the bf16 store modes, bit for bit."""
    sr, gt, mask = (torch.from_numpy(a) for a in smooth_inputs(5))
    cfg = _configs(stream)[1]._replace(generalization=generalization)
    stack, inv_sr, inv_gt = tssg.q_stack_reference(sr, gt, cfg)
    l1, kl, count, a_map, b_map = tssg.q_stream_reference(stack, inv_sr, inv_gt, mask)
    ref = tssg.ssl_loss_sums_reference(sr, gt, mask, cfg)
    for name, mine, theirs in zip(("l1", "kl", "count", "inv_sr", "inv_gt", "a_map", "b_map"),
                                  (l1, kl, count, inv_sr, inv_gt, a_map, b_map), ref):
        assert torch.equal(mine, theirs), name
