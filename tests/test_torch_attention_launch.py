"""K2's bf16 launch geometry (ssl_tpu_torch/ops/attention_cuda.py::
bwd_bf16_launch and fwd_bf16_launch), on the CPU.

The kernels cannot run here, but what the wrapper hands the C entry can be
checked: the TMA tensor maps of q, k, v and dO over their strided (b, seq,
heads, d) views, in the UNet's projection layout and the packed qkv layout
of the struct-cond encoder, at every d = 64 and 128 training case (and, for
the forward, every serving case), and the kernels' shared memory; at d = 512
(the VAE's single head, vae_mid at b = 1 and 2) also the clusters that share
the K and V tiles (forward) and the q, dO, k and v chunks (p_ds), the
geometry of dkv_mm and dq_mm (tiles, ring, shared memory, persistent grid,
the map of the P/dS scratch), and the
kernels ``fwd_plan`` and ``bwd_plan`` name.  The card checks that the
library agrees (the wrapper compares ``flash_attn_bwd_bf16_smem_bytes``,
``flash_attn_fwd_bf16_smem_bytes``, ``flash_attn_bwd_bf16_mm_geometry`` and
the ``*_cluster`` entries with the plan at every launch) and that the maps
encode."""

import pytest
import torch

from ssl_tpu_torch.ops import attention_cuda
from ssl_tpu_torch.ops.attention_cuda import (MAX_SMEM_BYTES, MM_KERNELS_BF16, TMA_MAX_BOX,
                                              TMA_MAX_STRIDE, TMA_SWIZZLE_BYTES, bwd_bf16_launch,
                                              bwd_bf16_smem_bytes, bwd_tile_map, fwd_bf16_launch,
                                              fwd_bf16_smem_bytes, mm_bf16_geometry,
                                              mm_bf16_smem_bytes)
from torch_attention_cases import CUDA_CASES, TRAIN_CASES

SMS = 132       # an H100 SXM's streaming multiprocessors

CASES = [(c, layout) for c, (b, h, n, m, d, *_) in sorted(TRAIN_CASES.items()) if d != 512
         for layout in ("proj", "qkv") if layout == "proj" or n == m]
# vae_mid by its batch: b = 1 serving, b = 2 training (the proj layout)
D512_CASES = {"serve": CUDA_CASES["vae_mid"], "train": TRAIN_CASES["vae_mid"]}
FWD_CASES = [(path, c, layout) for path, cases in (("serve", CUDA_CASES), ("train", TRAIN_CASES))
             for c, (b, h, n, m, d, *_) in sorted(cases.items()) if d != 512
             for layout in ("proj", "qkv") if layout == "proj" or n == m]


def _views(b, h, n, m, d, layout):
    """q, k, v and dO as the wrapper hands them on: bf16 views in ``layout``
    (no data: the geometry reads shapes, strides and bases), dO contiguous."""
    bf16 = torch.bfloat16
    if layout == "qkv":
        qkv = torch.empty((b, n, h, 3, d), dtype=bf16)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    else:
        q, k, v = (torch.empty((b, s, h, d), dtype=bf16) for s in (n, m, m))
    do = torch.empty((b, n, h, d), dtype=bf16)
    return tuple(attention_cuda._aligned(t) for t in (q, k, v, do))


@pytest.mark.parametrize("case,layout", CASES)
def test_bf16_backward_tensor_maps_fit_tma(case, layout):
    b, h, n, m, d = TRAIN_CASES[case][:5]
    q, k, v, do = _views(b, h, n, m, d, layout)
    launch = bwd_bf16_launch(q, k, v, do, SMS)
    rows = attention_cuda.BWD_STREAM_ROWS_BF16[d][0]
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        tmap = launch["maps"][name]
        seq = n if name in ("q", "do") else m
        assert tmap["dims"] == (d, h, seq, b)
        assert tmap["strides"] == tuple(2 * s for s in (t.stride(2), t.stride(1), t.stride(0)))
        assert all(s % 16 == 0 and 0 < s < TMA_MAX_STRIDE for s in tmap["strides"])
        assert tmap["base"] % 16 == 0
        assert tmap["box"] == (64, 1, rows, 1)
        assert max(tmap["box"]) <= TMA_MAX_BOX
        assert tmap["box"][0] * 2 <= TMA_SWIZZLE_BYTES == tmap["swizzle"]
        # the box rows tile every sequence, and d is whole 64-column boxes
        assert seq % rows == 0 and d % tmap["box"][0] == 0
    if layout == "qkv":      # the packed views go in without a copy: k and v 2d and 4d bytes on
        assert launch["maps"]["k"]["base"] - launch["maps"]["q"]["base"] == 2 * d
        assert launch["maps"]["q"]["strides"][0] == 2 * 3 * d
    assert all(s <= MAX_SMEM_BYTES for s in launch["smem_bytes"])


@pytest.mark.parametrize("d,stages", [(64, 4), (128, 3)])
def test_bf16_backward_shared_memory_by_layout(d, stages):
    """Alignment slack, the resident 128 x d operands, the ring's 64 x d
    operands (and dkv's lse and di a stage), 8 bytes a barrier."""
    assert attention_cuda.BWD_STAGES_BF16[d] == stages
    resident, ring = 2 * 128 * d * 2, stages * 2 * 64 * d * 2
    barriers = 8 * (2 * stages + 1)
    assert bwd_bf16_smem_bytes(d) == (1024 + resident + ring + stages * 2 * 64 * 4 + barriers,
                                      1024 + resident + ring + barriers)


def _check_map(tmap, t, seq, rows):
    """A map of ``t`` (bf16, d columns) as the hardware takes it, its boxes
    ``rows`` rows, tiling ``seq`` and d."""
    b, _, h, d = t.shape
    assert tmap["dims"] == (d, h, seq, b)
    assert tmap["strides"] == tuple(2 * s for s in (t.stride(2), t.stride(1), t.stride(0)))
    assert all(s % 16 == 0 and 0 < s < TMA_MAX_STRIDE for s in tmap["strides"])
    assert tmap["base"] % 16 == 0
    assert tmap["box"] == (64, 1, rows, 1)
    assert max(tmap["box"]) <= TMA_MAX_BOX
    assert tmap["box"][0] * 2 <= TMA_SWIZZLE_BYTES == tmap["swizzle"]
    assert seq % rows == 0 and d % tmap["box"][0] == 0


@pytest.mark.parametrize("path,case,layout", FWD_CASES)
def test_bf16_forward_tensor_maps_fit_tma(path, case, layout):
    """The forward's maps: q in boxes of the plan's query rows, k and v in
    boxes of its key rows, at every d = 64 and 128 serving and training case."""
    b, h, n, m, d = (CUDA_CASES if path == "serve" else TRAIN_CASES)[case][:5]
    q, k, v, _ = _views(b, h, n, m, d, layout)
    launch = fwd_bf16_launch(q, k, v)
    rows, keys, per_sm = attention_cuda.FWD_TILES_BF16[d]
    assert per_sm == 1
    for name, t, seq, box in (("q", q, n, rows), ("k", k, m, keys), ("v", v, m, keys)):
        _check_map(launch["maps"][name], t, seq, box)
    if layout == "qkv":      # the packed views go in without a copy
        assert launch["maps"]["v"]["base"] - launch["maps"]["k"]["base"] == 2 * d
        assert launch["maps"]["k"]["strides"][0] == 2 * 3 * d
    assert launch["smem_bytes"] <= MAX_SMEM_BYTES


@pytest.mark.parametrize("d,stages", [(64, 4), (128, 2)])
def test_bf16_forward_shared_memory_by_layout(d, stages):
    """Alignment slack, the resident 128 x d Q, the ring's 128 x d K and V
    tiles, 8 bytes a barrier, and the turns' words (one float and 256
    row-sum slots)."""
    assert attention_cuda.FWD_STAGES_BF16[d] == stages
    assert attention_cuda.FWD_TILES_BF16[d][:2] == (128, 128)
    q_tile, ring = 128 * d * 2, stages * 2 * 128 * d * 2
    barriers = 8 * (2 * stages + 1)
    assert fwd_bf16_smem_bytes(d) == 1024 + q_tile + ring + barriers + 4 * 257
    assert fwd_bf16_smem_bytes(d) <= MAX_SMEM_BYTES


def test_bf16_tile_map_refuses_what_tma_cannot_take():
    rows = torch.empty((1, 128, 2, 68), dtype=torch.bfloat16)[..., :64]   # 136-byte rows
    with pytest.raises(ValueError, match="multiples of 16"):
        bwd_tile_map(rows, 64)
    with pytest.raises(ValueError, match="box"):
        bwd_tile_map(torch.empty((1, 512, 1, 64), dtype=torch.bfloat16), 512)
    with pytest.raises(ValueError, match="unit stride"):
        bwd_tile_map(torch.empty((1, 128, 1, 64), dtype=torch.bfloat16).transpose(1, 3), 64)


@pytest.mark.parametrize("path", sorted(D512_CASES))
def test_bf16_d512_forward_geometry(path):
    """The d = 512 forward at vae_mid: maps in boxes of 64 query and key rows,
    ~210 KB of shared memory, clusters of 2 query tiles that divide the grid,
    and ``fwd_plan``'s key split: 2 with one combine at b = 1 (64 query tiles
    would fill under 90% of 132 SMs), none at b = 2."""
    b, h, n, m, d = D512_CASES[path][:5]
    q, k, v, _ = _views(b, h, n, m, d, "proj")
    launch = fwd_bf16_launch(q, k, v)
    rows, keys, per_sm = attention_cuda.FWD_TILES_BF16[d]
    assert (rows, keys, per_sm) == (64, 64, 1)
    for name, t, seq, box in (("q", q, n, rows), ("k", k, m, keys), ("v", v, m, keys)):
        _check_map(launch["maps"][name], t, seq, box)
    assert launch["smem_bytes"] == fwd_bf16_smem_bytes(512) <= MAX_SMEM_BYTES
    assert launch["cluster"] == 2 and (n // rows) % launch["cluster"] == 0
    split, scratch, kernels = attention_cuda.fwd_plan(b, h, n, m, d, 132, torch.bfloat16)
    assert (m // keys) % split == 0
    assert (n // rows) * b * h * split <= 132      # one wave of blocks
    if b == 1:
        assert (split, scratch) == (2, 2 * b * h * n * (d + 2))
        assert kernels == {"flash_attn_fwd_d512_bf16": 1, "flash_attn_fwd_combine_bf16": 1}
    else:
        assert (split, scratch) == (1, 0)
        assert kernels == {"flash_attn_fwd_d512_bf16": 1, "flash_attn_fwd_combine_bf16": 0}


@pytest.mark.parametrize("path", sorted(D512_CASES))
def test_bf16_d512_backward_geometry(path):
    """The d = 512 backward at vae_mid: p_ds's maps in boxes of 128 rows of
    q, k, v and dO, its ring of three 64 KB stages and a staged 128 x 128 bf16
    tile within ``MAX_SMEM_BYTES``, clusters of 2 key tiles that divide its
    128 x 128 tiles, and ``bwd_plan``'s
    three kernels, once each, over b·h·n·m bf16 of P and of dS.  dkv_mm and
    dq_mm (``_check_mm``): 128 x 256 tiles and a grid of one block an SM
    (vae_mid b = 2: 256 and 128 tiles for 132 SMs), at most one a tile."""
    b, h, n, m, d = D512_CASES[path][:5]
    q, k, v, do = _views(b, h, n, m, d, "proj")
    launch = bwd_bf16_launch(q, k, v, do, SMS)
    rows, keys = attention_cuda.P_DS_TILE_BF16
    for name, t, seq in (("q", q, n), ("k", k, m), ("v", v, m), ("do", do, n)):
        _check_map(launch["maps"][name], t, seq, rows)
    assert launch["smem_bytes"] == (attention_cuda.p_ds_bf16_smem_bytes(),)
    smem = launch["smem_bytes"][0]
    assert smem == 1024 + 3 * 4 * 128 * 64 * 2 + 128 * 128 * 2 + 8 * 6 <= MAX_SMEM_BYTES
    assert launch["cluster"] == 2 and (m // keys) % launch["cluster"] == 0
    _check_mm(launch, q, k, do)
    assert [launch["mm"][kernel]["grid"] for kernel in MM_KERNELS_BF16] == (
        [132, 128] if b == 2 else [128, 64])
    assert attention_cuda.bwd_plan(b, h, n, m, d, 132, torch.bfloat16) == (
        1, 1, 2 * b * h * n * m, {"flash_attn_bwd_p_ds_bf16": 1,
                                  "flash_attn_bwd_dkv_mm_bf16": 1,
                                  "flash_attn_bwd_dq_mm_bf16": 1})


@pytest.mark.parametrize("n,m,fwd,bwd", [(384, 256, 2, 2), (512, 384, 2, 1), (128, 128, 2, 1)])
def test_bf16_d512_clusters_divide_odd_tile_counts(n, m, fwd, bwd):
    """n and m are only multiples of 128: the forward's pairs of 64-query
    tiles always divide n, and where p_ds's 128-key tiles do not come in
    pairs its clusters shrink to one block; dkv_mm's and dq_mm's tiles divide
    them too (``_check_mm``)."""
    q, k, v, do = _views(1, 2, n, m, 512, "proj")
    assert fwd_bf16_launch(q, k, v)["cluster"] == fwd
    launch = bwd_bf16_launch(q, k, v, do, SMS)
    assert launch["cluster"] == bwd
    _check_mm(launch, q, k, do)


def _check_mm(launch, q, k, do):
    """dkv_mm's and dq_mm's geometry in ``launch`` for q, k and dO: tiles that
    divide their output rows (m keys, n queries) and d, whole 64-row chunks
    of the contraction, shared memory within ``MAX_SMEM_BYTES``, a grid of
    one block an SM and at most one a tile; the maps of q, k, dO and of the
    scratch viewed as (2·b·h, n, 1, m), all in 64-row boxes."""
    b, n, h, d = q.shape
    m = k.shape[1]
    mm = launch["mm"]
    scratch = torch.empty((2 * b * h, n, 1, m), dtype=torch.bfloat16, device="meta")
    for name, t, seq in (("scratch", scratch, n), ("q", q, n), ("k", k, m), ("do", do, n)):
        _check_map(mm["maps"][name], t, seq, 64)
    assert mm["maps"]["scratch"]["dims"] == (m, 1, n, 2 * b * h)
    assert mm["maps"]["scratch"]["strides"] == (2 * m, 2 * m, 2 * n * m)
    for kernel, rows, depth in zip(MM_KERNELS_BF16, (m, n), (n, m)):
        g = mm[kernel]
        assert g == mm_bf16_geometry(kernel, b, h, n, m, SMS)
        tile_rows, tile_cols = g["tile"]
        assert rows % tile_rows == 0 and d % tile_cols == 0 and depth % 64 == 0
        assert g["smem_bytes"] == mm_bf16_smem_bytes() <= MAX_SMEM_BYTES
        tiles = (2 if kernel.startswith("flash_attn_bwd_dkv") else 1) * b * h * (
            rows // tile_rows) * (d // tile_cols)
        assert g["grid"] == min(SMS, tiles)


def test_bf16_mm_shared_memory_by_layout():
    """dkv_mm and dq_mm: alignment slack, four stages of a 16 KB A chunk (two
    64 x 64 boxes of the scratch) and a 32 KB B chunk (four of dO, q or k), a
    staged 128 x 64 output block, 8 bytes a barrier."""
    assert attention_cuda.MM_STAGES_BF16 == 4 and attention_cuda.MM_TILE_BF16 == (128, 256)
    assert mm_bf16_smem_bytes() == 1024 + 4 * (16384 + 32768) + 16384 + 8 * 8 <= MAX_SMEM_BYTES


@pytest.mark.parametrize("b,n,m,grids", [(2, 4096, 4096, (132, 128)), (1, 4096, 4096, (128, 64)),
                                         (1, 512, 384, (12, 8)), (1, 128, 128, (4, 2))])
def test_bf16_mm_grid_is_persistent_and_whole(b, n, m, grids):
    """The grids of dkv_mm and dq_mm: one block an SM, fewer where there are
    fewer tiles (the blocks walk the tiles in turn)."""
    for kernel, grid in zip(MM_KERNELS_BF16, grids):
        assert mm_bf16_geometry(kernel, b, 1, n, m, SMS)["grid"] == grid
