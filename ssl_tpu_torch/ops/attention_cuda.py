"""K2 on Hopper: flash attention's forward and backward as CUDA kernels.

Replaces the Pallas TPU flash attention that ``ssl_tpu/ops/attention.py``
(``sdp_attention``, flash branch :32-39) calls, and the two Pallas kernels of
its custom VJP.  The kernel sources are ``ssl_tpu_torch/csrc/flash_attn_fwd.cu``
(``flash_attn_fwd`` at d = 64 and 128, ``flash_attn_fwd_d512`` at d = 512,
with ``flash_attn_fwd_combine`` where the key loop is split; in bf16 both
take q, k and v as TMA tensor maps, ``fwd_bf16_launch``) and
``ssl_tpu_torch/csrc/flash_attn_bwd.cu`` (``flash_attn_bwd_dkv`` and
``flash_attn_bwd_dq`` at d = 64 and 128, with ``flash_attn_bwd_sum`` where
the loop is split; ``flash_attn_bwd_p_ds``, ``flash_attn_bwd_dkv_mm`` and
``flash_attn_bwd_dq_mm`` at d = 512; in bf16 dkv, dq and p_ds take q, k, v
and dO as TMA tensor maps, and dkv_mm and dq_mm the P/dS scratch too,
``bwd_bf16_launch``; ``flash_attn_bwd_mm_cuda`` launches those two alone).
They read q, k, v and dO through their (b, seq, heads, d) strides, so the
UNet's (b, n, heads·d) projections and the head-major packed qkv of
``AttentionBlockQKV`` go in without a copy, and write contiguous (b, seq,
heads, d) outputs.  Callers route through
``ops/attention.py::sdp_attention``, which checks eligibility and holds the
autograd function."""

from __future__ import annotations

import ctypes

import torch

from ssl_tpu_torch.ops.cuda_build import load_library

# Calls of ``flash_attn_fwd_cuda`` in this process.
launches = 0
# Launches of each forward kernel in this process, counted where the C entry
# that launches it returns without error.
FWD_KERNELS = ("flash_attn_fwd", "flash_attn_fwd_d512", "flash_attn_fwd_combine")
fwd_kernel_launches = dict.fromkeys(FWD_KERNELS + tuple(f"{k}_bf16" for k in FWD_KERNELS), 0)
# Calls of ``flash_attn_bwd_cuda`` in this process.
bwd_launches = 0
# Launches of each backward kernel in this process, counted where the C entry
# that launches it returns without error.
BWD_KERNELS = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq", "flash_attn_bwd_sum",
               "flash_attn_bwd_p_ds", "flash_attn_bwd_dkv_mm", "flash_attn_bwd_dq_mm")
bwd_kernel_launches = dict.fromkeys(BWD_KERNELS + tuple(f"{k}_bf16" for k in BWD_KERNELS), 0)

# The element types the kernels take, and the suffix of their kernels' names.
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

# Head widths the kernels are instantiated for (a template on d in the
# sources): the UNet's and struct-cond encoder's heads and the VAE's single head.
HEAD_DIMS = (64, 128, 512)
# The backward's fused kernels by head width (csrc/flash_attn_bwd.cu), each
# as (dkv, dq): rows a block owns (keys, queries), rows streamed per tile
# (queries, keys), and blocks that fit one SM.  d = 512 takes the scratch
# path instead.
BWD_BLOCK_ROWS = {64: (128, 128), 128: (128, 128)}
BWD_STREAM_ROWS = {64: (32, 32), 128: (32, 32)}
BWD_BLOCKS_PER_SM = {64: (2, 2), 128: (1, 1)}
# The bf16 kernels (wgmma, TMA rings): 128 rows a block in two consumer
# warpgroups of 64 and a producer warpgroup, 384 threads, tiles of 64 rows
# streamed through BWD_STAGES_BF16 ring stages; one block an SM: 168
# registers a thread at launch, the consumers raised to 240 by setmaxnreg
# (ptxas for sm_90a: up to 229 in use, no spills).
BWD_BLOCK_ROWS_BF16 = {64: (128, 128), 128: (128, 128)}
BWD_STREAM_ROWS_BF16 = {64: (64, 64), 128: (64, 64)}
BWD_BLOCKS_PER_SM_BF16 = {64: (1, 1), 128: (1, 1)}
BWD_STAGES_BF16 = {64: 4, 128: 3}
BWD_MAX_SPLIT = 4
# The bf16 p_ds kernel at d = 512 (wgmma, TMA ring, clusters): tiles of 128
# queries x 128 keys (two consumer warpgroups of 64 query rows, a producer,
# 384 threads, one block an SM), d streamed in 64-column chunks of q, dO, k
# and v through P_DS_STAGES_BF16 ring stages; blocks in clusters of up to
# P_DS_CLUSTER_BF16 key tiles of one query tile, which share its q and dO
# (``p_ds_cluster``), as many as the card holds at once, each walking its
# share of the tiles.
P_DS_TILE_BF16 = (128, 128)
P_DS_STAGES_BF16 = 3
P_DS_CLUSTER_BF16 = 2
# The bf16 dkv_mm and dq_mm kernels at d = 512 (wgmma, TMA ring): output
# tiles of 128 rows (keys in dkv_mm, queries in dq_mm) x 256 columns of d
# (two consumer warpgroups of 64 rows, a producer, 384 threads, one block
# an SM), the contraction streamed in 64-deep chunks (two 64 x 64 boxes of
# the scratch and four of dO, q or k) through MM_STAGES_BF16 ring stages, on
# a persistent grid whose blocks walk the tiles in turn
# (``mm_bf16_geometry``).
MM_TILE_BF16 = (128, 256)
MM_STAGES_BF16 = 4
MM_KERNELS_BF16 = ("flash_attn_bwd_dkv_mm_bf16", "flash_attn_bwd_dq_mm_bf16")
# What one block of an sm_90a card may take of shared memory, and what a TMA
# tensor map allows: byte strides multiples of 16 below 2^40, box dimensions
# up to 256, an inner box of at most 128 bytes under the 128-byte swizzle.
MAX_SMEM_BYTES = 232448
TMA_MAX_STRIDE, TMA_MAX_BOX, TMA_SWIZZLE_BYTES = 1 << 40, 256, 128
# The forward's kernels by head width (csrc/flash_attn_fwd.cu): query rows a
# block owns, keys streamed per tile, and blocks that fit one SM; in float32
# and in bf16.  The bf16 kernel at d = 64 and 128 runs wgmma on TMA-loaded
# tiles: 384 threads (two consumer warpgroups of 64 query rows and a
# producer), key tiles through FWD_STAGES_BF16 ring stages, one block an SM:
# 168 registers a thread at launch, the consumers raised to 240 by setmaxnreg
# (up to 171 in use at d = 64, 219 at d = 128, no spills).  At d = 512 a
# block is 64 query rows whose two consumer warpgroups split the output
# columns, key tiles of 64 in one K and one V slot, and blocks go in clusters
# of FWD_CLUSTER_BF16 along the queries, which share every K and V tile
# (an H100 holds 30 clusters of 4 such blocks at once, too few for the 128
# blocks of vae_mid).
FWD_TILES = {64: (128, 32, 2), 128: (128, 32, 1), 512: (32, 32, 1)}
FWD_TILES_BF16 = {64: (128, 128, 1), 128: (128, 128, 1), 512: (64, 64, 1)}
FWD_STAGES_BF16 = {64: 4, 128: 2}
FWD_CLUSTER_BF16 = {512: 2}
FWD_MAX_SPLIT = 8


def _declare_fwd(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in (lib.flash_attn_fwd, lib.flash_attn_fwd_bf16):
        entry.argtypes = [p] * 6 + [ll] * 9 + [i] * 6 + [ctypes.c_float, p]
        entry.restype = i
    lib.flash_attn_fwd_bf16_smem_bytes.argtypes = [i]
    lib.flash_attn_fwd_bf16_smem_bytes.restype = i
    lib.flash_attn_fwd_bf16_cluster.argtypes = [i]
    lib.flash_attn_fwd_bf16_cluster.restype = i
    lib.flash_attn_fwd_combine_bf16.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.flash_attn_fwd_combine_bf16.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in (lib.flash_attn_bwd, lib.flash_attn_bwd_bf16):
        entry.argtypes = [p] * 10 + [ll] * 12 + [i] * 7 + [ctypes.c_float, p]
        entry.restype = i
    lib.flash_attn_bwd_bf16_smem_bytes.argtypes = [i, i]
    lib.flash_attn_bwd_bf16_smem_bytes.restype = i
    lib.flash_attn_bwd_bf16_cluster.argtypes = [i, i]
    lib.flash_attn_bwd_bf16_cluster.restype = i
    lib.flash_attn_bwd_mm_bf16.argtypes = [p] * 7 + [ll] * 9 + [i] * 5 + [ctypes.c_float, p]
    lib.flash_attn_bwd_mm_bf16.restype = i
    lib.flash_attn_bwd_bf16_mm_geometry.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attn_bwd_bf16_mm_geometry.restype = i
    lib.flash_attn_bwd_error_string.argtypes = [i]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take: (b, seq, heads, d) tensors on one device, all
    float32 or all bfloat16, unit stride along d, n and m multiples of 128, d
    in ``HEAD_DIMS``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (b, seq, heads, d) with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in b, heads or d")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in SUFFIX or t.dtype != q.dtype:
            raise TypeError(f"q, k and v must be all float32 or all bfloat16, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along d, got strides {t.stride()}")
    if n % 128 or k.shape[1] % 128:
        raise ValueError(f"sequence lengths must be multiples of 128, got n={n}, m={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of the kernel's {HEAD_DIMS}")


def check_bwd_inputs(q, k, v, o, lse, do) -> None:
    """``check_inputs`` for q, k and v, plus the forward's o and lse and the
    incoming gradient dO: o and dO shaped like q and of q's type, lse (b,
    heads, n), float32 and contiguous, all on q's device."""
    check_inputs(q, k, v)
    b, n, h, _ = q.shape
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, h, n), torch.float32)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous (b, heads, n)")


def fwd_plan(b: int, heads: int, n: int, m: int, d: int, sms: int, dtype=torch.float32):
    """How the forward runs on ``dtype`` inputs: (split, scratch floats, kernels).

    The key loop is cut into ``split`` parts when the grid of (query tile,
    b·head) blocks would fill under 90% of the ``sms`` SMs' block slots:
    powers of 2, at most ``FWD_MAX_SPLIT``, each dividing the key tiles.
    Each part writes its unnormalised output and row max and sum to scratch
    (b·heads·n·(d + 2) floats a part) and ``flash_attn_fwd_combine`` merges
    them in order.  ``kernels`` names each kernel with its launches."""
    rows, keys, per_sm = (FWD_TILES_BF16 if dtype == torch.bfloat16 else FWD_TILES)[d]
    blocks, tiles = n // rows * b * heads, m // keys
    split = 1
    while (blocks * split < 0.9 * per_sm * sms and tiles % (2 * split) == 0
           and split < FWD_MAX_SPLIT):
        split *= 2
    scratch = split * b * heads * n * (d + 2) if split > 1 else 0
    main = "flash_attn_fwd_d512" if d == 512 else "flash_attn_fwd"
    sfx = SUFFIX[dtype]
    return split, scratch, {main + sfx: 1, f"flash_attn_fwd_combine{sfx}": int(split > 1)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where a stride or the base is not 16-byte
    aligned (the kernels copy rows in 16-byte pieces: 4 floats, 8 bf16)."""
    per_16 = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % per_16 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def fwd_bf16_smem_bytes(d: int) -> int:
    """Dynamic shared memory a block of the bf16 forward takes at head width
    d (csrc/flash_attn_fwd.cu, ``fwd_bf16_smem_bytes`` and
    ``fwd_d512_bf16_smem_bytes``): 1024 bytes of alignment slack, Q (query
    rows x d bf16), the K and V tiles (key rows x d bf16 each) of each ring
    stage, and 8 bytes a barrier; at d = 64 and 128 full and empty a stage
    and one for Q, and the warpgroups' turns: one float read after each
    turn's wait and a row-sum slot for each of the 256 consumer threads; at
    d = 512 one stage (full and empty for each half of K and for V, and Q's:
    seven barriers), P twice (query rows x key rows bf16), and each row's max
    and sum by warpgroup (2 x query rows floats each)."""
    rows, keys, _ = FWD_TILES_BF16[d]
    if d == 512:
        return 1024 + rows * d * 2 + 2 * keys * d * 2 + 2 * rows * keys * 2 + 4 * 4 * rows + 8 * 7
    stages = FWD_STAGES_BF16[d]
    return (1024 + rows * d * 2 + stages * 2 * keys * d * 2 + 8 * (2 * stages + 1)
            + 4 * (1 + 256))


def fwd_bf16_launch(q, k, v) -> dict:
    """What the bf16 forward's C entry builds: the tensor maps of q (boxes of
    the plan's query rows) and of k and v (its key rows), ``bwd_tile_map``'s
    geometry, the kernel's shared memory (``fwd_bf16_smem_bytes``), checked
    against ``MAX_SMEM_BYTES``, and its cluster: at d = 512
    ``FWD_CLUSTER_BF16`` query tiles share each K and V tile (n is a multiple
    of 128, so the 64-row tiles come in pairs); 1 (no cluster) at d = 64
    and 128."""
    d = q.shape[3]
    rows, keys, _ = FWD_TILES_BF16[d]
    smem = fwd_bf16_smem_bytes(d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the bf16 forward at d = {d} needs {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    return {"maps": {"q": bwd_tile_map(q, rows), "k": bwd_tile_map(k, keys),
                     "v": bwd_tile_map(v, keys)},
            "smem_bytes": smem, "cluster": FWD_CLUSTER_BF16.get(d, 1)}


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                        return_lse: bool = False):
    """Launch K2's forward on CUDA tensors; returns what
    ``sdp_attention_reference`` does, and with ``return_lse`` also each row's
    log-sum-exp of the scaled logits as a contiguous (b, heads, n) tensor
    (``attention_lse_reference``).  q, k and v are taken through their
    strides, or copied once if a row is not 16-byte aligned; the key split
    and its scratch come from ``fwd_plan``."""
    global launches
    if not q.is_cuda:
        raise ValueError("flash_attn_fwd_cuda takes CUDA tensors")
    check_inputs(q, k, v)
    q, k, v = (_aligned(t) for t in (q, k, v))
    lib = load_library("flash_attn_fwd", _declare_fwd)
    b, n, h, d = q.shape
    m = k.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split, scratch_floats, kernels = fwd_plan(b, h, n, m, d, sms, q.dtype)
    out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32) if return_lse else None
    scratch = (torch.empty(scratch_floats, device=q.device, dtype=torch.float32)
               if scratch_floats else None)
    if q.dtype == torch.bfloat16:
        launch = fwd_bf16_launch(q, k, v)
        if lib.flash_attn_fwd_bf16_smem_bytes(d) != launch["smem_bytes"]:
            raise RuntimeError(f"the library's bf16 forward takes other shared memory than "
                               f"fwd_bf16_smem_bytes({d}) = {launch['smem_bytes']}")
        if lib.flash_attn_fwd_bf16_cluster(d) != launch["cluster"]:
            raise RuntimeError(f"the library's bf16 forward takes other clusters than the "
                               f"plan's {launch['cluster']} at d = {d}")
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    entry = lib.flash_attn_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_attn_fwd
    with torch.cuda.device(q.device):     # the C entry launches on the current device
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if return_lse else None,
                    None if scratch is None else scratch.data_ptr(), *strides, b, h, n, m, d,
                    split, float(sm_scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: "
                           f"{lib.flash_attn_error_string(err).decode()}")
    launches += 1
    for name, count in kernels.items():
        fwd_kernel_launches[name] += count
    return (out, lse) if return_lse else out


def flash_attn_fwd_combine_cuda(o_parts: torch.Tensor, m_parts: torch.Tensor,
                                l_parts: torch.Tensor):
    """Launch ``flash_attn_fwd_combine_bf16`` alone on the parts of a split
    bf16 forward: o_parts (split, b, n, heads, d), m_parts and l_parts (split,
    b, heads, n), contiguous float32 on one CUDA device, 2 <= split <=
    ``FWD_MAX_SPLIT``.  Returns what ``ops/attention.py::
    flash_attn_fwd_combine_reference`` does: (o in bf16, lse in float32)."""
    if not o_parts.is_cuda:
        raise ValueError("flash_attn_fwd_combine_cuda takes CUDA tensors")
    split, b, n, h, d = o_parts.shape
    for name, t, shape in (("o_parts", o_parts, (split, b, n, h, d)),
                           ("m_parts", m_parts, (split, b, h, n)),
                           ("l_parts", l_parts, (split, b, h, n))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != o_parts.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 tensor on "
                             f"{o_parts.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if d not in HEAD_DIMS or n % 128 or not 2 <= split <= FWD_MAX_SPLIT:
        raise ValueError(f"the combine takes d in {HEAD_DIMS}, n a multiple of 128 and 2-"
                         f"{FWD_MAX_SPLIT} parts, got d = {d}, n = {n}, {split} parts")
    lib = load_library("flash_attn_fwd", _declare_fwd)
    out = torch.empty((b, n, h, d), device=o_parts.device, dtype=torch.bfloat16)
    lse = torch.empty((b, h, n), device=o_parts.device, dtype=torch.float32)
    with torch.cuda.device(o_parts.device):
        err = lib.flash_attn_fwd_combine_bf16(o_parts.data_ptr(), m_parts.data_ptr(),
                                              l_parts.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                              b, h, n, d, split,
                                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_combine_bf16 launch failed: "
                           f"{lib.flash_attn_error_string(err).decode()}")
    fwd_kernel_launches["flash_attn_fwd_combine_bf16"] += 1
    return out, lse


def bwd_plan(b: int, heads: int, n: int, m: int, d: int, sms: int, dtype=torch.float32):
    """How the backward runs on ``dtype`` inputs: (dkv_split, dq_split,
    scratch elements, kernels).

    At d = 64 and 128, a split cuts the dkv kernel's loop over query tiles
    (dq's over key tiles) into parts when the grid would fill under 90% of
    the ``sms`` SMs' block slots: powers of 2, at most ``BWD_MAX_SPLIT``,
    each dividing the tile count.  Parts go to scratch and
    ``flash_attn_bwd_sum`` adds them in order; the parts are float32.  At
    d = 512 the scratch holds P and dS (b·heads·n·m each) in ``dtype``: in
    bf16 they are rounded there, where the products that read them take
    them.  ``kernels`` names each kernel with its launches."""
    sfx = SUFFIX[dtype]
    if d == 512:
        return 1, 1, 2 * b * heads * n * m, {f"flash_attn_bwd_{k}{sfx}": 1
                                             for k in ("p_ds", "dkv_mm", "dq_mm")}
    tables = ((BWD_BLOCK_ROWS_BF16, BWD_STREAM_ROWS_BF16, BWD_BLOCKS_PER_SM_BF16)
              if dtype == torch.bfloat16 else
              (BWD_BLOCK_ROWS, BWD_STREAM_ROWS, BWD_BLOCKS_PER_SM))
    block, rows, per_sm = (t[d] for t in tables)

    def split(blocks, tiles, slots):
        s = 1
        while blocks * s < 0.9 * slots and tiles % (2 * s) == 0 and s < BWD_MAX_SPLIT:
            s *= 2
        return s

    dkv = split(m // block[0] * b * heads, n // rows[0], per_sm[0] * sms)
    dq = split(n // block[1] * b * heads, m // rows[1], per_sm[1] * sms)
    scratch = (2 * dkv * b * m * heads * d if dkv > 1 else 0) + (dq * b * n * heads * d
                                                                if dq > 1 else 0)
    kernels = {f"flash_attn_bwd_dkv{sfx}": 1, f"flash_attn_bwd_dq{sfx}": 1,
               f"flash_attn_bwd_sum{sfx}": 2 * (dkv > 1) + (dq > 1)}
    return dkv, dq, scratch, kernels


def bwd_bf16_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory a block of the bf16 dkv and dq kernels takes at
    head width 64 or 128 (csrc/flash_attn_bwd.cu, ``dkv_bf16_smem_bytes`` and
    ``dq_bf16_smem_bytes``): 1024 bytes of alignment slack, the resident
    operands (K and V, or Q and dO: block rows x d bf16 each), each ring
    stage's two streamed operands (stream rows x d bf16 each; dkv's stage
    also the tile's lse and di, float32), and 8 bytes a barrier (full and
    empty a stage, one for the resident rows)."""
    stages = BWD_STAGES_BF16[d]
    (kv_rows, q_rows), (q_tile, k_tile) = BWD_BLOCK_ROWS_BF16[d], BWD_STREAM_ROWS_BF16[d]
    barriers = 8 * (2 * stages + 1)
    dkv = 1024 + 2 * kv_rows * d * 2 + stages * (2 * q_tile * d * 2 + 2 * q_tile * 4) + barriers
    dq = 1024 + 2 * q_rows * d * 2 + stages * 2 * k_tile * d * 2 + barriers
    return dkv, dq


def bwd_tile_map(t: torch.Tensor, rows: int) -> dict:
    """The TMA tensor map the bf16 backward's C entry encodes for a (b, seq,
    heads, d) bf16 tensor: dims (d, heads, seq, b) innermost first, the byte
    strides of the outer three, and boxes of 64 columns x 1 head x ``rows``
    rows x 1 batch under the 128-byte swizzle.  Raises ``ValueError`` where
    the hardware refuses the map."""
    b, seq, heads, d = t.shape
    size = t.element_size()
    m = {"dims": (d, heads, seq, b), "box": (64, 1, rows, 1),
         "strides": tuple(size * s for s in (t.stride(2), t.stride(1), t.stride(0))),
         "base": t.data_ptr(), "swizzle": TMA_SWIZZLE_BYTES}
    if t.stride(3) != 1 or m["base"] % 16:
        raise ValueError(f"a tensor map needs unit stride along d and a 16-byte aligned base, "
                         f"got strides {t.stride()} at {m['base']:#x}")
    if any(s % 16 or not 0 < s < TMA_MAX_STRIDE for s in m["strides"]):
        raise ValueError(f"tensor map byte strides {m['strides']} must be multiples of 16 "
                         f"below 2^40")
    if max(m["box"]) > TMA_MAX_BOX or m["box"][0] * size > TMA_SWIZZLE_BYTES:
        raise ValueError(f"tensor map box {m['box']} exceeds {TMA_MAX_BOX} or an inner "
                         f"{TMA_SWIZZLE_BYTES} bytes")
    return m


def p_ds_bf16_smem_bytes() -> int:
    """Dynamic shared memory a block of the bf16 p_ds kernel takes at d = 512
    (csrc/flash_attn_bwd.cu, ``p_ds_bf16_smem_bytes``): 1024 bytes of
    alignment slack, each ring stage's 64-column chunks of q, dO (query rows
    each), k and v (key rows each) in bf16, a tile of P or dS (rows x keys
    bf16) staged for its stores, and 8 bytes a barrier (full and empty a
    stage)."""
    rows, keys = P_DS_TILE_BF16
    return (1024 + P_DS_STAGES_BF16 * 2 * (rows + keys) * 64 * 2 + rows * keys * 2
            + 8 * 2 * P_DS_STAGES_BF16)


def p_ds_cluster(m: int) -> int:
    """Blocks a cluster of the bf16 p_ds kernel at m keys: ``P_DS_CLUSTER_BF16``
    where its key tiles come in pairs, else 1."""
    return P_DS_CLUSTER_BF16 if (m // P_DS_TILE_BF16[1]) % P_DS_CLUSTER_BF16 == 0 else 1


def mm_bf16_smem_bytes() -> int:
    """Dynamic shared memory a block of the bf16 dkv_mm or dq_mm kernel takes
    (csrc/flash_attn_bwd.cu, ``mm_bf16_smem_bytes``): 1024 bytes of
    alignment slack, each ring stage's A chunk (tile rows x 64 bf16) and B
    chunk (64 x tile columns bf16), a staged 128 x 64 bf16 block of the
    output, and 8 bytes a barrier (full and empty a stage)."""
    rows, cols = MM_TILE_BF16
    return 1024 + MM_STAGES_BF16 * (rows + cols) * 64 * 2 + rows * 64 * 2 + 8 * 2 * MM_STAGES_BF16


def mm_bf16_geometry(kernel: str, b: int, heads: int, n: int, m: int, sms: int) -> dict:
    """How ``kernel`` (one of ``MM_KERNELS_BF16``) runs at d = 512 on a card of
    ``sms`` SMs (csrc/flash_attn_bwd.cu, ``mm_plan``): its tile (rows of the
    output: keys in dkv_mm, queries in dq_mm; columns of d), ring stages,
    shared memory and grid: one block an SM, at most one a tile (dkv_mm's
    tiles cover dV and dK)."""
    rows, cols = MM_TILE_BF16
    dq = kernel == MM_KERNELS_BF16[1]
    tiles = (1 if dq else 2) * b * heads * ((n if dq else m) // rows) * (512 // cols)
    return {"tile": MM_TILE_BF16, "stages": MM_STAGES_BF16, "smem_bytes": mm_bf16_smem_bytes(),
            "grid": min(tiles, sms)}


def bwd_bf16_launch(q, k, v, do, sms: int) -> dict:
    """What the bf16 backward's C entry builds on a card of ``sms`` SMs: the
    tensor maps of q, k, v and dO (``bwd_tile_map``; boxes of the stream rows
    at d = 64 and 128, of the p_ds tiles' rows at d = 512), the wgmma
    kernels' shared memory (``bwd_bf16_smem_bytes``, or at d = 512
    ``p_ds_bf16_smem_bytes``), checked against ``MAX_SMEM_BYTES``, and the
    cluster: 1 at d = 64 and 128, ``p_ds_cluster(m)`` key tiles at d = 512.
    At d = 512 also what dkv_mm and dq_mm take (``mm``): the map of the
    [P | dS] scratch, viewed as (2·b·heads, n, 1, m), and of q, k and dO, all
    in boxes of 64 rows, and ``mm_bf16_geometry`` by kernel."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if d == 512:
        rows, smem, cluster = P_DS_TILE_BF16[0], (p_ds_bf16_smem_bytes(),), p_ds_cluster(m)
    else:
        rows, smem, cluster = BWD_STREAM_ROWS_BF16[d][0], bwd_bf16_smem_bytes(d), 1
    if max(smem) > MAX_SMEM_BYTES:
        raise ValueError(f"the bf16 backward at d = {d} needs {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    launch = {"maps": {name: bwd_tile_map(t, rows)
                       for name, t in (("q", q), ("k", k), ("v", v), ("do", do))},
              "smem_bytes": smem, "cluster": cluster}
    if d == 512:
        scratch = torch.empty((2 * b * h, n, 1, m), dtype=torch.bfloat16, device="meta")
        launch["mm"] = {"maps": {name: bwd_tile_map(t, 64) for name, t in
                                 (("scratch", scratch), ("q", q), ("k", k), ("do", do))},
                        **{kernel: mm_bf16_geometry(kernel, b, h, n, m, sms)
                           for kernel in MM_KERNELS_BF16}}
        if mm_bf16_smem_bytes() > MAX_SMEM_BYTES:
            raise ValueError(f"the bf16 dkv_mm and dq_mm need {mm_bf16_smem_bytes()} bytes of "
                             f"shared memory, more than {MAX_SMEM_BYTES}")
    return launch


def _check_mm_geometry(lib, b, h, n, m, sms) -> None:
    """Raises unless the library runs dkv_mm and dq_mm as ``mm_bf16_geometry``
    plans them on this card."""
    for i, kernel in enumerate(MM_KERNELS_BF16):
        plan = mm_bf16_geometry(kernel, b, h, n, m, sms)
        out = (ctypes.c_int * 5)()
        err = lib.flash_attn_bwd_bf16_mm_geometry(i, b, h, n, m, out)
        if err != 0:
            raise RuntimeError(f"flash_attn_bwd_bf16_mm_geometry failed: "
                               f"{lib.flash_attn_bwd_error_string(err).decode()}")
        want = (*plan["tile"], plan["stages"], plan["smem_bytes"], plan["grid"])
        if tuple(out) != want:
            raise RuntimeError(f"the library runs {kernel} as (rows, columns, stages, shared "
                               f"memory, grid) {tuple(out)}, the plan {want}")


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, sm_scale: float):
    """Launch K2's backward on CUDA tensors: (dq, dk, dv) in q's type, what
    ``flash_attn_bwd_reference`` returns.  di = rowsum(o * dO) is a plain
    float32 reduction here, as upstream leaves it to XLA; q, k, v and dO are taken
    through their strides, or copied once if their last axis is not
    unit-stride or a row is not 16-byte aligned.  Scratch (``bwd_plan``) is
    allocated here."""
    global bwd_launches
    if not q.is_cuda:
        raise ValueError("flash_attn_bwd_cuda takes CUDA tensors")
    check_bwd_inputs(q, k, v, o, lse, do)
    if do.stride(3) != 1:
        do = do.contiguous()
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lib = load_library("flash_attn_bwd", _declare_bwd)
    b, n, h, d = q.shape
    m = k.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dkv_split, dq_split, scratch_size, kernels = bwd_plan(b, h, n, m, d, sms, q.dtype)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()      # (b, heads, n)
    dq = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
    dk = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    dv = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    scratch = (torch.empty(scratch_size, device=q.device,
                           dtype=q.dtype if d == 512 else torch.float32)
               if scratch_size else None)
    if q.dtype == torch.bfloat16:
        launch = bwd_bf16_launch(q, k, v, do, sms)
        smem = launch["smem_bytes"]
        if tuple(lib.flash_attn_bwd_bf16_smem_bytes(d, i) for i in range(len(smem))) != smem:
            raise RuntimeError(f"the library's bf16 backward takes other shared memory than "
                               f"the plan's {smem} at d = {d}")
        if lib.flash_attn_bwd_bf16_cluster(d, m) != launch["cluster"]:
            raise RuntimeError(f"the library's bf16 backward takes other clusters than the "
                               f"plan's {launch['cluster']} at d = {d}")
        if d == 512:
            with torch.cuda.device(q.device):
                _check_mm_geometry(lib, b, h, n, m, sms)
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    entry = lib.flash_attn_bwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_attn_bwd
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), *strides, b, h, n, m, d,
                    dkv_split, dq_split, float(sm_scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: "
                           f"{lib.flash_attn_bwd_error_string(err).decode()}")
    bwd_launches += 1
    for name, count in kernels.items():
        bwd_kernel_launches[name] += count
    return dq, dk, dv


def flash_attn_bwd_mm_cuda(p_ds: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                           do: torch.Tensor, sm_scale: float):
    """Launch only the last two kernels of K2's bf16 backward at d = 512,
    dkv_mm and dq_mm, on a given scratch ``p_ds``: P and dS as the p_ds kernel
    writes them, a contiguous (2, b, heads, n, m) bf16 tensor on q's device.
    Returns (dq, dk, dv) in bf16 from bf16 (b, seq, heads, 512) q, k and dO,
    what ``ops/attention.py::flash_attn_bwd_mm_reference`` computes: dV = Pᵀ
    dO, dK = sm_scale dSᵀ q and dQ = sm_scale dS k, summed in float32 and
    rounded once.  Counts one launch of each kernel."""
    if not q.is_cuda:
        raise ValueError("flash_attn_bwd_mm_cuda takes CUDA tensors")
    check_inputs(q, k, k)
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    if do.stride(3) != 1:
        do = do.contiguous()
    b, n, h, d = q.shape
    m = k.shape[1]
    if q.dtype != torch.bfloat16 or d != 512:
        raise ValueError(f"the products alone run at d = 512 in bf16, got d = {d}, {q.dtype}")
    if (tuple(p_ds.shape) != (2, b, h, n, m) or p_ds.dtype != torch.bfloat16
            or p_ds.device != q.device or not p_ds.is_contiguous()):
        raise ValueError(f"p_ds must be a contiguous (2, {b}, {h}, {n}, {m}) bf16 tensor on "
                         f"{q.device}, got {tuple(p_ds.shape)} {p_ds.dtype} on {p_ds.device}")
    q, k, do = (_aligned(t) for t in (q, k, do))
    lib = load_library("flash_attn_bwd", _declare_bwd)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    bwd_bf16_launch(q, k, k, do, sms)      # raises where a tensor map would not encode
    dq = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
    dk = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    dv = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    strides = [s for t in (q, k, do) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        _check_mm_geometry(lib, b, h, n, m, sms)
        err = lib.flash_attn_bwd_mm_bf16(q.data_ptr(), k.data_ptr(), do.data_ptr(),
                                         p_ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), *strides, b, h, n, m, d, float(sm_scale),
                                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_mm_bf16 launch failed: "
                           f"{lib.flash_attn_bwd_error_string(err).decode()}")
    for name in MM_KERNELS_BF16:
        bwd_kernel_launches[name] += 1
    return dq, dk, dv
