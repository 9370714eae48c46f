"""W4A16 and W4A8 GEMMs over QTPU-packed weights: CUDA kernels K1 (G = 128),
K9 (G = 32 or 64), K11 / K11f (W4A8) and their plain versions.

Port of ``quick_tpu/ops/quantized_matmul.py``. ``quantized_matmul`` keeps the
JAX entry point's contract and dispatch: ``fuse_norm`` / ``fuse_glu`` ride
in K1's prologue when the flattened rows are <= 8, G = 128 and ``a8`` is
off, and are applied first otherwise (:721-730, :996-1004). On CUDA tensors
the work goes to the hand-written kernels: ``csrc/quantized_matmul.cu`` (K1)
at G = 128, ``csrc/quantized_matmul_dequant.cu`` (K9,
``_make_kernel_dequant``) at G = 32 and 64. On CPU tensors every G takes the
plain PyTorch version of ``_quantized_matmul_jnp`` (:88), which is what the
JAX package computes on the CPU by default: bf16 activations times the
integer codes summed in f32 per group, scaled on the output side, minus
``xsum @ (z * s)`` with xsum over the bf16-rounded activations.

W4A8 (``a8=True``, which ``QuantLinear`` sets from ``QUICK_TPU_A8``): above
96 flattened rows the activations are quantized per row to int8
(``quantize_activations``) and the per-group dots run int8 x int8 -> int32
against the same int4 codes, with the row scale in the epilogue
(``_quantized_matmul_a8_jnp`` :258). On CUDA tensors that is
``csrc/quantized_matmul_a8.cu``: K11 (``_make_kernel_a8``) over the codes
the wrapper computed, or, with ``QUICK_TPU_A8_FUSED=1`` at G = 128, K11f
(``_make_kernel_a8_fused``), which quantizes each row once in its first
kernel. Rows <= 96 stay on K1 / K9.

The dense-dequant route of the JAX package (``QUICK_TPU_DENSE_M``) is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)
from quick_tpu_torch.ops.norms import rms_norm
from quick_tpu_torch.ops.paged_write import div127
from quick_tpu_torch.quantize.packing import PACK, unpack_qtpu_tensor

#: K1. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by prologue and shape.
KERNEL = CudaKernel(
    "quantized_matmul.cu",
    {"qtt_quantized_matmul": [
        ptr, i32, ptr, ptr, ptr, ptr, f32, i32, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr,
    ]},
)

#: K9, the small-group GEMM (``_make_kernel_dequant``).
KERNEL_DEQUANT = CudaKernel(
    "quantized_matmul_dequant.cu",
    {"qtt_quantized_matmul_dequant": [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
    ]},
)
_DQ_COUNTERS = ZeroedWords("K9")  # its decode rows' merge counters, zero between launches

#: K11 and K11f (``_make_kernel_a8``, ``_make_kernel_a8_fused``), one library.
KERNEL_A8 = CudaKernel(
    "quantized_matmul_a8.cu",
    {"qtt_quantized_matmul_a8": [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
    ]},
)

_PROLOGUE = {None: 0, "rmsnorm": 1, "glu": 2}
_BN = 128  # output columns per block (csrc/quantized_matmul.cu kBN)
KERNEL_GROUP = 128  # the only group size K1 takes
DEQUANT_GROUPS = (32, 64)  # the group sizes K9 is built for
A8_GROUPS = (128, 64, 32)  # the group sizes K11 is built for (K11f: 128 only)
A8_MIN_ROWS = 97  # a8 takes rows > 96 (:1023); fewer stay on the W4A16 kernels
_KC = 128  # k per chunk of K9 and K11 (kKC, kChunk in their sources)


def glu_plain(x: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up on a raw [M, 2K] fused gate_up row (f32 math, cast
    back) — ``_glu_fallback`` (:675)."""
    K = x.shape[-1] // 2
    g = x[..., :K].to(torch.float32)
    u = x[..., K:].to(torch.float32)
    out_dtype = x.dtype if x.dtype != torch.float32 else torch.bfloat16
    return (g * torch.sigmoid(g) * u).to(out_dtype)


def quantized_matmul_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int = 128,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of K1 without prologue: x [M, K] -> [M, N].

    The bf16 activation times an integer code is exact in f32, so an f32
    product of the converted operands is the integer-code dot of the JAX
    contract, summed in f32."""
    K = x.shape[-1]
    ng = K // group_size
    N = qweight.shape[1]
    codes = unpack_qtpu_tensor(qweight, group_size).to(torch.float32)
    codes = codes.reshape(ng, group_size, N)
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(-1, ng, group_size)
    xg = xb.transpose(0, 1)  # [ng, M, G]
    y = torch.bmm(xg, codes)  # [ng, M, N] per-group integer dots
    y = (y * scales.to(torch.float32)[:, None, :]).sum(0)
    xsum = xg.sum(-1).transpose(0, 1)  # [M, ng]
    y = y - xsum @ zeros_x_scales.to(torch.float32)
    return y.to(out_dtype)


def quantized_matmul_dequant_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of K9 (``_make_kernel_dequant`` :522): x [M, K] ->
    [M, N]. Each weight is dequantized to bf16 from two rounded f32
    operations, ``bf16(code * s - zs)``, then ``bf16(x) @ w`` is summed in
    f32 (the products of two bf16 values are exact in f32)."""
    K = x.shape[-1]
    ng = K // group_size
    N = qweight.shape[1]
    codes = unpack_qtpu_tensor(qweight, group_size).to(torch.float32)
    codes = codes.reshape(ng, group_size, N)
    w = codes * scales.to(torch.float32)[:, None, :]
    w = (w - zeros_x_scales.to(torch.float32)[:, None, :]).to(torch.bfloat16)
    y = x.to(torch.bfloat16).to(torch.float32) @ w.reshape(K, N).to(torch.float32)
    return y.to(out_dtype)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric INT8 activations (``quantize_activations`` :246):
    x [M, K] -> (codes int8 [M, K], scales f32 [M, 1]); f32 absmax,
    ``max(amax / 127, 1e-8)`` with a true division (``div127``), round half
    to even, clip to +-127. Torch glue on every device, as the JAX package
    computes it outside Pallas."""
    xf = x.to(torch.float32)
    sx = torch.clamp(div127(xf.abs().amax(dim=-1, keepdim=True)), min=1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def a8_rowsum_plain(xq: torch.Tensor, group_size: int = KERNEL_GROUP) -> torch.Tensor:
    """Plain version of K11's first kernel (``a8_rowsum_kernel``): the
    integer sum of each group's codes of xq [M, K] as f32 [K / G, M] (exact:
    at most 128 * 127 in magnitude), the row sums of the zero-point term."""
    M, K = xq.shape
    rowsum = xq.to(torch.int32).reshape(M, K // group_size, group_size).sum(-1)
    return rowsum.t().to(torch.float32)


def a8_row_quant_plain(
    x: torch.Tensor, group_size: int = KERNEL_GROUP,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K11f's first kernel: ``quantize_activations``' int8
    codes [M, K] and row scales [M, 1], and the groups' row sums
    (``a8_rowsum_plain``)."""
    xq, sx = quantize_activations(x)
    return xq, sx, a8_rowsum_plain(xq, group_size)


def quantized_matmul_a8_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int = 128,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of K11 / K11f (``_quantized_matmul_a8_jnp`` :258):
    x [M, K] -> [M, N]. Each group's integer dot is at most
    128 * 127 * 15 = 243,840 < 2^24 in magnitude, so the f32 product of the
    converted codes computes it exactly in any order (with TF32 off, as
    PyTorch's default leaves it); then f32 output-side scaling, the
    zero-point term over the codes' row sums, and the row scale."""
    K = x.shape[-1]
    ng = K // group_size
    N = qweight.shape[1]
    codes = unpack_qtpu_tensor(qweight, group_size).to(torch.float32)
    codes = codes.reshape(ng, group_size, N)
    xq, sx = quantize_activations(x)
    xg = xq.to(torch.float32).reshape(-1, ng, group_size).transpose(0, 1)  # [ng, M, G]
    y = torch.bmm(xg, codes)  # [ng, M, N] exact per-group integer dots
    y = (y * scales.to(torch.float32)[:, None, :]).sum(0)
    xsum = xg.sum(-1).transpose(0, 1)  # [M, ng], exact
    y = y - xsum @ zeros_x_scales.to(torch.float32)
    return (y * sx).to(out_dtype)


def a8_fused_quant() -> bool:
    """``QUICK_TPU_A8_FUSED=1`` routes W4A8 at G = 128 through K11f, which
    quantizes the activations inside the kernel (``_a8_fused_quant`` :383).
    Read at every call."""
    return os.environ.get("QUICK_TPU_A8_FUSED", "0") == "1"


def launch_key(prologue: Optional[str], M: int, K: int, N: int) -> str:
    return f"{prologue or 'none'} M={M} K={K} N={N}"


def mma_launch_plan(M: int, K: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(rows per block, K splits, groups per split) of K1's CUDA-core decode
    body (up to 8 rows); its split of K is also K11's (``a8_plan``), which
    took it with the 64-row blocks of its first body.

    One block covers 128 columns and ``rows`` rows: 1, 2, 4 or 8 on the
    CUDA-core path, 64 for M > 8. When those tiles cannot fill the card
    (two blocks per SM), K is split over blocks so about four blocks per SM
    stream weights; a second pass sums the splits."""
    rows = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8 if M <= 8 else 64
    tiles = math.ceil(N / _BN) * math.ceil(M / rows)
    ng = K // KERNEL_GROUP
    splits = 1
    if tiles < 2 * sm_count:
        splits = min(ng, math.ceil(4 * sm_count / tiles))
    gps = math.ceil(ng / splits)
    return rows, math.ceil(ng / gps), gps


#: The wgmma bodies above 8 rows (K1 ``csrc/qmm_wgmma.cuh``, K9
#: ``qmm_wgmma_dq.cuh``, K11 / K11f ``qmm_wgmma_a8.cuh``): tokens per block,
#: and the blocks one SM holds at each width (``__launch_bounds__``)
WGMMA_TOKENS = (16, 32, 64, 128)
WGMMA_STAGES = 4  # K1's and K9's rings
A8_STAGES = 6     # K11's ring
#: K9's decode rows (M <= 8): one 8-token tile (m64n8k16) in a deeper ring
DQ_DECODE_TOKENS = 8
DQ_DECODE_STAGES = 6
DQ_MAX_SPLITS = 16  # the decode rows' K splits (their merge loads every split's partial at once)
DQ_FILL_STAGES = 1  # the plan's cost of a block beyond its stages: its ring's fill


def wgmma_blocks_per_sm(bt: int) -> int:
    return 2 if bt <= 32 else 1


def _ring_bytes(stage: int, stages: int) -> int:
    """A ring of ``stages`` stages of ``stage`` bytes rounded up to 1 KiB,
    its 2 x ``stages`` mbarriers and 1 KiB to align it (``Layout`` in the
    wgmma bodies)."""
    return stages * (-(-stage // 1024) * 1024) + 16 * stages + 1024


def wgmma_smem_bytes(bt: int) -> int:
    """Dynamic shared memory of one K1 wgmma block of ``bt`` tokens: a ring
    of 4 stages, each the activations, the packed words, scales and
    zeros_x_scales and the xsum (``csrc/qmm_wgmma.cuh``)."""
    return _ring_bytes(bt * KERNEL_GROUP * 2 + 16 * _BN * 4 + 2 * _BN * 4 + bt * 4, WGMMA_STAGES)


def dequant_stages(bt: int) -> int:
    """Stages of K9's ring: 6 at the decode rows' 8 tokens, 4 above."""
    return DQ_DECODE_STAGES if bt == DQ_DECODE_TOKENS else WGMMA_STAGES


def dequant_smem_bytes(bt: int, G: int) -> int:
    """Dynamic shared memory of one K9 wgmma block (``qmm_wgmma_dq.cuh``): a
    ring of ``dequant_stages(bt)`` stages of 128 depths, each the bf16
    activations, 16 rows of packed words and the 128 / G groups' scales and
    zeros_x_scales."""
    return _ring_bytes(bt * _KC * 2 + 16 * _BN * 4 + 2 * (_KC // G) * _BN * 4,
                       dequant_stages(bt))


def a8_smem_bytes(bt: int, G: int = KERNEL_GROUP) -> int:
    """Dynamic shared memory of one K11 / K11f block (``qmm_wgmma_a8.cuh``):
    a ring of 6 stages of 128 depths, each the int8 codes, 16 rows of packed
    words and the 128 / G groups' scales, zeros_x_scales and row sums."""
    cg = _KC // G
    return _ring_bytes(bt * _KC + 16 * _BN * 4 + 2 * cg * _BN * 4 + cg * bt * 4, A8_STAGES)


def wgmma_tokens(M: int) -> int:
    """Tokens per block of a wgmma body: the least of 16, 32, 64, 128 that
    holds M, 128 past it."""
    return next((b for b in WGMMA_TOKENS if M <= b), WGMMA_TOKENS[-1])


def wgmma_plan(M: int, chunks: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(tokens per block, K splits, chunks per split) of a wgmma body over
    ``chunks`` stages of K: 128 channels by ``wgmma_tokens(M)`` tokens; K is
    split only where the output tiles fill at most half the blocks the card
    holds at once, into as many slices as fill it. A second pass sums the
    splits in a fixed order."""
    bt = wgmma_tokens(M)
    tiles = math.ceil(N / _BN) * math.ceil(M / bt)
    slots = sm_count * wgmma_blocks_per_sm(bt)
    splits = 1 if 2 * tiles > slots else min(chunks, slots // tiles)
    per = math.ceil(chunks / splits)
    return bt, math.ceil(chunks / per), per


def launch_plan(M: int, K: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(rows per block, K splits, groups per split) for K1.

    Up to 8 rows, the CUDA-core decode body: one block covers 128 columns
    and 1, 2, 4 or 8 rows, and K is split over blocks so about four blocks
    per SM stream weights when the tiles cannot fill the card (two blocks
    per SM). Above 8 rows, the wgmma body's plan (``wgmma_plan``) over the
    K / 128 groups."""
    if M <= 8:
        return mma_launch_plan(M, K, N, sm_count)
    return wgmma_plan(M, K // KERNEL_GROUP, N, sm_count)


def dequant_decode_plan(chunks: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(8, K splits, chunks per split) of K9's decode rows (M <= 8): one
    8-token tile over ``chunks`` stages of K, the weight stream all the
    work. K is split over blocks so that the card fills: of the splits into
    whole slices of stages (at most ``DQ_MAX_SPLITS``), the one with the
    least waves (two blocks an SM) times stages a block, plus
    ``DQ_FILL_STAGES`` a block for its ring's fill; the fewest splits at a
    tie. The last block of a column tile to finish sums the splits in
    split order."""
    tiles = math.ceil(N / _BN)
    slots = sm_count * wgmma_blocks_per_sm(DQ_DECODE_TOKENS)
    best = None
    for want in range(1, min(chunks, DQ_MAX_SPLITS) + 1):
        per = math.ceil(chunks / want)
        splits = math.ceil(chunks / per)
        cost = math.ceil(tiles * splits / slots) * (per + DQ_FILL_STAGES)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return DQ_DECODE_TOKENS, best[1], best[2]


def dequant_launch_plan(M: int, K: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(tokens per block, K splits, chunks of 128 k per split) for K9's
    wgmma body: up to 8 rows ``dequant_decode_plan``, above 8
    ``wgmma_plan`` (a last partial chunk counts as one)."""
    chunks = math.ceil(K / _KC)
    if M <= DQ_DECODE_TOKENS:
        return dequant_decode_plan(chunks, N, sm_count)
    return wgmma_plan(M, chunks, N, sm_count)


def a8_plan(M: int, K: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """(tokens per block, K splits, chunks of 128 channels per split) for K11
    and K11f, one plan for both so that they sum every output in one order
    and agree bit for bit: the wgmma body's token width, and the split of K
    of ``mma_launch_plan`` at 64-row tiles (a last partial chunk counts)."""
    return (wgmma_tokens(M), *mma_launch_plan(M, math.ceil(K / _KC) * _KC, N, sm_count)[1:])


def pad_columns(
    qweight: torch.Tensor, scales: torch.Tensor, zeros_x_scales: torch.Tensor, multiple: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weight's N padded up to a multiple of ``multiple`` with zero
    words, scales and zeros_x_scales: the tensor copies of the wgmma bodies
    read 16-byte rows. A padded column's output is 0 and is sliced off."""
    pad = -qweight.shape[-1] % multiple
    if pad == 0:
        return qweight, scales, zeros_x_scales
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (qweight, scales, zeros_x_scales))


def quantized_matmul_cuda(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    norm_weight: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-6,
    glu: bool = False,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors. x: [M, K] ([M, 2K] with ``glu``) bf16;
    returns [M, N] bf16.

    ``norm_weight`` selects the RMSNorm prologue, ``glu`` the SiLU-GLU one;
    both take M <= 8 (the decode shapes the gates allow). Above 8 rows the
    wgmma body's tensor copies read 16-byte rows, so an N that is not a
    multiple of 4 is padded at the call (``pad_columns``; no shape the
    repo's models run has one) and the output sliced back."""
    if norm_weight is not None and glu:
        raise ValueError("one prologue at a time")
    prologue = "rmsnorm" if norm_weight is not None else "glu" if glu else None
    dev = x.device
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:  # the prefill path reads x in 16-byte chunks
        x = x.clone()
    M = x.shape[0]
    K = qweight.shape[0] * PACK
    N = qweight.shape[1]
    ng = K // KERNEL_GROUP
    check(x, "x", torch.bfloat16, (M, 2 * K if glu else K))
    check(qweight, "qweight", torch.int32)
    check(scales, "scales", torch.float32, (ng, N))
    check(zeros_x_scales, "zeros_x_scales", torch.float32, (ng, N))
    if prologue is not None and M > 8:
        raise ValueError(f"the {prologue} prologue takes at most 8 rows, got {M}")
    nw = None
    if norm_weight is not None:
        # the Pallas prologue reads the norm weight as bf16 (:801-803)
        nw = norm_weight.to(torch.bfloat16).contiguous()
        check(nw, "norm_weight", torch.bfloat16, (K,))
    N_out = N
    if M > 8 and N % 4:
        qweight, scales, zeros_x_scales = pad_columns(qweight, scales, zeros_x_scales)
        N = qweight.shape[1]
    rows, splits, gps = launch_plan(M, K, N, sm_count(dev.index))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    # one f32 scratch: the wgmma body's [K / 128, M rounded up to 4] group
    # sums of x (16-byte rows, first so that they stay aligned), [M] RMSNorm
    # statistics, [splits, M, N] partials
    n_xsum = ng * (-(-M // 4) * 4) if M > 8 else 0
    n_rstd = M if nw is not None else 0
    n_part = splits * M * N if splits > 1 else 0
    scratch = torch.empty(n_xsum + n_rstd + n_part, dtype=torch.float32, device=dev)
    xsum = scratch[:n_xsum] if n_xsum else None
    rstd = scratch[n_xsum:n_xsum + n_rstd] if n_rstd else None
    partial = scratch[n_xsum + n_rstd:] if n_part else None
    KERNEL.launch(
        "qtt_quantized_matmul", launch_key(prologue, M, K, N_out),
        x.data_ptr(), x.shape[1], qweight.data_ptr(), scales.data_ptr(),
        zeros_x_scales.data_ptr(), None if nw is None else nw.data_ptr(),
        float(norm_eps), _PROLOGUE[prologue], M, K, N, rows, splits, gps,
        None if rstd is None else rstd.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if xsum is None else xsum.data_ptr(),
        out.data_ptr(), stream_ptr(dev),
    )
    return out if N == N_out else out[:, :N_out].contiguous()


def dequant_launch_key(M: int, K: int, N: int, G: int) -> str:
    return f"M={M} K={K} N={N} G={G}"


def quantized_matmul_dequant_cuda(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int,
) -> torch.Tensor:
    """Launch K9 on CUDA tensors. x: [M, K] bf16; returns [M, N] bf16.

    Takes every shape with K % G == 0. The JAX package falls back to its
    jnp route where ``(K / G * G / 8) % 8 != 0`` or no K-step depth keeps
    the TPU's 8-sublane alignment (:731, :761-768): those are limits of
    the TPU's tiles, not of this kernel. The launch plan is
    ``dequant_launch_plan``'s: the wgmma body's 8 tokens a block up to 8
    rows, 16-128 above, and K split over blocks in chunks of 128 when the
    output tiles cannot fill the card (at 8 tokens the last block of a
    tile merges, counting on ``_DQ_COUNTERS``, made by an eager launch
    before any capture; one such launch at a time on a device). An N that
    is no multiple of 4 is padded at the call (``pad_columns``) for the
    tensor copies."""
    dev = x.device
    G = group_size
    if G not in DEQUANT_GROUPS:
        raise ValueError(f"K9 takes G in {DEQUANT_GROUPS}, got {G}")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:  # the prefill path reads x in 16-byte chunks
        x = x.clone()
    M, K = x.shape
    N = qweight.shape[1]
    if K % G:
        raise ValueError(f"K={K} is not a multiple of G={G}")
    check(qweight, "qweight", torch.int32, (K // PACK, N))
    check(scales, "scales", torch.float32, (K // G, N))
    check(zeros_x_scales, "zeros_x_scales", torch.float32, (K // G, N))
    N_out = N
    if N % 4:
        qweight, scales, zeros_x_scales = pad_columns(qweight, scales, zeros_x_scales)
        N = qweight.shape[1]
    rows, splits, cps = dequant_launch_plan(M, K, N, sm_count(dev.index))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    partial = (torch.empty(splits * M * N, dtype=torch.float32, device=dev)
               if splits > 1 else None)
    counters = (_DQ_COUNTERS.get(dev, math.ceil(N / _BN))
                if splits > 1 and rows == DQ_DECODE_TOKENS else None)
    KERNEL_DEQUANT.launch(
        "qtt_quantized_matmul_dequant", dequant_launch_key(M, K, N_out, G),
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros_x_scales.data_ptr(),
        M, K, N, G, rows, splits, cps,
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(), stream_ptr(dev),
    )
    return out if N == N_out else out[:, :N_out].contiguous()


def a8_launch_key(M: int, K: int, N: int, G: int, fused: bool) -> str:
    key = f"{'fused ' if fused else ''}M={M} K={K} N={N}"
    return key if G == KERNEL_GROUP else f"{key} G={G}"


def launch_a8(
    x: torch.Tensor,
    sx: Optional[torch.Tensor],
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int = KERNEL_GROUP,
) -> torch.Tensor:
    """Launch K11 on int8 codes x [M, K] with row scales sx [M, 1], or K11f
    on bf16 x [M, K] with ``sx=None`` (G = 128 only); returns [M, N] bf16.
    Both run the int8 wgmma body with ``a8_plan``'s plan after a first
    kernel: K11's sums each group's codes into scratch, K11f's quantizes
    each row once into scratch (the int8 codes and the groups' row sums)
    and writes the row scales into ``sx`` for the split-K pass. An N that
    is no multiple of 4 is padded at the call (``pad_columns``)."""
    dev = x.device
    G = group_size
    fused = sx is None
    M, K = x.shape
    N = qweight.shape[1]
    if G not in A8_GROUPS or K % G or (fused and G != KERNEL_GROUP):
        raise ValueError(f"K11 takes G in {A8_GROUPS} with K % G == 0, K11f G = 128: "
                         f"G={G} K={K} fused={fused}")
    x = x.contiguous()
    check(x, "x", torch.bfloat16 if fused else torch.int8, (M, K))
    if x.data_ptr() % 16:  # rows are read in 16-byte chunks and tensor copies
        x = x.clone()
    if fused:
        sx = torch.empty(M, dtype=torch.float32, device=dev)  # K11f writes it
    sx = sx.reshape(M).contiguous()
    check(sx, "sx", torch.float32, (M,))
    check(qweight, "qweight", torch.int32, (K // PACK, N))
    check(scales, "scales", torch.float32, (K // G, N))
    check(zeros_x_scales, "zeros_x_scales", torch.float32, (K // G, N))
    N_out = N
    if N % 4:
        qweight, scales, zeros_x_scales = pad_columns(qweight, scales, zeros_x_scales)
        N = qweight.shape[1]
    rows, splits, cps = a8_plan(M, K, N, sm_count(dev.index))
    # K11f: the int8 codes [M, K] first; both: the f32 row sums [K / G, M
    # rounded up to 4], 16-byte aligned
    scratch = torch.empty((M * K if fused else 0) + (K // G) * (-(-M // 4) * 4) * 4,
                          dtype=torch.uint8, device=dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    partial = (torch.empty(splits * M * N, dtype=torch.float32, device=dev)
               if splits > 1 else None)
    KERNEL_A8.launch(
        "qtt_quantized_matmul_a8", a8_launch_key(M, K, N_out, G, fused),
        x.data_ptr(), sx.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        zeros_x_scales.data_ptr(), int(fused), M, K, N, G, rows, splits, cps,
        scratch.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
        stream_ptr(dev),
    )
    return out if N == N_out else out[:, :N_out].contiguous()


def _quantized_matmul_2d_a8(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """W4A8 x [M, K] -> [M, N] (``_quantized_matmul_2d_a8`` :394): K11, or
    K11f under ``QUICK_TPU_A8_FUSED=1`` at G = 128, on CUDA tensors; the
    plain version on CPU tensors. At G = 64 / 32 the JAX package takes its
    jnp form with external quantization even with the fused switch set
    (:415), and so K11 takes them here."""
    if x.device.type != "cuda":
        return quantized_matmul_a8_plain(
            x, qweight, scales, zeros_x_scales, group_size, out_dtype)
    if out_dtype != torch.bfloat16:
        raise NotImplementedError(f"K11 writes bf16, not {out_dtype}")
    if group_size not in A8_GROUPS:
        raise NotImplementedError(
            f"group_size={group_size}: the card's W4A8 kernel takes G in {A8_GROUPS}; "
            "other groups — ROADMAP B11")
    if group_size == KERNEL_GROUP and a8_fused_quant():  # K11f quantizes in the kernel
        return launch_a8(x.to(torch.bfloat16), None, qweight, scales, zeros_x_scales)
    xq, sx = quantize_activations(x)
    return launch_a8(xq, sx, qweight, scales, zeros_x_scales, group_size)


def _quantized_matmul_2d(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int,
    out_dtype: torch.dtype,
    norm_weight: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-6,
    glu: bool = False,
) -> torch.Tensor:
    """x [M, K] @ dequant(qweight) [K, N] -> [M, N] (``_quantized_matmul_2d``
    :692): a kernel on CUDA tensors (K1 at G = 128, K9 at G = 32 or 64,
    after the prologues as the JAX small-group branch applies them,
    :721-730), the plain version on CPU tensors."""
    cuda = x.device.type == "cuda"
    if not cuda or group_size != KERNEL_GROUP:
        if glu:
            x = glu_plain(x)
        if norm_weight is not None:
            x = rms_norm(x, norm_weight, norm_eps)
    if not cuda:
        return quantized_matmul_plain(
            x, qweight, scales, zeros_x_scales, group_size, out_dtype
        )
    if out_dtype != torch.bfloat16:
        raise NotImplementedError(f"K1 and K9 write bf16, not {out_dtype}")
    if group_size in DEQUANT_GROUPS:
        return quantized_matmul_dequant_cuda(x, qweight, scales, zeros_x_scales, group_size)
    if group_size != KERNEL_GROUP:
        raise NotImplementedError(
            f"group_size={group_size}: the card's W4A16 kernels take G = 128 (K1) "
            f"and G in {DEQUANT_GROUPS} (K9); other groups — ROADMAP B11"
        )
    return quantized_matmul_cuda(
        x, qweight, scales, zeros_x_scales,
        norm_weight=norm_weight, norm_eps=norm_eps, glu=glu,
    )


def quantized_matmul(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    group_size: int = 128,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    a8: bool = False,
    fuse_norm: Optional[tuple] = None,
    fuse_glu: bool = False,
) -> torch.Tensor:
    """Public W4A16 (or W4A8 with ``a8``) matmul over arbitrary leading dims
    (``quantized_matmul`` :966). x: [..., K] ([..., 2K] raw gate_up with
    ``fuse_glu``); qweight: QTPU int32 [K // 8, N]; scales / zeros_x_scales:
    f32 [K // G, N].

    ``fuse_norm = (rms_weight [K], eps)``: x is the raw residual and the
    RMSNorm runs in the kernel's prologue; ``fuse_glu``: silu(gate) * up
    runs there. Rows > 8, G != 128 or ``a8`` apply them first. ``a8`` takes
    the W4A8 route above 96 flattened rows; fewer rows stay W4A16."""
    if out_dtype is None:
        out_dtype = x.dtype if x.dtype != torch.float32 else torch.bfloat16
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if fuse_glu and (x2.shape[0] > 8 or a8 or group_size != 128):
        x2 = glu_plain(x2)
        fuse_glu = False
    if fuse_norm is not None and (x2.shape[0] > 8 or a8):
        x2 = rms_norm(x2, fuse_norm[0], fuse_norm[1])
        fuse_norm = None
    if a8 and x2.shape[0] >= A8_MIN_ROWS:
        y = _quantized_matmul_2d_a8(
            x2, qweight, scales, zeros_x_scales, group_size, out_dtype)
    else:
        y = _quantized_matmul_2d(
            x2, qweight, scales, zeros_x_scales, group_size, out_dtype,
            norm_weight=None if fuse_norm is None else fuse_norm[0],
            norm_eps=1e-6 if fuse_norm is None else float(fuse_norm[1]),
            glu=fuse_glu,
        )
    y = y.reshape(*lead, y.shape[-1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
