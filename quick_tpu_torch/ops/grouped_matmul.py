"""Grouped (ragged) W4A16 and W4A8 GEMMs for MoE experts: CUDA kernels K8
and K12, their plain versions and the expert-sorted routing layout.

Port of ``quick_tpu/ops/grouped_matmul.py``. The routed (token, expert)
pairs are sorted by expert and each expert's segment is padded to a
``bm``-row tile (``build_routing``); ``quantized_matmul_grouped`` then
computes every tile against its own expert's packed weights, read from
``tile_expert`` on the device, so compute and weight traffic scale with the
routed tokens and not with E x T. Dead tiles (past the last routed segment)
are written as zeros. On CUDA tensors the work goes to the hand-written
kernel ``csrc/grouped_matmul.cu`` (K8) at G = 128, 64 or 32; on CPU tensors
to the plain version, which follows ``_grouped_fallback`` (:146): per-group
integer dots of the bf16 activations summed in f32, scaled on the output
side, minus ``xsum @ (z * s)``. The JAX package runs G = 128 on its Pallas
kernel and smaller groups on that fallback; K8 computes the same
output-side form at every G.

K8's blocks are (column tile, expert, K slice): each finds its expert's
live tiles on the card and streams the expert's weights once per pass of
up to ``GROUPED_PASS_ROWS[bm]`` rows (``grouped_passes`` models the scan);
``grouped_plan`` splits K, from the shapes alone, where the blocks cannot
fill the card.

Routing never reads a device value back to the host: the row budget ``Mp``
is static from (T, topk, E, bm), and expert counts and ranks come from a
cumulative sum over a [T * topk, E] one-hot (not ``bincount``, which reads
its maximum back); that, ``searchsorted`` and the scatters stay on the
device.

W4A8 (``a8=True``, which ``_grouped_moe`` sets from ``QUICK_TPU_MOE_A8``):
the rows are quantized per row to int8 (``quantize_activations``) and every
tile's per-group dots run int8 x int8 -> int32, with the row scale applied
to the f32 sum before the one bf16 rounding: ``csrc/grouped_matmul_a8.cu``
(K12, ``_make_grouped_kernel_a8``) on CUDA tensors, the plain version of
``_grouped_fallback(a8=True)`` (:146-200) on CPU tensors. K12 runs K8's
skeleton (``csrc/grouped_wgmma.cuh``: the same blocks, tile scan, passes
and ``grouped_plan``) with K11's int8 body; a tile height other than 32,
64 or 128 goes to it as sub-tiles (``grouped_a8_tiles``), and
``quantized_matmul_grouped_a8_split_plain`` models its arithmetic on its
split plan. As in the JAX package (:233), ``a8`` falls back to W4A16 where
G != 128 or bm % 32 != 0 (on the card that bm is then refused by K8 too).

``QUICK_TPU_MOE_BM`` (read at every call) overrides ``pick_grouped_bm`` as
in the JAX package (:307-309); on the card a bm that K8 (32, 64 or 128) or
K12 (a multiple of 32) cannot take raises an error naming the switch.
"""
from __future__ import annotations

from typing import Tuple

import math
import os

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, i32, ptr, sm_count, stream_ptr
from quick_tpu_torch.ops.quantized_matmul import (
    KERNEL_GROUP,
    pad_columns,
    quantize_activations,
    quantized_matmul_a8_plain,
    quantized_matmul_plain,
)
from quick_tpu_torch.quantize.packing import PACK, unpack_qtpu_tensor

#: K8. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "grouped_matmul.cu",
    {"qtt_grouped_matmul": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                            i32, i32, ptr, ptr]},
)
#: K12, the grouped W4A8 GEMM (``_make_grouped_kernel_a8``).
KERNEL_A8 = CudaKernel(
    "grouped_matmul_a8.cu",
    {"qtt_grouped_matmul_a8": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                               i32, i32, i32, ptr, ptr]},
)
GROUPS = (128, 64, 32)  # the group sizes K8 is built for
#: K8's pass of one block, by tile height: the rows whose activations share
#: one stream of the expert's weights (two blocks an SM at 64, one at 128)
GROUPED_PASS_ROWS = {32: 64, 64: 64, 128: 128}
#: K8's shortest K split, in stages of 128: shorter slices lose more to
#: their partials and the reduce than they gain in blocks (Qwen1.5-MoE's
#: decode down, K = 1408, is faster whole; PERF.md §6, kernel_ablate.py's
#: ``short_splits``)
MIN_SPLIT_STAGES = 16
BM_SWITCH = "QUICK_TPU_MOE_BM"


def pick_grouped_bm(tk: int, n_experts: int) -> int:
    """m-tile height from the average routed rows per expert
    (``pick_grouped_bm`` :301); ``QUICK_TPU_MOE_BM`` overrides it, as in
    the JAX package (:307-309)."""
    v = os.environ.get(BM_SWITCH, "")
    if v:
        return int(v)
    avg = tk / max(n_experts, 1)
    if avg <= 48:
        return 32
    if avg <= 96:
        return 64
    return 128


def grouped_row_budget(tk: int, n_experts: int, bm: int) -> int:
    """Static worst-case rows of the expert-sorted buffer: every expert's
    segment rounds up to bm, and at most min(tk, E) experts have tokens
    (``grouped_row_budget`` :322)."""
    worst = min(tk + n_experts * (bm - 1), tk * bm)
    return max((worst + bm - 1) // bm * bm, bm)


def grouped_plan(E: int, n_tiles: int, K: int, N: int, bm: int, sms: int) -> Tuple[int, int]:
    """(splits, stages per split) of K8's K, in stages of 128 channels. A
    block is (128-channel column tile, expert, split); at most min(E,
    n_tiles) experts have a live tile. Where those blocks fill fewer than
    twice the blocks the card holds at once (two an SM at 64-row passes,
    one at 128), K is split into as many slices as reach that, each of at
    least MIN_SPLIT_STAGES stages. From the shapes alone, never from the
    routing; a last kernel sums the splits' f32 partials in split order."""
    nst = math.ceil(K / 128)
    blocks = math.ceil(N / 128) * min(E, n_tiles)
    slots = 2 * sms * (2 if GROUPED_PASS_ROWS[bm] == 64 else 1)
    splits = 1
    if blocks < slots:
        splits = max(1, min(nst // MIN_SPLIT_STAGES, math.ceil(slots / blocks)))
    per = math.ceil(nst / splits)
    return math.ceil(nst / per), per


def grouped_passes(tile_expert, tile_live, E: int, bm: int) -> dict:
    """Plain model of K8's tile scan: {expert: [pass, ...]}, each pass the
    expert's next live tiles in tile order, at most GROUPED_PASS_ROWS[bm] //
    bm of them; and under key -1 {expert: [dead tile, ...]}, the dead tiles
    i that the blocks of expert i % E write as zeros."""
    te, live = [int(v) for v in tile_expert], [int(v) for v in tile_live]
    per = GROUPED_PASS_ROWS[bm] // bm
    out: dict = {-1: {}}
    for e in range(E):
        mine = [i for i, (x, lv) in enumerate(zip(te, live)) if lv and x == e]
        if mine:
            out[e] = [mine[j:j + per] for j in range(0, len(mine), per)]
        dead = [i for i in range(e, len(te), E) if not live[i]]
        if dead:
            out[-1][e] = dead
    return out


def check_grouped_bm(bm: int, a8: bool = False) -> None:
    """Refuse, on the card, a bm the kernel cannot take: K8 takes 32, 64 or
    128, K12 a multiple of 32. The error names QUICK_TPU_MOE_BM, the only
    way to reach such a bm."""
    ok = bm % 32 == 0 and bm > 0 if a8 else bm in GROUPED_PASS_ROWS
    if not ok:
        takes = "a multiple of 32" if a8 else "32, 64 or 128"
        raise ValueError(f"{'K12' if a8 else 'K8'} takes bm {takes}, got bm={bm} "
                         f"({BM_SWITCH}={os.environ.get(BM_SWITCH, '')!r})")


def build_routing(
    sel: torch.Tensor, n_experts: int, bm: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert-sort the (token, slot) pairs of ``sel`` [T, kk] into bm-row
    per-expert segments (``build_routing`` :330). Returns, on sel's device:
    tok_rows [Mp] int32 (source token of each sorted row), pos [T, kk]
    int32 (sorted row of each pair), tile_expert [Mp // bm] int32,
    tile_live [Mp // bm] int32 (0 past the last routed segment) and valid
    [Mp] bool. Padding rows gather token 0 and are never read back."""
    T, kk = sel.shape
    TK = T * kk
    Mp = grouped_row_budget(TK, n_experts, bm)
    dev = sel.device
    e_flat = sel.reshape(TK).to(torch.int64)
    pair = torch.arange(TK, device=dev)
    if TK <= n_experts:
        # decode-sized batches: each pair owns its own tile (Mp == TK * bm),
        # no sort; only row 0 of a tile is read back
        rows = torch.arange(Mp, dtype=torch.int32, device=dev)
        return ((rows // (bm * kk)), (pair * bm).to(torch.int32).reshape(T, kk),
                e_flat.to(torch.int32), torch.ones(TK, dtype=torch.int32, device=dev),
                rows % bm == 0)
    # a pair's row is its expert's segment base plus its rank among the
    # expert's pairs in pair order: the order of the JAX package's sort on
    # the unique key expert * TK + pair, without a sort
    onehot = (e_flat[:, None] == torch.arange(n_experts, device=dev)).to(torch.int64)
    seen = torch.cumsum(onehot, 0)  # [TK, E] pairs so far of each expert
    counts = seen[-1]
    rank = torch.gather(seen, 1, e_flat[:, None])[:, 0] - 1
    padc = (counts + bm - 1) // bm * bm
    cum = torch.cumsum(padc, 0)
    dest = (cum - padc)[e_flat] + rank  # [TK] rows, all < Mp
    tok_rows = torch.zeros(Mp, dtype=torch.int32, device=dev).scatter_(
        0, dest, (pair // kk).to(torch.int32))
    valid = torch.zeros(Mp, dtype=torch.bool, device=dev).index_fill_(0, dest, True)
    tile_starts = torch.arange(0, Mp, bm, device=dev)
    tile_expert = torch.clamp(
        torch.searchsorted(cum, tile_starts, right=True), max=n_experts - 1
    ).to(torch.int32)
    tile_live = (tile_starts < cum[-1]).to(torch.int32)
    return tok_rows, dest.to(torch.int32).reshape(T, kk), tile_expert, tile_live, valid


def quantized_matmul_grouped_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
    group_size: int = 128,
) -> torch.Tensor:
    """Plain version of K8: each live tile's rows times its expert's
    weights by K1's plain version (f32 out), dead tiles zero. Reads the
    tile layout back to the host: it serves the CPU and the comparisons on
    the card, never the card's main path."""
    Mp = x.shape[0]
    N = qweight.shape[-1]
    out = torch.zeros((Mp, N), dtype=torch.float32, device=x.device)
    tiles = torch.arange(Mp // bm, device=x.device)
    te, live = tile_expert.tolist(), tile_live.tolist()
    for e in sorted({int(t) for t, lv in zip(te, live) if lv}):
        mine = tiles[(tile_expert == e) & (tile_live != 0)]
        rows = (mine[:, None] * bm + torch.arange(bm, device=x.device)).reshape(-1)
        out[rows] = quantized_matmul_plain(
            x[rows], qweight[e], scales[e], zeros_x_scales[e], group_size, torch.float32)
    return out.to(torch.bfloat16)


def quantized_matmul_grouped_a8_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
) -> torch.Tensor:
    """Plain version of K12 (``_grouped_fallback(a8=True)`` :146-200): each
    expert's live rows through K11's plain version (the rows are quantized
    one by one, so its codes and scales are the whole buffer's), kept in
    f32 until the one bf16 rounding; dead tiles zero. Reads the tile layout
    back to the host: it serves the CPU and the comparisons on the card,
    never the card's main path."""
    Mp = x.shape[0]
    out = torch.zeros((Mp, qweight.shape[-1]), dtype=torch.float32, device=x.device)
    tiles = torch.arange(Mp // bm, device=x.device)
    te, live = tile_expert.tolist(), tile_live.tolist()
    for e in sorted({int(t) for t, lv in zip(te, live) if lv}):
        mine = tiles[(tile_expert == e) & (tile_live != 0)]
        rows = (mine[:, None] * bm + torch.arange(bm, device=x.device)).reshape(-1)
        out[rows] = quantized_matmul_a8_plain(x[rows], qweight[e], scales[e],
                                              zeros_x_scales[e], KERNEL_GROUP, torch.float32)
    return out.to(torch.bfloat16)


def grouped_a8_tiles(
    tile_expert: torch.Tensor, tile_live: torch.Tensor, bm: int,
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """K12's tile height and tile layout: bm's own where K8's skeleton
    takes it (32, 64 or 128 rows), else each bm-row tile cut into u-row
    sub-tiles (u = 128, 64 or 32, the largest that divides bm), each
    carrying its tile's expert and live flag, so that any multiple of 32
    (``QUICK_TPU_MOE_BM``) runs in the skeleton's passes. Device ops only
    (no read-back), capturable."""
    if bm in GROUPED_PASS_ROWS:
        return bm, tile_expert, tile_live
    u = next(h for h in (128, 64, 32) if bm % h == 0)
    r = bm // u
    return (u, tile_expert[:, None].expand(-1, r).reshape(-1),
            tile_live[:, None].expand(-1, r).reshape(-1))


def quantized_matmul_grouped_a8_split_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
    splits: int,
    cps: int,
) -> torch.Tensor:
    """Plain model of K12's arithmetic on its split plan (``grouped_plan``:
    ``splits`` slices of ``cps`` groups of 128): the rows quantized by
    ``quantize_activations``; per live tile and split, each group's exact
    integer dot folded in order as acc += f32(dot) * s - rowsum * zs in
    f32; the splits' partials summed in split order, times the row scale,
    rounded once to bf16; dead tiles zero. Reads the tile layout back to
    the host: it serves the tests, never the card's main path."""
    Mp, K = x.shape
    G = KERNEL_GROUP
    ng = K // G
    xq, sx = quantize_activations(x)
    xg = xq.to(torch.float32).reshape(Mp, ng, G)
    rowsum = xg.sum(-1)  # [Mp, ng], exact
    out = torch.zeros((Mp, qweight.shape[-1]), dtype=torch.float32, device=x.device)
    te, live = tile_expert.tolist(), tile_live.tolist()
    for i, (e, lv) in enumerate(zip(te, live)):
        if not lv:
            continue
        rows = slice(i * bm, (i + 1) * bm)
        codes = unpack_qtpu_tensor(qweight[e], G).to(torch.float32).reshape(ng, G, -1)
        total = torch.zeros_like(out[rows])
        for z in range(splits):
            acc = torch.zeros_like(total)
            for g in range(z * cps, min(ng, (z + 1) * cps)):
                dot = xg[rows, g] @ codes[g]  # exact: below 2^24
                acc = acc + (dot * scales[e, g] - rowsum[rows, g, None] * zeros_x_scales[e, g])
            total = total + acc
        out[rows] = total * sx[rows]
    return out.to(torch.bfloat16)


def launch_grouped_a8(
    xq: torch.Tensor,
    sx: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
) -> torch.Tensor:
    """Launch K12: xq [Mp, K] int8 codes of the expert-sorted rows, sx
    [Mp, 1] f32 row scales, qweight int32 [E, K // 8, N], scales /
    zeros_x_scales f32 [E, K // 128, N], tile_expert / tile_live int32
    [Mp // bm]; returns [Mp, N] bf16. G = 128, bm % 32 == 0 (heights other
    than 32, 64 and 128 as sub-tiles, ``grouped_a8_tiles``); K split by
    ``grouped_plan``. One launch counts the row-sum kernel, the body and
    the split reduce. An N that is no multiple of 4 is padded at the call
    (``pad_columns``)."""
    dev = xq.device
    Mp, K = xq.shape
    E, _, N = qweight.shape
    G = KERNEL_GROUP
    check_grouped_bm(bm, a8=True)
    if Mp % bm or K % G:
        raise ValueError(f"K12 takes Mp % bm == 0, K % 128 == 0: bm={bm} Mp={Mp} K={K}")
    xq = xq.contiguous()
    if xq.data_ptr() % 16:  # rows are read in 16-byte chunks and tensor copies
        xq = xq.clone()
    sx = sx.reshape(Mp).contiguous()
    check(xq, "xq", torch.int8, (Mp, K))
    check(sx, "sx", torch.float32, (Mp,))
    check(qweight, "qweight", torch.int32, (E, K // PACK, N))
    check(scales, "scales", torch.float32, (E, K // G, N))
    check(zeros_x_scales, "zeros_x_scales", torch.float32, (E, K // G, N))
    check(tile_expert, "tile_expert", torch.int32, (Mp // bm,))
    check(tile_live, "tile_live", torch.int32, (Mp // bm,))
    N_out = N
    if N % 4:
        qweight, scales, zeros_x_scales = pad_columns(qweight, scales, zeros_x_scales)
        N = qweight.shape[-1]
    if any(t.data_ptr() % 16 for t in (qweight, scales, zeros_x_scales)):
        qweight, scales, zeros_x_scales = (t.clone() for t in (qweight, scales, zeros_x_scales))
    u, te, live = grouped_a8_tiles(tile_expert, tile_live, bm)
    splits, cps = grouped_plan(E, Mp // u, K, N, u, sm_count(dev.index))
    # one f32 scratch: the [K / 128, Mp rounded up to 4] row sums of the
    # codes (16-byte rows, first), then the [splits, Mp, N] partials
    n_rs = K // G * (-(-Mp // 4) * 4)
    n_part = splits * Mp * N if splits > 1 else 0
    scratch = torch.empty(n_rs + n_part, dtype=torch.float32, device=dev)
    out = torch.empty((Mp, N), dtype=torch.bfloat16, device=dev)
    KERNEL_A8.launch(
        "qtt_grouped_matmul_a8", launch_key(Mp, K, N_out, E, bm),
        xq.data_ptr(), sx.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
        zeros_x_scales.data_ptr(), te.data_ptr(), live.data_ptr(), scratch.data_ptr(),
        scratch[n_rs:].data_ptr() if n_part else None, Mp, K, N, E, u, splits, cps,
        out.data_ptr(), stream_ptr(dev),
    )
    return out if N == N_out else out[:, :N_out].contiguous()


def launch_key(Mp: int, K: int, N: int, E: int, bm: int, G: int = KERNEL_GROUP) -> str:
    key = f"Mp={Mp} K={K} N={N} E={E} bm={bm}"
    return key if G == KERNEL_GROUP else f"{key} G={G}"


def quantized_matmul_grouped_cuda(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
    group_size: int = KERNEL_GROUP,
) -> torch.Tensor:
    """Launch K8 on CUDA tensors: x [Mp, K] bf16 expert-sorted rows,
    qweight int32 [E, K // 8, N], scales / zeros_x_scales f32
    [E, K // G, N], tile_expert / tile_live int32 [Mp // bm]; returns
    [Mp, N] bf16. G is 128, 64 or 32; bm 32, 64 or 128 (``pick_grouped_bm``'s
    choices). An N that is no multiple of 4 is padded at the call
    (``pad_columns``) for the tensor copies and the output sliced back."""
    dev = x.device
    G = group_size
    check_grouped_bm(bm)
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:  # the tensor copies read 16-byte aligned rows
        x = x.clone()
    Mp, K = x.shape
    E, _, N = qweight.shape
    ng = K // G
    if G not in GROUPS or Mp % bm or K % G:
        raise ValueError(f"K8 takes G in {GROUPS}, Mp % bm == 0, K % G == 0: "
                         f"G={G} bm={bm} Mp={Mp} K={K}")
    check(qweight, "qweight", torch.int32, (E, K // PACK, N))
    check(scales, "scales", torch.float32, (E, ng, N))
    check(zeros_x_scales, "zeros_x_scales", torch.float32, (E, ng, N))
    check(tile_expert, "tile_expert", torch.int32, (Mp // bm,))
    check(tile_live, "tile_live", torch.int32, (Mp // bm,))
    N_out = N
    if N % 4:
        qweight, scales, zeros_x_scales = pad_columns(qweight, scales, zeros_x_scales)
        N = qweight.shape[-1]
    if any(t.data_ptr() % 16 for t in (qweight, scales, zeros_x_scales)):
        qweight, scales, zeros_x_scales = (t.clone() for t in (qweight, scales, zeros_x_scales))
    splits, cps = grouped_plan(E, Mp // bm, K, N, bm, sm_count(dev.index))
    # one f32 scratch: the [K / G, Mp rounded up to 4] group sums of x
    # (16-byte rows, first), then the [splits, Mp, N] partials
    n_xsum = ng * (-(-Mp // 4) * 4)
    n_part = splits * Mp * N if splits > 1 else 0
    scratch = torch.empty(n_xsum + n_part, dtype=torch.float32, device=dev)
    out = torch.empty((Mp, N), dtype=torch.bfloat16, device=dev)
    KERNEL.launch(
        "qtt_grouped_matmul", launch_key(Mp, K, N_out, E, bm, G),
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros_x_scales.data_ptr(),
        tile_expert.data_ptr(), tile_live.data_ptr(), scratch.data_ptr(),
        scratch[n_xsum:].data_ptr() if n_part else None, Mp, K, N, E, bm, G, splits, cps,
        out.data_ptr(), stream_ptr(dev),
    )
    return out if N == N_out else out[:, :N_out].contiguous()


def quantized_matmul_grouped(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros_x_scales: torch.Tensor,
    tile_expert: torch.Tensor,
    tile_live: torch.Tensor,
    bm: int,
    group_size: int = 128,
    a8: bool = False,
) -> torch.Tensor:
    """Ragged multi-expert ``x @ dequant(qweight[e])`` -> [Mp, N] bf16,
    rows ``i*bm:(i+1)*bm`` with expert ``tile_expert[i]``, zeros where
    ``tile_live[i] == 0`` (``quantized_matmul_grouped`` :205): K8 (K12
    under ``a8``) on CUDA tensors, the plain versions on CPU tensors.
    ``a8`` at G != 128 or bm % 32 != 0 falls back to W4A16 (:233); on the
    card a bm K8 cannot take raises (``check_grouped_bm``)."""
    if a8 and (group_size != KERNEL_GROUP or bm % 32):
        a8 = False
    if a8:
        if x.device.type != "cuda":
            return quantized_matmul_grouped_a8_plain(
                x, qweight, scales, zeros_x_scales, tile_expert, tile_live, bm)
        xq, sx = quantize_activations(x)
        return launch_grouped_a8(xq, sx, qweight, scales, zeros_x_scales,
                                 tile_expert.to(torch.int32), tile_live.to(torch.int32), bm)
    if x.device.type != "cuda":
        return quantized_matmul_grouped_plain(
            x, qweight, scales, zeros_x_scales, tile_expert, tile_live, bm, group_size)
    if group_size not in GROUPS:
        raise NotImplementedError(
            f"group_size={group_size}: K8 takes G in {GROUPS}; other groups — ROADMAP B11")
    return quantized_matmul_grouped_cuda(
        x, qweight, scales, zeros_x_scales, tile_expert.to(torch.int32),
        tile_live.to(torch.int32), bm, group_size)
