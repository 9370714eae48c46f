"""The decode layer tail: CUDA kernel K14 and its plain version.

Port of ``quick_tpu/ops/fused_layer_tail.py::fused_layer_tail`` (:198): for
M <= 8 rows, the o projection, the residual add, the MLP RMSNorm, the
gate_up projection, SiLU * up, the down projection and the second residual
add of a llama-family layer, all three projections G = 128 QTPU linears.
Its cast points are the Pallas kernel's, not the unfused chain's: the norm
weight is rounded to bf16 (:229-231) and SiLU * up is computed in f32 and
rounded once (:166-168).

CUDA tensors go to ``csrc/fused_layer_tail.cu`` (one launch, K14); CPU
tensors to ``fused_layer_tail_plain``, which also sums each GEMM's groups
in the Pallas kernel's order (per K step of ``gpb`` groups a partial sum,
added to the accumulator), so the CPU path agrees with the JAX package's
interpret mode to the last bits the f32 sums leave.

K14 runs each GEMM as (128-column tile, K split) items on a persistent grid
of resident blocks (``tail_plan``; ``block_items`` lists a block's work,
``ring_events`` its one weight stream through the grid barriers, as the
kernel runs them); ``fused_layer_tail_split_plain`` models its sum order
(each group folded in turn within a split, the splits summed in split
order) for the CPU tests.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, stream_ptr,
)
from quick_tpu_torch.quantize.packing import PACK, unpack_qtpu_tensor

#: K14. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "fused_layer_tail.cu",
    {"qtt_fused_layer_tail": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
    ], "qtt_fused_layer_tail_resident": []},
)
G = 128
MAX_ROWS = 8
_BN = 128  # output columns per item (csrc/qmm_decode_rows.cuh kBN)
RING_STAGES = 8  # the weight ring's stages (csrc/qmm_decode_rows.cuh kStages)
MAX_ITEMS = 32  # a block's items over the three GEMMs (csrc/fused_layer_tail.cu kMaxItems)
_SYNC = ZeroedWords("K14")  # its barrier and tile counters, zero between launches


def _tail_tiles(N: int, ng: int, max_lanes: int) -> Tuple[int, int]:
    """The Pallas kernel's (bn, gpb) of one phase (``_tail_tiles`` :47):
    fewest steps, then fewest K steps, then larger bn. Only ``gpb``, the
    groups summed into one partial before it is added to the accumulator,
    shapes the numbers."""
    best = None
    for bn in range(128, min(N, 4096) + 1, 128):
        if N % bn:
            continue
        gpb = 1
        for cand in range(2, min(ng, 64) + 1):
            if ng % cand or cand * bn > max_lanes:
                continue
            gpb = cand
        key = ((N // bn) * (ng // gpb), ng // gpb, -bn)
        if best is None or key < best[0]:
            best = (key, bn, gpb)
    return best[1], best[2]


def _gemm_plain(x: torch.Tensor, qweight, scales, zeros_x_scales, gpb: int) -> torch.Tensor:
    """f32 [M, N] accumulator of one phase: per group the bf16 activations
    times the codes summed in f32, ``y * s - xsum * zs``; the groups of one
    K step summed from zero, each step's sum added to the accumulator
    (``group_dot`` :85-95)."""
    M, K = x.shape
    ng, N = K // G, qweight.shape[1]
    codes = unpack_qtpu_tensor(qweight, G).to(torch.float32).reshape(ng, G, N)
    xg = x.to(torch.bfloat16).to(torch.float32).reshape(M, ng, G).transpose(0, 1)  # [ng, M, G]
    y = torch.bmm(xg, codes)  # [ng, M, N]
    xsum = xg.sum(-1, keepdim=True)  # [ng, M, 1]
    terms = y * scales.to(torch.float32)[:, None, :] - xsum * zeros_x_scales.to(torch.float32)[:, None, :]
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for k0 in range(0, ng, gpb):
        part = torch.zeros_like(acc)
        for g in range(k0, k0 + gpb):
            part = part + terms[g]
        acc = acc + part
    return acc


def fused_layer_tail_plain(
    attn_out, x_resid, norm_w, o_qw, o_s, o_zs, gu_qw, gu_s, gu_zs, dn_qw, dn_s, dn_zs,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version of K14; returns y [M, D] bf16."""
    K1 = attn_out.shape[-1]
    D, N2 = o_qw.shape[1], gu_qw.shape[1]
    K3 = dn_qw.shape[0] * PACK
    gpb1 = _tail_tiles(D, K1 // G, 16384)[1]
    gpb2 = _tail_tiles(N2, D // G, 32768)[1]
    gpb3 = _tail_tiles(D, K3 // G, 32768)[1]
    bf = torch.bfloat16
    h = _gemm_plain(attn_out, o_qw, o_s, o_zs, gpb1).to(bf) + x_resid.to(bf)
    hf = h.to(torch.float32)
    ms = (hf * hf).mean(dim=-1, keepdim=True)
    nw = norm_w.to(bf).to(torch.float32)
    xn = (hf * torch.rsqrt(ms + eps) * nw).to(bf)
    gu = _gemm_plain(xn, gu_qw, gu_s, gu_zs, gpb2).to(bf)
    g = gu[:, :K3].to(torch.float32)
    u = gu[:, K3:].to(torch.float32)
    x2 = (g * torch.sigmoid(g) * u).to(bf)
    return (_gemm_plain(x2, dn_qw, dn_s, dn_zs, gpb3).to(bf) + h).to(bf)


def launch_key(M: int, K1: int, D: int, I: int) -> str:
    return f"M={M} K1={K1} D={D} I={I}"


#: an item's fixed cost in weight stages: its first B tile staged with no
#: MMAs under it, its partials written, one atomic round trip and the
#: last block's merge
ITEM_STAGES = 4


def split_plan(tiles: int, ng: int, grid: int) -> Tuple[int, int]:
    """(splits, groups per split) of one GEMM over ``grid`` resident
    blocks: the least work for the busiest block, its weight stages
    (ceil(items / grid) x groups per split) plus ``ITEM_STAGES`` an item,
    then fewer splits (fewer merges)."""
    best = None
    for s in range(1, ng + 1):
        gps = math.ceil(ng / s)
        s = math.ceil(ng / gps)
        rounds = math.ceil(tiles * s / grid)
        key = (rounds * (gps + ITEM_STAGES), s)
        if best is None or key < best[0]:
            best = (key, s, gps)
    return best[1], best[2]


class TailPlan(NamedTuple):
    """K14's launch: ``grid`` blocks, and per GEMM (o, gate_up, down) its
    (column tiles, groups, K splits, groups per split)."""
    grid: int
    gemms: Tuple[Tuple[int, int, int, int], ...]


@functools.lru_cache(maxsize=None)
def tail_plan(K1: int, D: int, I: int, resident: int) -> TailPlan:
    """Each GEMM split by ``split_plan`` over the ``resident`` blocks the card
    holds at once; the grid is no larger than the most items a GEMM has
    (every block waits at both grid barriers)."""
    gemms = []
    for K, N in ((K1, D), (D, 2 * I), (I, D)):
        tiles, ng = N // _BN, K // G
        gemms.append((tiles, ng, *split_plan(tiles, ng, resident)))
    return TailPlan(min(resident, max(t * s for t, _, s, _ in gemms)), tuple(gemms))


def block_items(plan: TailPlan, b: int) -> List[Tuple[int, int, int, int, int]]:
    """Block ``b``'s work list in the kernel's order: (GEMM, column tile,
    split, first group, end group) of items b, b + grid, ... of each GEMM
    (item it: tile it % tiles, split it // tiles)."""
    out = []
    for p, (tiles, ng, splits, gps) in enumerate(plan.gemms):
        for it in range(b, tiles * splits, plan.grid):
            sp = it // tiles
            out.append((p, it % tiles, sp, sp * gps, min(ng, sp * gps + gps)))
    return out


def ring_events(plan: TailPlan, b: int, ahead: int = 2) -> list:
    """Block ``b``'s weight stream as the kernel runs it: thread 0's
    ("issue", j, GEMM, tile, group) at the calls the kernel makes (before
    the launch waits for the kernel before it, at each GEMM's start, at the
    head of every turn, before each grid barrier), the block's ("consume",
    j, GEMM, tile, group) in turn and ("barrier", k). j counts the block's
    stages over its whole work list: slot j % RING_STAGES, full-barrier
    phase j // RING_STAGES. ``ahead``: the GEMMs past the consumed one the
    producer may run into (the kernel's kAhead; 0 drains the ring at each
    barrier)."""
    stream = [(p, tile, g) for p, tile, _, g0, g1 in block_items(plan, b) for g in range(g0, g1)]
    events, issued = [], 0

    def produce(target: int, limit: int) -> None:
        nonlocal issued
        while issued <= target and issued < len(stream) and stream[issued][0] <= limit:
            events.append(("issue", issued, *stream[issued]))
            issued += 1

    produce(RING_STAGES - 2, ahead)
    base = 0
    for p in range(3):
        if p:
            produce(base + RING_STAGES - 1, p - 1 + ahead)
            events.append(("barrier", p))
        produce(base + RING_STAGES - 2, p + ahead)
        for q, tile, _, g0, g1 in block_items(plan, b):
            if q != p:
                continue
            for i in range(g1 - g0):  # turn i's head, then its stage's MMAs and fold
                produce(base + i + RING_STAGES - 1, p + ahead)
                events.append(("consume", base + i, *stream[base + i]))
            base += g1 - g0
    return events


def _gemm_split(x: torch.Tensor, qweight, scales, zeros_x_scales, splits: int,
                gps: int) -> torch.Tensor:
    """f32 [M, N] of one GEMM in K14's order: within split z each group's
    dot folded in turn (acc + dot * s - xsum * zs), the splits' sums added
    in split order from zero."""
    M, K = x.shape
    ng, N = K // G, qweight.shape[1]
    codes = unpack_qtpu_tensor(qweight, G).to(torch.float32).reshape(ng, G, N)
    xg = x.to(torch.bfloat16).to(torch.float32).reshape(M, ng, G).transpose(0, 1)
    dots = torch.bmm(xg, codes)  # [ng, M, N]
    xsum = xg.sum(-1, keepdim=True)
    s = scales.to(torch.float32)[:, None, :]
    zs = zeros_x_scales.to(torch.float32)[:, None, :]
    total = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for z in range(splits):
        acc = torch.zeros_like(total)
        for g in range(z * gps, min(ng, z * gps + gps)):
            acc = (acc + dots[g] * s[g]) - xsum[g] * zs[g]
        total = total + acc
    return total


def fused_layer_tail_split_plain(
    attn_out, x_resid, norm_w, o_qw, o_s, o_zs, gu_qw, gu_s, gu_zs, dn_qw, dn_s, dn_zs,
    eps: float = 1e-6, plan: TailPlan = None,
) -> torch.Tensor:
    """A model of K14's arithmetic under ``plan`` (``tail_plan`` at the
    card's 264 resident blocks by default): each GEMM summed as
    ``_gemm_split``, then K14's epilogues (h and its row sums of squares,
    the norm with rstd = rsqrt(sum / D + eps), gu, SiLU * up, y); returns
    y [M, D] bf16."""
    K1 = attn_out.shape[-1]
    D, I = o_qw.shape[1], dn_qw.shape[0] * PACK
    plan = plan or tail_plan(K1, D, I, 264)
    (_, _, s1, p1), (_, _, s2, p2), (_, _, s3, p3) = plan.gemms
    bf = torch.bfloat16
    h = (_gemm_split(attn_out, o_qw, o_s, o_zs, s1, p1).to(bf).float()
         + x_resid.to(bf).float()).to(bf)
    hf = h.float()
    rstd = torch.rsqrt((hf * hf).sum(-1, keepdim=True) / D + eps)
    xn = (hf * rstd * norm_w.to(bf).float()).to(bf)
    gu = _gemm_split(xn, gu_qw, gu_s, gu_zs, s2, p2).to(bf)
    g, u = gu[:, :I].float(), gu[:, I:].float()
    x2 = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(bf)
    return (_gemm_split(x2, dn_qw, dn_s, dn_zs, s3, p3).to(bf).float() + hf).to(bf)


def resident_blocks(dev: torch.device) -> int:
    """The K14 blocks ``dev`` holds at once, as the loaded library reports
    them from the card's occupancy (two an SM while ptxas keeps the body at
    two blocks an SM); kept on the library object, so that another build
    (``kernel_ablate.py``'s) asks again."""
    lib = KERNEL.lib()
    counts = lib.__dict__.setdefault("k14_resident", {})
    if dev.index not in counts:
        with torch.cuda.device(dev):
            n = lib.qtt_fused_layer_tail_resident()
        if n <= 0:
            raise RuntimeError(f"fused_layer_tail.cu: the resident count failed ({-n})")
        counts[dev.index] = n
    return counts[dev.index]


def fused_layer_tail_cuda(
    attn_out, x_resid, norm_w, o_qw, o_s, o_zs, gu_qw, gu_s, gu_zs, dn_qw, dn_s, dn_zs,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Launch K14 on CUDA tensors; same arguments as the plain version."""
    dev = attn_out.device
    M, K1 = attn_out.shape
    D, N2 = o_qw.shape[1], gu_qw.shape[1]
    I = dn_qw.shape[0] * PACK
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"K14 takes 1 to {MAX_ROWS} rows, got {M}")
    if N2 != 2 * I or K1 % G or D % G or I % G or D > _BN * _BN:
        raise ValueError(f"K14 shapes: K1={K1} D={D} gate_up N={N2} down K={I}")
    attn_out = attn_out.to(torch.bfloat16).contiguous()
    x_resid = x_resid.to(torch.bfloat16).contiguous()
    nw = norm_w.to(torch.bfloat16).contiguous()  # the Pallas kernel's bf16 weight (:229-231)
    check(attn_out, "attn_out", torch.bfloat16, (M, K1))
    check(x_resid, "x_resid", torch.bfloat16, (M, D))
    check(nw, "norm_w", torch.bfloat16, (D,))
    for name, (qw, s, zs, K, N) in {"o": (o_qw, o_s, o_zs, K1, D),
                                    "gate_up": (gu_qw, gu_s, gu_zs, D, N2),
                                    "down": (dn_qw, dn_s, dn_zs, I, D)}.items():
        check(qw, f"{name}.qweight", torch.int32, (K // PACK, N))
        check(s, f"{name}.scales", torch.float32, (K // G, N))
        check(zs, f"{name}.zeros_x_scales", torch.float32, (K // G, N))
    plan = tail_plan(K1, D, I, resident_blocks(dev))
    splits = [(s, gps) for _, _, s, gps in plan.gemms]
    sizes = [s * M * N for (s, _), N in zip(splits, (D, N2, D))]
    scratch = torch.empty(sum(sizes) + (D // _BN) * MAX_ROWS, dtype=torch.float32, device=dev)
    parts = torch.split(scratch, sizes + [(D // _BN) * MAX_ROWS])
    hb = torch.empty(M * (D + N2), dtype=torch.bfloat16, device=dev)
    h, gu = hb[:M * D], hb[M * D:]
    sync = _SYNC.get(dev, 2 + 2 * (D // _BN) + N2 // _BN)
    out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    KERNEL.launch(
        "qtt_fused_layer_tail", launch_key(M, K1, D, I),
        attn_out.data_ptr(), x_resid.data_ptr(), nw.data_ptr(),
        o_qw.data_ptr(), o_s.data_ptr(), o_zs.data_ptr(),
        gu_qw.data_ptr(), gu_s.data_ptr(), gu_zs.data_ptr(),
        dn_qw.data_ptr(), dn_s.data_ptr(), dn_zs.data_ptr(), float(eps),
        M, K1, D, I, *splits[0], *splits[1], *splits[2], plan.grid,
        parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
        h.data_ptr(), gu.data_ptr(), parts[3].data_ptr(), sync.data_ptr(),
        out.data_ptr(), stream_ptr(dev),
    )
    return out


def fused_layer_tail(
    attn_out: torch.Tensor,  # [M, K1] pre-o attention output (M <= 8)
    x_resid: torch.Tensor,   # [M, D] the layer's residual stream
    norm_w: torch.Tensor,    # [D] MLP RMSNorm weight
    o_qw, o_s, o_zs, gu_qw, gu_s, gu_zs, dn_qw, dn_s, dn_zs,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Returns the layer output y [M, D] bf16 (= x + o(attn) + mlp(norm(x +
    o))): K14 on CUDA tensors, the plain version on CPU tensors."""
    args = (attn_out, x_resid, norm_w, o_qw, o_s, o_zs, gu_qw, gu_s, gu_zs, dn_qw, dn_s, dn_zs)
    if attn_out.device.type != "cuda":
        return fused_layer_tail_plain(*args, eps=eps)
    return fused_layer_tail_cuda(*args, eps=eps)
