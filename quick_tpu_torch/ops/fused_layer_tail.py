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
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)
from quick_tpu_torch.quantize.packing import PACK, unpack_qtpu_tensor

#: K14. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "fused_layer_tail.cu",
    {"qtt_fused_layer_tail": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
    ]},
)
G = 128
MAX_ROWS = 8
BLOCKS_PER_SM = 4  # K14's resident blocks per SM (the launcher checks the occupancy)
_BN = 128  # output columns per item (csrc/qmm_decode.cuh kBN)
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


def split_plan(tiles: int, ng: int, grid: int) -> Tuple[int, int]:
    """(splits, groups per split) of one phase over ``grid`` resident
    blocks: the fewest rounds of groups a block runs, ceil(items / grid) x
    groups per split, then fewer splits."""
    best = None
    for s in range(1, ng + 1):
        gps = math.ceil(ng / s)
        s = math.ceil(ng / gps)
        key = (math.ceil(tiles * s / grid) * gps, s)
        if best is None or key < best[0]:
            best = (key, s, gps)
    return best[1], best[2]


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
    if N2 != 2 * I or K1 % G or D % G or I % G:
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
    rows = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    grid = BLOCKS_PER_SM * sm_count(dev.index)
    plans = [split_plan(-(-N // _BN), K // G, grid) for K, N in ((K1, D), (D, N2), (I, D))]
    sizes = [s * M * N for (s, _), N in zip(plans, (D, N2, D))]
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
        M, K1, D, I, rows, *plans[0], *plans[1], *plans[2], grid,
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
