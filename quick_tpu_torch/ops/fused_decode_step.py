"""Fused decode step: CUDA kernel K3 and its plain version.

Port of ``quick_tpu/ops/fused_decode_step.py::fused_decode_attention``
(:164): for one new token per batch row, RoPE on q/k, the k/v row written
into the dense [L, B, Hkv, S, D] cache at ``length``, and attention over
the cache plus the new token. The JAX function returns new cache arrays;
the port writes the caches IN PLACE and returns the same tensors, so the
``(out, k_cache, v_cache)`` contract holds. ``length`` is an int32 tensor
of one element; K3 reads it on the card (the dense cache's ``length_dev``),
so a captured decode step needs no new launch arguments.

The rounding follows the Pallas kernel (:71-77, :102-154): roped q and k
rounded to the activation dtype, ``scale`` applied to q in f32; cached
scores use q rounded again to the cache dtype, the new token's score the
f32 q; cached p is rounded to the cache dtype before p @ v.

K3 splits the cache's key range over blocks (``split_plan``, from the
shapes alone) and merges the splits' f32 partials in split order;
``fused_decode_attention_split_plain`` is the plain model of that
arithmetic (p rounded against each block's running max), which the tests
hold against the JAX kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quick_tpu_torch.ops import decode_attention
from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)

NEG_INF = -1e30

#: K3. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "fused_decode_step.cu",
    {"qtt_fused_decode_step": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
        i32, ptr, i32, i32, f32, i32, f32, i32, ptr,
    ]},
)
KERNEL_HEAD_DIMS = (64, 128, 256)
TILE = decode_attention.TILE  # keys per tile of K3's blocks
ROWS = 16  # query heads a K3 block (one m16 tile): gq = 32 takes two blocks a kv head
_COUNTERS = ZeroedWords("K3")  # its merge counters, zero between launches


def group_for(dtype: torch.dtype) -> int:
    """Cache rows per write group of the Pallas kernel (``_group_for`` :41):
    the fused gate keeps the TPU's alignment rule (ROADMAP.md)."""
    return max(8, 32 // dtype.itemsize)


def _rope_rows(x: torch.Tensor, cos_row: torch.Tensor, sin_row: torch.Tensor) -> torch.Tensor:
    """x [B, H, D] f32 rotated with full-width rows [B, D]:
    x*cos + rot(x)*sin, rot(x) = [-x2 | x1]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos_row[:, None, :] + rot * sin_row[:, None, :]


def fused_decode_attention_plain(
    q: torch.Tensor,         # [B, hq, D] pre-rope
    k_new: torch.Tensor,     # [B, hkv, D] pre-rope
    v_new: torch.Tensor,     # [B, hkv, D]
    k_cache: torch.Tensor,   # [L, B, Hkv, S, D] — written in place
    v_cache: torch.Tensor,
    cos_row: torch.Tensor,   # [B, D] f32
    sin_row: torch.Tensor,
    length: torch.Tensor,    # int32 [1] (read on the host here)
    layer: int,
    scale: float,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> torch.Tensor:
    """Plain version of K3; returns the attention output [B, hq, D]."""
    length = int(length)
    B, hq, D = q.shape
    hkv = k_new.shape[1]
    gq = hq // hkv
    in_dt = q.dtype
    cs, sn = cos_row.to(torch.float32), sin_row.to(torch.float32)
    if use_rope:
        qr = _rope_rows(q.to(torch.float32), cs, sn).to(in_dt).to(torch.float32)
        kr = _rope_rows(k_new.to(torch.float32), cs, sn).to(in_dt).to(torch.float32)
    else:
        qr, kr = q.to(torch.float32), k_new.to(torch.float32)
    qs = qr * scale                                   # [B, hq, D] f32
    vn = v_new.to(torch.float32)
    k_cache[layer, :, :, length] = kr.to(k_cache.dtype)
    v_cache[layer, :, :, length] = v_new.to(v_cache.dtype)

    kc = k_cache[layer, :, :, :length].to(torch.float32)  # [B, hkv, T, D]
    vc = v_cache[layer, :, :, :length].to(torch.float32)
    qg = qs.reshape(B, hkv, gq, D)
    qb = qg.to(k_cache.dtype).to(torch.float32)
    s = torch.einsum("bkgd,bktd->bkgt", qb, kc)          # [B, hkv, gq, T]
    s_new = (qg * kr.reshape(B, hkv, 1, D)).sum(-1, keepdim=True)
    if logit_softcap:
        s = logit_softcap * torch.tanh(s * (1.0 / logit_softcap))
        s_new = logit_softcap * torch.tanh(s_new * (1.0 / logit_softcap))
    pos = torch.arange(length, device=q.device)
    if alibi_slopes is not None:
        sl = alibi_slopes.to(q.device, torch.float32).reshape(1, hkv, gq, 1)
        s = s + sl * (pos - length).to(torch.float32)
    mask = torch.ones(length, dtype=torch.bool, device=q.device)
    if window:
        mask = pos > length - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.maximum(s.amax(dim=-1, keepdim=True) if length else s_new, s_new)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    p_new = torch.exp(s_new - m)
    denom = p.sum(-1, keepdim=True) + p_new
    ctx = torch.einsum(
        "bkgt,bktd->bkgd", p.to(v_cache.dtype).to(torch.float32), vc
    ) + p_new * vn.reshape(B, hkv, 1, D)
    return (ctx / denom).reshape(B, hq, D).to(q.dtype)


def split_plan(B: int, Hkv: int, gq: int, S: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of K3's key range: K7's plan (``decode_attention.
    split_plan``: about two blocks an SM, whole 64-key tiles) over the
    B x Hkv x ceil(gq / 16) blocks of one split. From the shapes only,
    never from the length on the card: a captured step replays it."""
    return decode_attention.split_plan(B, Hkv * -(-gq // ROWS), S, sms)


def split_range(split: int, chunk: int, length: int, window: Optional[int]) -> Tuple[int, int]:
    """The keys [lo, hi) of ``split``: its chunk inside [window start,
    length), as K3 computes it; empty when lo >= hi. A block runs the
    64-key tiles from lo rounded down to a tile through hi, masking keys
    outside [lo, hi)."""
    wlo = max(0, length - window + 1) if window and window > 0 else 0
    return max(split * chunk, wlo), min(length, split * chunk + chunk)


def fused_decode_attention_split_plain(
    q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, length, layer: int, scale: float,
    window=None, logit_softcap=None, alibi_slopes=None, use_rope: bool = True,
    chunk: int = TILE, splits: Optional[int] = None,
) -> torch.Tensor:
    """Plain model of K3's split-and-merge arithmetic (the same arguments
    as ``fused_decode_attention_plain``, whose cache write it repeats):
    per split, its 64-key tiles in an online softmax in f32, p rounded to
    the cache dtype against the running max before p @ v; then the
    non-empty splits' (m, l, acc) merged in split order with the new
    token's f32 score. Returns [B, hq, D]."""
    length = int(length)
    B, hq, D = q.shape
    hkv = k_new.shape[1]
    gq = hq // hkv
    S = k_cache.shape[3]
    splits = -(-S // chunk) if splits is None else splits
    cs, sn_row = cos_row.to(torch.float32), sin_row.to(torch.float32)
    if use_rope:
        qr = _rope_rows(q.to(torch.float32), cs, sn_row).to(q.dtype).to(torch.float32)
        kr = _rope_rows(k_new.to(torch.float32), cs, sn_row).to(q.dtype).to(torch.float32)
    else:
        qr, kr = q.to(torch.float32), k_new.to(torch.float32)
    qs = (qr * scale).reshape(B, hkv, gq, D)  # f32
    qb = qs.to(k_cache.dtype).to(torch.float32)
    vn = v_new.to(torch.float32).reshape(B, hkv, 1, D)
    k_cache[layer, :, :, length] = kr.to(k_cache.dtype)
    v_cache[layer, :, :, length] = v_new.to(v_cache.dtype)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(1, hkv, gq, 1)
    parts = []
    for sp in range(splits):
        lo, hi = split_range(sp, chunk, length, window)
        if lo >= hi:
            continue
        m = torch.full((B, hkv, gq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, hkv, gq, D), dtype=torch.float32, device=q.device)
        for t0 in range(lo // TILE * TILE, hi, TILE):
            t1 = min(t0 + TILE, hi)
            kc = k_cache[layer, :, :, t0:t1].to(torch.float32)
            vc = v_cache[layer, :, :, t0:t1].to(torch.float32)
            s = torch.einsum("bkgd,bktd->bkgt", qb, kc)
            if logit_softcap:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            pos = torch.arange(t0, t1, device=q.device)
            if slopes is not None:
                s = s + slopes * (pos - length).to(torch.float32)
            ok = pos >= lo
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgt,bktd->bkgd", p.to(v_cache.dtype).to(torch.float32), vc)
            m = m_new
        parts.append((m, l, acc))
    s_new = (qs * kr.reshape(B, hkv, 1, D)).sum(-1, keepdim=True)
    if logit_softcap:
        s_new = logit_softcap * torch.tanh(s_new / logit_softcap)
    big = s_new
    for m, _, _ in parts:
        big = torch.maximum(big, m)
    lt = torch.zeros_like(big)
    acc = torch.zeros((B, hkv, gq, D), dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - big)
        lt = lt + l * w
        acc = acc + w * a
    pn = torch.exp(s_new - big)
    out = (acc + pn * vn) / (lt + pn)
    return out.reshape(B, hq, D).to(q.dtype)


def fused_decode_attention_cuda(
    q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, length: torch.Tensor,
    layer: int, scale: float, window=None, logit_softcap=None,
    alibi_slopes=None, use_rope: bool = True,
) -> torch.Tensor:
    """Launch K3 on CUDA tensors; same arguments as the plain version, with
    ``length`` an int32 tensor of one element on the card, which K3 reads
    there (the caller checks it on the host: ``KVCache.check_room``). For a
    length outside [0, S) K3 writes no cache row and returns NaN. The key
    range is split over blocks by ``split_plan``; the partials are
    allocated here, as K7's are, and the merge counters live on the device
    (``_COUNTERS``): one K3 launch at a time on a device."""
    B, hq, D = q.shape
    L, Bc, hkv, S, Dc = k_cache.shape
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"fused step takes head_dim in {KERNEL_HEAD_DIMS}, got {D}")
    if Bc != B or Dc != D or hq % hkv or hq // hkv > 32:
        raise ValueError(f"shapes q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}")
    if not isinstance(length, torch.Tensor):
        raise TypeError("K3 reads its length on the card: pass an int32 tensor of one element")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside cache {L}")
    check(length, "length", torch.int32, (1,))
    check(q, "q", torch.bfloat16, (B, hq, D))
    check(k_new, "k_new", torch.bfloat16, (B, hkv, D))
    check(v_new, "v_new", torch.bfloat16, (B, hkv, D))
    check(k_cache, "k_cache", torch.bfloat16)
    check(v_cache, "v_cache", torch.bfloat16, k_cache.shape)
    check(cos_row, "cos_row", torch.float32, (B, D))
    check(sin_row, "sin_row", torch.float32, (B, D))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
        check(slopes, "alibi_slopes", torch.float32, (hq,))
    chunk, splits = split_plan(B, hkv, hq // hkv, S, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_acc = torch.empty((B, hq, splits, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, hq, splits, 2), dtype=torch.float32, device=q.device)
    counters = _COUNTERS.get(q.device, B * hkv * -(-(hq // hkv) // ROWS))
    KERNEL.launch(
        "qtt_fused_decode_step", f"B={B} Hq={hq} Hkv={hkv} S={S} D={D}",
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), counters.data_ptr(), B, hq, hkv, S, D, layer, length.data_ptr(),
        chunk, splits, float(scale), int(window or 0), float(logit_softcap or 0.0),
        int(bool(use_rope)), stream_ptr(q.device),
    )
    return out


def fused_decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cos_row: torch.Tensor,
    sin_row: torch.Tensor,
    length: torch.Tensor,  # int32 [1] on the caches' device
    layer: int,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out [B, hq, D], k_cache, v_cache); the caches are the
    argument tensors, updated in place at ``[layer, :, :, length]``."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    S = k_cache.shape[3]
    group = group_for(k_cache.dtype)
    if S % group:
        raise ValueError(f"max_seq {S} must be a multiple of group {group}")
    args = (q, k_new, v_new, k_cache, v_cache, cos_row, sin_row, length,
            int(layer), scale, window, logit_softcap, alibi_slopes, use_rope)
    if q.device.type != "cuda":
        out = fused_decode_attention_plain(*args)
    else:
        out = fused_decode_attention_cuda(
            q.contiguous(), k_new.contiguous(), v_new.contiguous(), k_cache,
            v_cache, cos_row.to(torch.float32).contiguous(),
            sin_row.to(torch.float32).contiguous(), *args[7:],
        )
    return out, k_cache, v_cache
