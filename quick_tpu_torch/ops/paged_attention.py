"""Attention over the paged KV cache: CUDA kernels K5 (decode) and K6
(chunked prefill) over bf16 pages, K5q and K6q over INT8 pages, and their
plain versions.

Port of ``quick_tpu/ops/paged_attention.py``: ``paged_decode_attention``
(:437), ``paged_chunk_attention`` (:291) and ``supports_chunk`` (:279),
with the same arguments — the whole [L, P, Hkv, page, D] page stacks plus
``layer`` (or one layer's [P, Hkv, page, D]), block tables, per-slot
lengths or chunk starts on the device, window, softcap and ALiBi slopes.
CUDA tensors go to ``csrc/paged_attention.cu`` (bf16 pages); CPU tensors to
the plain version, which is the dense gather of the slot's pages
(``PagedKVCache.layer``) followed by the einsum attention, as the JAX
package's fallback does (blocks.py:440-452).

K5 splits each slot's key range over blocks (``split_plan``, from the
shapes alone) and merges the splits' f32 partials in split order, as K3
does; ``paged_decode_attention_split_plain`` is the plain model of that
arithmetic (p rounded against each block's running max), which the tests
hold against the Pallas kernel. K6 does the same over a chunk's (position,
head) rows, 64 rows a block (``chunk_split_plan``, ``chunk_block_range``),
merging row by row; ``paged_chunk_attention_split_plain`` models it.
K6q is K6's kernel over INT8 pages, with K6's plan and merge; the same
model with ``kv_scales`` models its arithmetic.

INT8 pages (``kv_scales``, the [L, P, 8, Hkv*page] f32 tiles of
``PagedKVCache``) go to ``csrc/paged_attention_int8.cu`` on the card. Their
plain versions repeat the Pallas kernels' INT8 arithmetic page by page, not
the gather: decode (``_paged_kernel`` :96-163) quantizes q per (slot,
head) to int8 (:528-538), takes int8 x int8 score dots scaled by
``sq * scale * k_scale``, folds the v scales into the probabilities and
quantizes them per (query head, page) against the running max at that
page before an int8 x int8 context dot; chunk (``_paged_chunk_kernel``
:225-262) converts the codes to bf16 (exact), scales the score columns by
the k scales and the probability columns by the v scales, with bf16 dots.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quick_tpu_torch.ops import decode_attention
from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)
from quick_tpu_torch.ops.attention import einsum_attention
from quick_tpu_torch.ops.paged_write import div127

#: K5 and K6 (one source, two entry points). ``KERNEL.launches`` counts
#: both; ``launches_by_key`` splits them ("decode ..." / "chunk ...").
KERNEL = CudaKernel(
    "paged_attention.cu",
    {
        "qtt_paged_decode_attention": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, f32, i32, f32, ptr,
        ],
        "qtt_paged_chunk_attention": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, i32, f32, i32, f32, ptr,
        ],
    },
)
#: K5q and K6q (one source, two entry points), counted apart from K5 / K6.
KERNEL_INT8 = CudaKernel(
    "paged_attention_int8.cu",
    {
        "qtt_paged_decode_attention_int8": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            i32, i32, i32, f32, i32, f32, ptr,
        ],
        "qtt_paged_chunk_attention_int8": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, i32, i32, f32, i32, f32, ptr,
        ],
    },
)
KERNEL_HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30  # the Pallas kernels' mask value
TILE = decode_attention.TILE  # keys per tile of K5's blocks
ROWS = 16  # query heads a K5 block (one m16 tile): gq = 32 takes two blocks a kv head
CHUNK_ROWS = 64  # (position, head) rows a K6 / K6q block: four m16 tiles, two warps each
_COUNTERS = ZeroedWords("K5")  # its merge counters, zero between launches
_CHUNK_COUNTERS = ZeroedWords("K6 / K6q")


def launch_key(B: int, S: Optional[int], Hq: int, Hkv: int, page: int, D: int,
               n_pt: int) -> str:
    """The ``launches_by_key`` key of one launch: K5 (``S`` None) or K6."""
    head = f"decode B={B}" if S is None else f"chunk B={B} S={S}"
    return f"{head} Hq={Hq} Hkv={Hkv} page={page} D={D} n_pt={n_pt}"


def supports_chunk(S: int, Hq: int, Hkv: int, page: int) -> bool:
    """The JAX package's VMEM feasibility rule for the chunk kernel (:279),
    kept so both packages take the same branch (ROADMAP "gates carry TPU
    limits"): the [S*Hq, Hkv*page] f32 temporaries must fit 8 MB."""
    R, T = S * Hq, Hkv * page
    return R >= 8 and R * T * 4 * 6 <= 8 * 1024 * 1024


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor, layer: int) -> torch.Tensor:
    """Layer ``layer`` of [L, P, H, page, D] pages gathered through
    ``block_table`` [B, n_pt] into a dense head-major [B, H, n_pt*page, D]."""
    g = pages[layer][block_table.long()]  # [B, n_pt, H, page, D]
    B, n_pt, H, page, D = g.shape
    return g.transpose(1, 2).reshape(B, H, n_pt * page, D)


def _stacks(k_pages, v_pages, layer):
    if k_pages.ndim == 4:  # one layer's pages
        return k_pages[None], v_pages[None], 0
    return k_pages, v_pages, int(layer)


def paged_decode_attention_plain(
    q, k_pages, v_pages, block_table, lengths, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None,
) -> torch.Tensor:
    """Plain version of K5: gather + einsum attention with the query at
    ``lengths - 1``. Returns [B, Hq, D]."""
    k = gather_pages(k_pages, block_table, layer)
    v = gather_pages(v_pages, block_table, layer)
    ln = lengths.to(torch.int64)
    return einsum_attention(
        q[:, None], k, v, q_offset=ln - 1, kv_len=ln, scale=scale,
        alibi_slopes=alibi_slopes, kv_heads_major=True, window=window,
        logit_softcap=logit_softcap,
    )[:, 0]


def split_plan(B: int, Hkv: int, gq: int, T: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of K5's key range [0, T = n_pt * page): K7's plan
    (``decode_attention.split_plan``: about two blocks an SM, whole 64-key
    tiles) over the B x Hkv x ceil(gq / 16) blocks of one split, as K3's.
    From the shapes only, never from the lengths on the card: a captured
    step replays it."""
    return decode_attention.split_plan(B, Hkv * -(-gq // ROWS), T, sms)


def split_range(split: int, chunk: int, length: int, window: Optional[int],
                n_keys: int) -> Tuple[int, int]:
    """The keys [lo, hi) of ``split`` for the query at ``length - 1``: its
    chunk inside [window start, min(length, n_keys)), as K5 computes it;
    empty when lo >= hi. A block runs the 64-key tiles from lo rounded down
    to a tile through hi, masking keys outside [lo, hi)."""
    wlo = max(0, length - window) if window and window > 0 else 0
    end = max(0, min(length, n_keys))
    return max(split * chunk, wlo), min(end, split * chunk + chunk)


def paged_decode_attention_split_plain(
    q, k_pages, v_pages, block_table, lengths, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None, chunk: int = TILE, splits: Optional[int] = None,
) -> torch.Tensor:
    """Plain model of K5's split-and-merge arithmetic (the arguments of
    ``paged_decode_attention_plain``): per slot and split, its 64-key tiles
    of the gathered pages in an online softmax in f32, q . k in the pages'
    dtype times ``scale``, p rounded to the pages' dtype against the running
    max before p @ v; then the non-empty splits' (m, l, acc) merged in split
    order, 0 where none has a key. Returns [B, Hq, D]."""
    k = gather_pages(k_pages, block_table, layer).to(torch.float32)  # [B, Hkv, T, D]
    v = gather_pages(v_pages, block_table, layer)
    B, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    gq = Hq // Hkv
    splits = -(-T // chunk) if splits is None else splits
    qb = q.to(k_pages.dtype).to(torch.float32).reshape(B, Hkv, gq, D)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(Hkv, gq, 1)
    out = torch.zeros((B, Hkv, gq, D), dtype=torch.float32, device=q.device)
    for b, length in enumerate(int(n) for n in lengths):
        parts = []
        for sp in range(splits):
            lo, hi = split_range(sp, chunk, length, window, T)
            if lo >= hi:
                continue
            m = torch.full((Hkv, gq, 1), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((Hkv, gq, D), dtype=torch.float32, device=q.device)
            for t0 in range(lo // TILE * TILE, hi, TILE):
                t1 = min(t0 + TILE, hi)
                s = torch.einsum("kgd,ktd->kgt", qb[b], k[b, :, t0:t1]) * scale
                if logit_softcap:
                    s = logit_softcap * torch.tanh(s / logit_softcap)
                pos = torch.arange(t0, t1, device=q.device)
                if slopes is not None:
                    s = s + slopes * (pos - (length - 1)).to(torch.float32)
                ok = pos >= lo
                s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum(
                    "kgt,ktd->kgd", p.to(v.dtype).to(torch.float32),
                    v[b, :, t0:t1].to(torch.float32))
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        big = parts[0][0]
        for m, _, _ in parts[1:]:
            big = torch.maximum(big, m)
        lt = torch.zeros_like(big)
        acc = torch.zeros((Hkv, gq, D), dtype=torch.float32, device=q.device)
        for m, l, a in parts:
            w = torch.exp(m - big)
            lt = lt + l * w
            acc = acc + w * a
        out[b] = acc / torch.where(lt == 0.0, torch.ones_like(lt), lt)
    return out.reshape(B, Hq, D).to(q.dtype)


def chunk_split_plan(B: int, Hkv: int, S: int, gq: int, T: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of K6's key range [0, T = n_pt * page): K7's plan
    over the B x Hkv x ceil(S * gq / CHUNK_ROWS) blocks of one split, as
    K5's over its head groups. From the shapes only, never from the starts
    on the card: a captured launch replays it."""
    return decode_attention.split_plan(B, Hkv * -(-S * gq // CHUNK_ROWS), T, sms)


def chunk_block_range(split: int, chunk: int, start: int, rows: Tuple[int, int], gq: int,
                      window: Optional[int], n_keys: int) -> Tuple[int, int]:
    """The keys [lo, hi) that K6's block of (position, head) rows
    [rows[0], rows[1]) walks in ``split``: from its first row's window
    start to its last row's position, inside the split's chunk and the
    table; empty when lo >= hi."""
    first, last = start + rows[0] // gq, start + (rows[1] - 1) // gq
    lo, _ = split_range(split, chunk, first + 1, window, n_keys)
    _, hi = split_range(split, chunk, last + 1, None, n_keys)
    return lo, hi


def _gather_scales(kv_scales, block_table, layer, Hkv: int, page: int):
    """The k and v scales of every key of each slot's table, [B, Hkv, 1,
    n_pt * page] each (rows 0 and 1 of the pages' scale tiles)."""
    sc = kv_scales[layer][block_table.long()]  # [B, n_pt, 8, Hkv * page]
    B, n_pt = sc.shape[:2]
    return tuple(sc[:, :, r].reshape(B, n_pt, Hkv, page).transpose(1, 2).reshape(
        B, Hkv, 1, n_pt * page).to(torch.float32) for r in (0, 1))


def paged_chunk_attention_split_plain(
    q, k_pages, v_pages, block_table, starts, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None, chunk: int = TILE, splits: Optional[int] = None,
    kv_scales=None,
) -> torch.Tensor:
    """Plain model of K6's split-and-merge arithmetic (the arguments of
    ``paged_chunk_attention_plain``): per slot, split and (position, head)
    row, the row's visible keys in the split (``split_range`` at the row's
    position) in 64-key tiles whose two 32-key halves run apart (the
    kernel's two warps a row tile), each an online softmax in f32, q . k in
    the pages' dtype times ``scale``, p rounded to the pages' dtype against
    the half's running max before p @ v, the halves combined at the end;
    then, row by row, the splits in which the row sees a key merged in
    split order, 0 where none does. Returns [B, S, Hq, D].

    With ``kv_scales`` (INT8 pages, K6q): q and the codes in bf16 (codes
    exactly), the score times the key's k scale after ``scale``, and p
    times the key's v scale before its bf16 rounding (l sums the unscaled
    p), the Pallas INT8 chunk kernel's order."""
    k = gather_pages(k_pages, block_table, layer).to(torch.float32)  # [B, Hkv, T, D]
    v = gather_pages(v_pages, block_table, layer)
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    gq = Hq // Hkv
    splits = -(-T // chunk) if splits is None else splits
    pdt = k_pages.dtype  # the type p is rounded to, and q
    if kv_scales is not None:
        pdt = torch.bfloat16
        ksc, vsc = _gather_scales(kv_scales, block_table, layer, Hkv, k_pages.shape[3])
    # rows of kv head h: (position i, head j) -> [B, Hkv, S * gq, D]
    qb = q.to(pdt).to(torch.float32).reshape(B, S, Hkv, gq, D)
    qb = qb.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * gq, D)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(Hkv, 1, gq).expand(
            Hkv, S, gq).reshape(Hkv, S * gq, 1)
    out = torch.zeros((B, Hkv, S * gq, D), dtype=torch.float32, device=q.device)
    rows = torch.arange(S * gq, device=q.device)
    half = TILE // 2
    for b, start in enumerate(int(n) for n in starts):
        qpos = start + rows // gq  # [S * gq]
        parts = []
        for sp in range(splits):
            rng = [split_range(sp, chunk, int(p) + 1, window, T) for p in qpos.tolist()]
            lo = torch.tensor([r[0] for r in rng], device=q.device)
            hi = torch.tensor([r[1] for r in rng], device=q.device)
            live = lo < hi
            if not bool(live.any()):
                continue
            states = []
            for kh in range(2):  # each tile's two 32-key halves, apart until the end
                m = torch.full((Hkv, S * gq, 1), NEG_INF, dtype=torch.float32, device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros((Hkv, S * gq, D), dtype=torch.float32, device=q.device)
                for t0 in range(int(lo[live].min()) // TILE * TILE + kh * half, int(hi[live].max()),
                                TILE):
                    t1 = min(t0 + half, T)
                    s = torch.einsum("krd,ktd->krt", qb[b], k[b, :, t0:t1]) * scale
                    if kv_scales is not None:
                        s = s * ksc[b, :, :, t0:t1]
                    if logit_softcap:
                        s = logit_softcap * torch.tanh(s / logit_softcap)
                    pos = torch.arange(t0, t1, device=q.device)
                    if slopes is not None:
                        s = s + slopes * (pos[None, :] - qpos[:, None]).to(torch.float32)
                    ok = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    if kv_scales is not None:
                        p = p * vsc[b, :, :, t0:t1]
                    acc = acc * alpha + torch.einsum(
                        "krt,ktd->krd", p.to(pdt).to(torch.float32),
                        v[b, :, t0:t1].to(torch.float32))
                    m = m_new
                states.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = states
            m = torch.maximum(m0, m1)
            w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)
            parts.append((live[None, :, None], m, l1 * w1 + l0 * w0, a1 * w1 + a0 * w0))
        big = torch.full((Hkv, S * gq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        for live, m, _, _ in parts:
            big = torch.where(live, torch.maximum(big, m), big)
        lt = torch.zeros_like(big)
        acc = torch.zeros((Hkv, S * gq, D), dtype=torch.float32, device=q.device)
        for live, m, l, a in parts:
            w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
            lt = lt + l * w
            acc = acc + w * a
        out[b] = acc / torch.where(lt == 0.0, torch.ones_like(lt), lt)
    out = out.reshape(B, Hkv, S, gq, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)
    return out.to(q.dtype)


def paged_chunk_attention_plain(
    q, k_pages, v_pages, block_table, starts, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None,
) -> torch.Tensor:
    """Plain version of K6: gather + einsum attention with query i at
    ``starts + i``. Returns [B, S, Hq, D]."""
    k = gather_pages(k_pages, block_table, layer)
    v = gather_pages(v_pages, block_table, layer)
    st = starts.to(torch.int64)
    return einsum_attention(
        q, k, v, q_offset=st, kv_len=st + q.shape[1], scale=scale,
        alibi_slopes=alibi_slopes, kv_heads_major=True, window=window,
        logit_softcap=logit_softcap,
    )


def quantize_q(q: torch.Tensor):
    """The INT8 decode path's query quantization (:528-538): per (slot,
    head) ``sq = max(max|q|, 1e-30) / 127`` and codes ``clip(round(q /
    sq), -127, 127)``. Returns (codes int8 [B, Hq, D], sq f32 [B, Hq, 1])."""
    qf = q.to(torch.float32)
    sq = div127(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-30))
    return torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int8), sq


def _page_tiles(k_pages, v_pages, kv_scales, layer, pg):
    """Codes (f32, exact) [B, Hkv, page, D] and k / v scales [B, Hkv, 1,
    page] of page ids ``pg`` [B]."""
    B, (Hkv, page) = pg.shape[0], k_pages.shape[2:4]
    sc = kv_scales[layer, pg]  # [B, 8, Hkv*page]
    return (k_pages[layer, pg].to(torch.float32), v_pages[layer, pg].to(torch.float32),
            sc[:, 0].reshape(B, Hkv, 1, page), sc[:, 1].reshape(B, Hkv, 1, page))


def paged_decode_attention_int8_plain(
    q, k_pages, v_pages, kv_scales, block_table, lengths, layer, scale,
    alibi_slopes=None, window=None, logit_softcap=None,
) -> torch.Tensor:
    """Plain version of K5q: the Pallas INT8 decode kernel's arithmetic,
    one page at a time in table order. Integer dots run as f32 matmuls of
    integer values, exact while every partial sum stays below 2^24
    (127 * 127 * D for scores, 127 * 127 * page for the context)."""
    B, Hq, D = q.shape
    Hkv, page = k_pages.shape[2], k_pages.shape[3]
    gq = Hq // Hkv
    q8, sq = quantize_q(q)
    q8 = q8.to(torch.float32).reshape(B, Hkv, gq, D)
    qmul = (sq * scale).reshape(B, Hkv, gq, 1)
    ln = lengths.to(q.device, torch.int64)
    lo = ln - window if window else torch.zeros_like(ln)
    slopes = (None if alibi_slopes is None else
              alibi_slopes.to(q.device, torch.float32).reshape(1, Hkv, gq, 1))
    m = torch.full((B, Hkv, gq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, gq, D), device=q.device)
    bt = block_table.to(q.device, torch.int64)
    t = torch.arange(page, device=q.device)
    for j in range(bt.shape[1]):
        base = j * page
        run = (base < ln) & (base + page > lo)  # the kernel's pl.when; others keep their state
        k, v, ks, vs = _page_tiles(k_pages, v_pages, kv_scales, layer, bt[:, j])
        s = torch.matmul(q8, k.transpose(-1, -2)) * qmul * ks  # [B, Hkv, gq, page]
        if logit_softcap:
            s = logit_softcap * torch.tanh(s * (1.0 / logit_softcap))
        pos = base + t
        mask = pos[None, :] < ln[:, None]
        if window:
            mask = mask & (pos[None, :] >= lo[:, None])
        mask = mask[:, None, None, :]
        if slopes is not None:
            s = s + slopes * (pos[None, :] - (ln[:, None] - 1)).to(torch.float32)[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        p = p * vs
        ps = div127(torch.clamp(p.abs().amax(dim=-1, keepdim=True), min=1e-30))
        p8 = torch.clamp(torch.round(p / ps), -127, 127)
        acc_new = acc * alpha + torch.matmul(p8, v) * ps
        r = run[:, None, None, None]
        m, l, acc = (torch.where(r, a, b) for a, b in ((m_new, m), (l_new, l), (acc_new, acc)))
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_chunk_attention_int8_plain(
    q, k_pages, v_pages, kv_scales, block_table, starts, layer, scale,
    alibi_slopes=None, window=None, logit_softcap=None,
) -> torch.Tensor:
    """Plain version of K6q: the Pallas INT8 chunk kernel's arithmetic, one
    page at a time: q and the codes in bf16 (codes exactly), f32 dots, the
    k scales on the score columns, the v scales on the probabilities
    before they are rounded to bf16."""
    B, S, Hq, D = q.shape
    Hkv, page = k_pages.shape[2], k_pages.shape[3]
    gq = Hq // Hkv
    R = S * gq  # rows of one kv head: (chunk position, head in group)
    qb = q.to(torch.bfloat16).to(torch.float32).reshape(B, S, Hkv, gq, D)
    qb = qb.permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, D)
    st = starts.to(q.device, torch.int64)
    cap = st + S
    lo = torch.clamp(st - window + 1, min=0) if window else torch.zeros_like(st)
    pos_q = (st[:, None] + torch.arange(R, device=q.device)[None, :] // gq)[:, None, :, None]
    slopes = None
    if alibi_slopes is not None:
        sl = alibi_slopes.to(q.device, torch.float32).reshape(Hkv, 1, gq)
        slopes = sl.expand(Hkv, S, gq).reshape(1, Hkv, R, 1)
    m = torch.full((B, Hkv, R, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, R, D), device=q.device)
    bt = block_table.to(q.device, torch.int64)
    t = torch.arange(page, device=q.device)
    for j in range(bt.shape[1]):
        base = j * page
        run = (base < cap) & (base + page > lo)  # the kernel's pl.when
        k, v, ks, vs = _page_tiles(k_pages, v_pages, kv_scales, layer, bt[:, j])
        s = torch.matmul(qb, k.transpose(-1, -2)) * scale * ks  # [B, Hkv, R, page]
        if logit_softcap:
            s = logit_softcap * torch.tanh(s * (1.0 / logit_softcap))
        pos_k = (base + t)[None, None, None, :]
        mask = pos_k <= pos_q
        if window:
            mask = mask & (pos_k > pos_q - window)
        if slopes is not None:
            s = s + slopes * (pos_k - pos_q).to(torch.float32)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        p = (p * vs).to(torch.bfloat16).to(torch.float32)
        acc_new = acc * alpha + torch.matmul(p, v)
        r = run[:, None, None, None]
        m, l, acc = (torch.where(r, a, b) for a, b in ((m_new, m), (l_new, l), (acc_new, acc)))
    out = acc / torch.where(l == 0.0, 1.0, l)
    out = out.reshape(B, Hkv, S, gq, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)
    return out.to(q.dtype)


def _check_common(q, k_pages, v_pages, block_table, per_slot, layer, alibi_slopes,
                  page_dtype=torch.bfloat16):
    L, P, Hkv, page, D = k_pages.shape
    B, Hq = q.shape[0], q.shape[-2]
    if D not in KERNEL_HEAD_DIMS or q.shape[-1] != D or v_pages.shape[-1] != D:
        raise NotImplementedError(
            f"paged kernels take q/k/v head_dim in {KERNEL_HEAD_DIMS}, got "
            f"{q.shape[-1]}/{D}/{v_pages.shape[-1]}"
        )
    if Hq % Hkv or Hq // Hkv > 32 or not 0 <= layer < L:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} layer={layer} L={L}")
    check(q, "q", torch.bfloat16)
    check(k_pages, "k_pages", page_dtype)
    check(v_pages, "v_pages", page_dtype, k_pages.shape)
    check(block_table, "block_table", torch.int32, (B, block_table.shape[1]))
    check(per_slot, "lengths/starts", torch.int32, (B,))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
        check(slopes, "alibi_slopes", torch.float32, (Hq,))
    return B, Hq, Hkv, page, D, P, block_table.shape[1], slopes


def paged_decode_attention_cuda(
    q, k_pages, v_pages, block_table, lengths, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K5 on CUDA tensors; same arguments as the plain version. The
    key range is split over blocks by ``split_plan``; the partials are
    allocated here, and the merge counters live on the device
    (``_COUNTERS``, made by an eager launch before any capture): one K5
    launch at a time on a device."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_common(
        q, k_pages, v_pages, block_table, lengths, layer, alibi_slopes)
    gq = Hq // Hkv
    chunk, splits = split_plan(B, Hkv, gq, n_pt * page, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
    counters = _COUNTERS.get(q.device, B * Hkv * -(-gq // ROWS))
    KERNEL.launch(
        "qtt_paged_decode_attention", launch_key(B, None, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        part.data_ptr(), part[B * Hq * splits * D:].data_ptr(), counters.data_ptr(),
        B, Hq, Hkv, page, D, P, n_pt, layer, chunk, splits, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def paged_chunk_attention_cuda(
    q, k_pages, v_pages, block_table, starts, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K6 on CUDA tensors; same arguments as the plain version. The
    key range is split over blocks by ``chunk_split_plan``; the partials
    are allocated here, and the merge counters live on the device
    (``_CHUNK_COUNTERS``, made by an eager launch before any capture): one
    K6 launch at a time on a device."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_common(
        q, k_pages, v_pages, block_table, starts, layer, alibi_slopes)
    S = q.shape[1]
    gq = Hq // Hkv
    if q.data_ptr() % 16:  # the q rows are copied in 16-byte chunks
        q = q.clone()
    chunk, splits = chunk_split_plan(B, Hkv, S, gq, n_pt * page, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    rows = B * Hq * S * splits  # partial rows, [B, Hkv, S * gq, splits]
    part = torch.empty(rows * (D + 2) if splits > 1 else 2, dtype=torch.float32,
                       device=q.device)
    counters = _CHUNK_COUNTERS.get(q.device, B * Hkv * -(-S * gq // CHUNK_ROWS))
    KERNEL.launch(
        "qtt_paged_chunk_attention", launch_key(B, S, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), starts.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        part.data_ptr(), part[rows * D if splits > 1 else 0:].data_ptr(), counters.data_ptr(),
        B, S, Hq, Hkv, page, D, P, n_pt, layer, chunk, splits, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def _check_int8(q, k_pages, v_pages, kv_scales, block_table, per_slot, layer, alibi_slopes):
    shapes = _check_common(q, k_pages, v_pages, block_table, per_slot, layer,
                           alibi_slopes, torch.int8)
    L, P, Hkv, page = k_pages.shape[:4]
    if page % 4 or page > 256:
        raise NotImplementedError(f"the INT8 paged kernels take page % 4 == 0, <= 256: {page}")
    check(kv_scales, "kv_scales", torch.float32, (L, P, 8, Hkv * page))
    return shapes


def paged_decode_attention_int8_cuda(
    q, k_pages, v_pages, kv_scales, block_table, lengths, layer, scale,
    alibi_slopes=None, window=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K5q on CUDA tensors (it quantizes q itself); same arguments
    as its plain version."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_int8(
        q, k_pages, v_pages, kv_scales, block_table, lengths, layer, alibi_slopes)
    out = torch.empty_like(q)
    KERNEL_INT8.launch(
        "qtt_paged_decode_attention_int8", launch_key(B, None, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), kv_scales.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, page, D, P, n_pt, layer, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def paged_chunk_attention_int8_cuda(
    q, k_pages, v_pages, kv_scales, block_table, starts, layer, scale,
    alibi_slopes=None, window=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K6q on CUDA tensors; same arguments as its plain version. K6's
    kernel over the codes: its plan (``chunk_split_plan``), partials and
    merge counters (``_CHUNK_COUNTERS``, shared with K6: each launch leaves
    them at zero)."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_int8(
        q, k_pages, v_pages, kv_scales, block_table, starts, layer, alibi_slopes)
    S = q.shape[1]
    gq = Hq // Hkv
    if q.data_ptr() % 16:  # the q rows are copied in 16-byte chunks
        q = q.clone()
    chunk, splits = chunk_split_plan(B, Hkv, S, gq, n_pt * page, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    rows = B * Hq * S * splits  # partial rows, [B, Hkv, S * gq, splits]
    part = torch.empty(rows * (D + 2) if splits > 1 else 2, dtype=torch.float32,
                       device=q.device)
    counters = _CHUNK_COUNTERS.get(q.device, B * Hkv * -(-S * gq // CHUNK_ROWS))
    KERNEL_INT8.launch(
        "qtt_paged_chunk_attention_int8", launch_key(B, S, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), kv_scales.data_ptr(),
        block_table.data_ptr(), starts.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        part.data_ptr(), part[rows * D if splits > 1 else 0:].data_ptr(), counters.data_ptr(),
        B, S, Hq, Hkv, page, D, P, n_pt, layer, chunk, splits, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def _dispatch(fns, q, k_pages, v_pages, block_table, per_slot, layer,
              scale, alibi_slopes, kv_scales, window, logit_softcap):
    """``fns``: (plain, cuda, int8 plain, int8 cuda)."""
    plain, cuda, plain_q, cuda_q = fns
    if k_pages.ndim == 4 and kv_scales is not None:  # one layer's pages
        kv_scales = kv_scales[None]
    k_pages, v_pages, layer = _stacks(k_pages, v_pages, layer)
    L, P, Hkv, page = k_pages.shape[:4]
    if kv_scales is not None and tuple(kv_scales.shape) != (L, P, 8, Hkv * page):
        raise ValueError(f"kv_scales: expected the pages' scale tiles {(L, P, 8, Hkv * page)}, "
                         f"got {tuple(kv_scales.shape)}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    args = (layer, scale, alibi_slopes, window, logit_softcap)
    pages = (k_pages, v_pages) if kv_scales is None else (k_pages, v_pages, kv_scales)
    if q.device.type != "cuda":
        return (plain if kv_scales is None else plain_q)(q, *pages, block_table, per_slot, *args)
    return (cuda if kv_scales is None else cuda_q)(
        q.contiguous(), *pages, block_table.to(torch.int32).contiguous(),
        per_slot.to(torch.int32).contiguous(), *args,
    )


def paged_decode_attention(
    q: torch.Tensor,            # [B, Hq, D] one decode step's queries
    k_pages: torch.Tensor,      # [L, P, Hkv, page, D] (or [P, Hkv, page, D])
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, n_pt] int physical page ids
    lengths: torch.Tensor,      # [B] int valid tokens per slot (incl. current)
    layer: int = 0,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_scales: Optional[torch.Tensor] = None,  # [L, P, 8, Hkv*page] f32
    # scale tiles of INT8 pages (or one layer's [P, 8, Hkv*page])
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, Hq, D]. The current step's K/V must already be in the
    pages (the cache updates before attention)."""
    return _dispatch(
        (paged_decode_attention_plain, paged_decode_attention_cuda,
         paged_decode_attention_int8_plain, paged_decode_attention_int8_cuda),
        q, k_pages, v_pages, block_table, lengths, layer, scale, alibi_slopes,
        kv_scales, window, logit_softcap,
    )


def paged_chunk_attention(
    q: torch.Tensor,            # [B, S, Hq, D] one chunk of queries per slot
    k_pages: torch.Tensor,      # [L, P, Hkv, page, D] (or [P, Hkv, page, D])
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, n_pt] int physical page ids
    starts: torch.Tensor,       # [B] int tokens cached BEFORE this chunk
    layer: int = 0,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_scales: Optional[torch.Tensor] = None,  # as paged_decode_attention
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the pages; returns [B, S, Hq, D]. The
    chunk's own K/V must already be in the pages."""
    return _dispatch(
        (paged_chunk_attention_plain, paged_chunk_attention_cuda,
         paged_chunk_attention_int8_plain, paged_chunk_attention_int8_cuda),
        q, k_pages, v_pages, block_table, starts, layer, scale, alibi_slopes,
        kv_scales, window, logit_softcap,
    )
