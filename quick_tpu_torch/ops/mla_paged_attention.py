"""Paged MLA decode attention (DeepSeek-V2 / V3): CUDA kernels K10 (bf16
latent pages) and K10q (INT8 latent pages), and their plain version.

Port of ``quick_tpu/ops/mla_paged_attention.py::mla_paged_decode_attention``
(:140) with its arguments: the absorbed queries q_c = q_nope @ W_UK
[B, Hq, R] and the rope'd q_pe [B, Hq, dr], the WHOLE page stacks of the
latent cache (k plane: k_pe [L, P, 1, page, dr]; v plane: the latent
[L, P, 1, page, R]) plus ``layer``, the block table and the per-slot
lengths (current token included) on the device, and for INT8 pages the
[L, P, 8, page] scale tiles (row 0 the k_pe scales, row 1 the latent
scales). Returns the latent-space context [B, Hq, R] in q_c's dtype; the
caller re-projects it through W_UV (modules/mla.py).

CUDA tensors go to ``csrc/mla_paged_attention.cu``, one tensor-core key
split instantiated for both page dtypes; CPU tensors to the plain version,
which gathers the slot's pages and computes the Pallas kernel's arithmetic
over all of them at once: scores (q_c . c + q_pe . k_pe) * scale, on INT8
pages (s_c * cs + s_pe * ks) * scale over the codes; an f32 softmax masked
at the length; p (times cs on INT8 pages) rounded to the page dtype (bf16
for INT8 codes) before the p @ c product; l == 0 -> 1. The kernels run the
same softmax online, so the two differ by where p is rounded (against a
running or the final max) and by the f32 sums' order. Both kernels split
each slot's tokens over blocks (``split_plan``) and merge the splits in
split order; ``mla_paged_decode_attention_split_plain`` models that
arithmetic (64-token tiles, p rounded against each split's running max).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)
from quick_tpu_torch.ops.paged_attention import gather_pages

#: K10 and K10q (one source). ``KERNEL.launches`` counts both;
#: ``launches_by_key`` splits them by page dtype and shape (``launch_key``).
KERNEL = CudaKernel(
    "mla_paged_attention.cu",
    {"qtt_mla_paged_decode": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32, f32, i32, ptr,
    ]},
)
#: (R, dr) the kernel is built for: DeepSeek-V2 / V3's kv_lora_rank and
#: qk_rope_head_dim
KERNEL_WIDTHS = ((512, 64),)
TILE = 64  # tokens per staged tile; a split's chunk is a multiple of it
HEADS = 16  # query heads a block
NEG_INF = -1e30
#: the merge counters of both kernels, zero between launches (one launch at
#: a time on a device: K10 and K10q share them)
_COUNTERS = ZeroedWords("K10 / K10q")
MAX_CHUNK = 1024  # tokens of a split at most
MAX_PAGES = MAX_CHUNK // 16 + 2  # pages of a split at most (the kernel's page-id list)


def launch_key(B: int, Hq: int, R: int, dr: int, page: int, n_pt: int, int8: bool) -> str:
    """The ``launches_by_key`` key of one launch ("int8 ..." for K10q)."""
    return f"{'int8' if int8 else 'bf16'} B={B} Hq={Hq} R={R} dr={dr} page={page} n_pt={n_pt}"


def split_plan(B: int, n_pt: int, page: int, n_sm: int) -> Tuple[int, int]:
    """(splits, chunk) of K10 / K10q, from the shapes only, never from the
    lengths: the key range [0, n_pt * page) cut into ``splits`` chunks of
    ``chunk`` tokens (a multiple of the 64-token tile) so that B x splits
    blocks fill about ``n_sm`` SMs, with the chunk cut to ``MAX_CHUNK``
    tokens and to what keeps a split's pages within the kernel's
    ``MAX_PAGES`` page ids at any start (at most (chunk - 1) // page + 2
    pages)."""
    T = n_pt * page
    tiles = -(-T // TILE)
    want = max(1, min(tiles, -(-n_sm // B)))
    chunk = -(-tiles // want) * TILE
    chunk = min(chunk, MAX_CHUNK, (MAX_PAGES - 1) * page // TILE * TILE)
    return -(-T // chunk), chunk


def mla_paged_decode_attention_plain(
    q_c: torch.Tensor, q_pe: torch.Tensor, kpe_pages: torch.Tensor,
    c_pages: torch.Tensor, block_table: torch.Tensor, lengths: torch.Tensor,
    layer: int, scale: float, kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K10 / K10q on any device; returns [B, Hq, R] in
    q_c's dtype."""
    B, Hq, R = q_c.shape
    c = gather_pages(c_pages, block_table, layer)[:, 0].to(torch.float32)  # [B, T, R]
    kpe = gather_pages(kpe_pages, block_table, layer)[:, 0].to(torch.float32)  # [B, T, dr]
    T = c.shape[1]
    s_c = torch.einsum("bhr,btr->bht", q_c.to(torch.float32), c)
    s_pe = torch.einsum("bhd,btd->bht", q_pe.to(torch.float32), kpe)
    cs = None
    if kv_scales is not None:
        n_pt, page = block_table.shape[1], c_pages.shape[3]
        tiles = kv_scales[layer][block_table.long()]  # [B, n_pt, 8, page]
        ks = tiles[:, :, 0].reshape(B, 1, n_pt * page)
        cs = tiles[:, :, 1].reshape(B, 1, n_pt * page)
        s = (s_c * cs + s_pe * ks) * scale
    else:
        s = (s_c + s_pe) * scale
    t = torch.arange(T, device=q_c.device).reshape(1, 1, T)
    mask = t < lengths.to(q_c.device, torch.int64).reshape(B, 1, 1)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if cs is not None:
        p = p * cs
    p_dtype = torch.bfloat16 if kv_scales is not None else c_pages.dtype
    acc = torch.einsum("bht,btr->bhr", p.to(p_dtype).to(torch.float32), c)
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q_c.dtype)


def mla_paged_decode_attention_split_plain(
    q_c: torch.Tensor, q_pe: torch.Tensor, kpe_pages: torch.Tensor,
    c_pages: torch.Tensor, block_table: torch.Tensor, lengths: torch.Tensor,
    layer: int, scale: float, kv_scales: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None, splits: Optional[int] = None,
) -> torch.Tensor:
    """Plain model of K10 / K10q's split-and-merge arithmetic (the arguments of
    the plain version; one split by default): per slot and split, its
    64-token tiles up to the slot's length in an online softmax in f32, the
    scores in f32 from q as given, (s_c cs + s_pe ks) * scale on INT8
    pages; l sums the unrounded p; p (times cs on INT8 pages) rounded to
    bf16 (the pages' dtype for float pages) against the split's running max
    before p @ c; then the splits holding a token merged in split order, 0
    where none does. Returns [B, Hq, R] in q_c's dtype."""
    B, Hq, R = q_c.shape
    c = gather_pages(c_pages, block_table, layer)[:, 0].to(torch.float32)  # [B, T, R]
    kpe = gather_pages(kpe_pages, block_table, layer)[:, 0].to(torch.float32)
    T = c.shape[1]
    if chunk is None:
        chunk, splits = -(-T // TILE) * TILE, 1
    splits = -(-T // chunk) if splits is None else splits
    qc, qp = q_c.to(torch.float32), q_pe.to(torch.float32)
    ks = cs = None
    if kv_scales is not None:
        tiles = kv_scales[layer][block_table.long()]  # [B, n_pt, 8, page]
        ks, cs = (tiles[:, :, r].reshape(B, 1, T).to(torch.float32) for r in (0, 1))
    p_dtype = torch.bfloat16 if kv_scales is not None else c_pages.dtype
    end = torch.clamp(lengths.to(q_c.device, torch.int64), 0, T).reshape(B, 1, 1)
    t = torch.arange(T, device=q_c.device)
    parts = []
    for sp in range(splits):
        lo, hi = sp * chunk, torch.clamp(end, max=sp * chunk + chunk)
        m = torch.full((B, Hq, 1), NEG_INF, device=q_c.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hq, R), device=q_c.device)
        for t0 in range(lo, min(T, lo + chunk), TILE):
            t1 = min(t0 + TILE, T)
            s_c = torch.einsum("bhr,btr->bht", qc, c[:, t0:t1])
            s_pe = torch.einsum("bhd,btd->bht", qp, kpe[:, t0:t1])
            if ks is not None:
                s = (s_c * cs[..., t0:t1] + s_pe * ks[..., t0:t1]) * scale
            else:
                s = (s_c + s_pe) * scale
            mask = t[t0:t1].reshape(1, 1, -1) < hi
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if cs is not None:
                p = p * cs[..., t0:t1]
            acc = acc * alpha + torch.einsum("bht,btr->bhr", p.to(p_dtype).to(torch.float32),
                                             c[:, t0:t1])
            m = m_new
        parts.append((lo < hi, m, l, acc))
    big = torch.full((B, Hq, 1), NEG_INF, device=q_c.device)
    for live, m, _, _ in parts:
        big = torch.where(live, torch.maximum(big, m), big)
    lt = torch.zeros_like(big)
    acc = torch.zeros((B, Hq, R), device=q_c.device)
    for live, m, l, a in parts:  # in split order
        w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
        lt = lt + l * w
        acc = acc + w * a
    return (acc / torch.where(lt == 0, torch.ones_like(lt), lt)).to(q_c.dtype)


def mla_paged_decode_attention_cuda(
    q_c: torch.Tensor, q_pe: torch.Tensor, kpe_pages: torch.Tensor,
    c_pages: torch.Tensor, block_table: torch.Tensor, lengths: torch.Tensor,
    layer: int, scale: float, kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K10 (bf16 pages) or K10q (INT8 pages) on CUDA tensors; same
    arguments as the plain version, the queries in bf16. Their merge
    counters live on the device (``_COUNTERS``, made by an eager launch
    before any capture, since ``ZeroedWords.get`` raises inside one) and
    are shared by both kernels: one K10 / K10q launch at a time on a device
    (launches on one stream run in turn)."""
    B, Hq, R = q_c.shape
    dr = q_pe.shape[-1]
    L, P, Hkv, page, _ = c_pages.shape
    n_pt = block_table.shape[1]
    int8 = kv_scales is not None
    if (R, dr) not in KERNEL_WIDTHS:
        raise NotImplementedError(f"K10 is built for (R, dr) in {KERNEL_WIDTHS}, got {(R, dr)}")
    if Hkv != 1:
        raise ValueError(f"MLA latent pages hold one kv head, got {Hkv}")
    if int8 and (page < 16 or page & (page - 1)):
        raise NotImplementedError(f"K10q takes pages of 16 or more tokens, a power of two: {page}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside {L}")
    page_dtype = torch.int8 if int8 else torch.bfloat16
    check(q_c, "q_c", torch.bfloat16, (B, Hq, R))
    check(q_pe, "q_pe", torch.bfloat16, (B, Hq, dr))
    check(c_pages, "c_pages", page_dtype, (L, P, 1, page, R))
    check(kpe_pages, "kpe_pages", page_dtype, (L, P, 1, page, dr))
    if int8:
        check(kv_scales, "kv_scales", torch.float32, (L, P, 8, page))
    check(block_table, "block_table", torch.int32, (B, n_pt))
    check(lengths, "lengths", torch.int32, (B,))
    splits, chunk = split_plan(B, n_pt, page, sm_count(q_c.device.index or 0))
    out = q_c.new_empty((B, Hq, R))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((B, Hq, splits, R), dtype=torch.float32, device=q_c.device)
        part_ml = torch.empty((B, Hq, splits, 2), dtype=torch.float32, device=q_c.device)
    counters = _COUNTERS.get(q_c.device, B * -(-Hq // HEADS))
    KERNEL.launch(
        "qtt_mla_paged_decode", launch_key(B, Hq, R, dr, page, n_pt, int8),
        q_c.data_ptr(), q_pe.data_ptr(), kpe_pages.data_ptr(), c_pages.data_ptr(),
        kv_scales.data_ptr() if int8 else None, block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), counters.data_ptr(),
        B, Hq, R, dr, L, P, page, n_pt, layer, splits, chunk, float(scale), int(int8),
        stream_ptr(q_c.device),
    )
    return out


def mla_paged_decode_attention(
    q_c: torch.Tensor,          # [B, Hq, R] absorbed nope queries (q_nope @ W_UK)
    q_pe: torch.Tensor,         # [B, Hq, dr] rope'd positional queries
    kpe_pages: torch.Tensor,    # [L, P, 1, page, dr]: cache.k_pages
    c_pages: torch.Tensor,      # [L, P, 1, page, R]: cache.v_pages (latent)
    block_table: torch.Tensor,  # [B, n_pt] int page ids
    lengths: torch.Tensor,      # [B] int valid tokens (current one included)
    layer: int,
    scale: float,               # mla_softmax_scale(cfg), yarn mscale^2 included
    kv_scales: Optional[torch.Tensor] = None,  # [L, P, 8, page] f32 (INT8)
) -> torch.Tensor:
    """The latent-space context [B, Hq, R]: K10 / K10q on a CUDA tensor, the
    plain version on a CPU tensor. Pass the whole page (and scale) stacks
    plus ``layer``, as the JAX call site does."""
    args = (q_c, q_pe, kpe_pages, c_pages, block_table, lengths, int(layer), float(scale),
            kv_scales)
    if q_c.device.type != "cuda":
        return mla_paged_decode_attention_plain(*args)
    q_c, q_pe = q_c.to(torch.bfloat16).contiguous(), q_pe.to(torch.bfloat16).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ln = lengths.to(q_c.device, torch.int32).reshape(-1).expand(q_c.shape[0]).contiguous()
    out = mla_paged_decode_attention_cuda(q_c, q_pe, kpe_pages, c_pages, bt, ln, int(layer),
                                          float(scale), kv_scales)
    return out.to(args[0].dtype)
