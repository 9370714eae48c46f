"""Attention over the paged KV cache: CUDA kernels K5 (decode) and K6
(chunked prefill) and their plain versions.

Port of ``quick_tpu/ops/paged_attention.py``: ``paged_decode_attention``
(:437), ``paged_chunk_attention`` (:291) and ``supports_chunk`` (:279),
with the same arguments — the whole [L, P, Hkv, page, D] page stacks plus
``layer`` (or one layer's [P, Hkv, page, D]), block tables, per-slot
lengths or chunk starts on the device, window, softcap and ALiBi slopes.
CUDA tensors go to ``csrc/paged_attention.cu`` (bf16 pages); CPU tensors to
the plain version, which is the dense gather of the slot's pages
(``PagedKVCache.layer``) followed by the einsum attention, as the JAX
package's fallback does (blocks.py:440-452). INT8 pages (``kv_scales``)
are not ported (ROADMAP B8).
"""
from __future__ import annotations

from typing import Optional

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, f32, i32, ptr, stream_ptr
from quick_tpu_torch.ops.attention import einsum_attention

#: K5 and K6 (one source, two entry points). ``KERNEL.launches`` counts
#: both; ``launches_by_key`` splits them ("decode ..." / "chunk ...").
KERNEL = CudaKernel(
    "paged_attention.cu",
    {
        "qtt_paged_decode_attention": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, f32, i32, f32, ptr,
        ],
        "qtt_paged_chunk_attention": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, f32, i32, f32, ptr,
        ],
    },
)
KERNEL_HEAD_DIMS = (64, 128, 256)


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


def _check_common(q, k_pages, v_pages, block_table, per_slot, layer, alibi_slopes):
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
    check(k_pages, "k_pages", torch.bfloat16)
    check(v_pages, "v_pages", torch.bfloat16, k_pages.shape)
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
    """Launch K5 on CUDA tensors; same arguments as the plain version."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_common(
        q, k_pages, v_pages, block_table, lengths, layer, alibi_slopes)
    out = torch.empty_like(q)
    KERNEL.launch(
        "qtt_paged_decode_attention", launch_key(B, None, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, page, D, P, n_pt, layer, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def paged_chunk_attention_cuda(
    q, k_pages, v_pages, block_table, starts, layer, scale, alibi_slopes=None,
    window=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K6 on CUDA tensors; same arguments as the plain version."""
    B, Hq, Hkv, page, D, P, n_pt, slopes = _check_common(
        q, k_pages, v_pages, block_table, starts, layer, alibi_slopes)
    S = q.shape[1]
    out = torch.empty_like(q)
    KERNEL.launch(
        "qtt_paged_chunk_attention", launch_key(B, S, Hq, Hkv, page, D, n_pt),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), starts.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, page, D, P, n_pt, layer, float(scale), int(window or 0),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def _dispatch(plain, cuda, q, k_pages, v_pages, block_table, per_slot, layer,
              scale, alibi_slopes, kv_scales, window, logit_softcap):
    if kv_scales is not None:
        raise NotImplementedError(
            "INT8 KV pages (kv_scales) are not ported yet — ROADMAP B8"
        )
    k_pages, v_pages, layer = _stacks(k_pages, v_pages, layer)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    args = (layer, scale, alibi_slopes, window, logit_softcap)
    if q.device.type != "cuda":
        return plain(q, k_pages, v_pages, block_table, per_slot, *args)
    return cuda(
        q.contiguous(), k_pages, v_pages,
        block_table.to(torch.int32).contiguous(),
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
    kv_scales: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, Hq, D]. The current step's K/V must already be in the
    pages (the cache updates before attention)."""
    return _dispatch(
        paged_decode_attention_plain, paged_decode_attention_cuda, q, k_pages,
        v_pages, block_table, lengths, layer, scale, alibi_slopes, kv_scales,
        window, logit_softcap,
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
    kv_scales: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the pages; returns [B, S, Hq, D]. The
    chunk's own K/V must already be in the pages."""
    return _dispatch(
        paged_chunk_attention_plain, paged_chunk_attention_cuda, q, k_pages,
        v_pages, block_table, starts, layer, scale, alibi_slopes, kv_scales,
        window, logit_softcap,
    )
