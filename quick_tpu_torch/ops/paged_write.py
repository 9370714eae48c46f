"""Paged KV cache writes: CUDA kernel K4 (decode and chunk entries) and its
plain version.

Port of ``quick_tpu/ops/paged_write.py``: ``paged_write_decode`` (:92)
writes one token per slot, ``paged_write_chunk`` (:304) a chunk of up to
``page_size`` tokens per slot that spans at most two pages. Pages are
[L, P, Hkv, page, D]. The JAX functions return new page arrays; here the
pages are written IN PLACE and the same tensors are returned, so the
``(k_pages, v_pages)`` contract holds.

Both keep the Pallas kernels' precondition that ``page_size`` is a multiple
of the dtype's read-modify-write group (``_group_for`` :33, :116-125), so
that the port takes the same branch as the JAX package; the CUDA kernel
itself writes single rows and does not need it (ROADMAP "gates carry TPU
limits"). The addressing is the Pallas kernels': the chunk's token i lands
at in-page row ``offs[b] + i`` of ``page_ids[b, 0]`` while that is inside
the page, else at row ``offs[b] + i - page`` of ``page_ids[b, 1]``, and
only tokens ``i < valid[b]`` are written. The INT8 (quantized-page)
variants are not ported (ROADMAP B7).
"""
from __future__ import annotations

from typing import Tuple

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, i32, ptr, stream_ptr

#: K4. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by entry
#: ("decode ..." or "chunk ...") and shape.
KERNEL = CudaKernel(
    "paged_write.cu",
    {"qtt_paged_write": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, ptr,
    ]},
)


def launch_key(entry: str, B: int, S: int, Hkv: int, page: int, D: int,
               dtype: torch.dtype) -> str:
    """The ``launches_by_key`` key of one K4 launch (``entry``: "decode" or
    "chunk")."""
    return f"{entry} B={B} S={S} Hkv={Hkv} page={page} D={D} {dtype}"


def group_for(dtype: torch.dtype) -> int:
    """Token rows per RMW block of the Pallas kernels (``_group_for`` :33):
    f32 8, bf16 16, int8 32."""
    return max(8, 32 // dtype.itemsize)


def _check_group(k_pages: torch.Tensor) -> None:
    page = k_pages.shape[-2]
    grp = group_for(k_pages.dtype)
    if page % grp:
        raise ValueError(
            f"page_size {page} must be a multiple of the {k_pages.dtype} "
            f"RMW group ({grp}) — the JAX kernel's aligned group block would "
            "cross into the next page"
        )


def _token_addresses(page_ids, offs, valid, S: int, page: int):
    """(page [B, S], row [B, S], written [B, S]) of every chunk token, as
    the Pallas chunk kernel addresses them."""
    i = torch.arange(S, device=offs.device)[None, :]
    r = offs.to(torch.int64)[:, None] + i
    second = r >= page
    pg = torch.where(second, page_ids[:, 1:2], page_ids[:, 0:1]).to(torch.int64)
    row = torch.where(second, r - page, r)
    return pg, row, i < valid.to(torch.int64)[:, None]


def paged_write_plain(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, S, Hkv, D]
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B, 2] (first, second span page)
    offs: torch.Tensor,      # [B] in-page row of token 0
    valid: torch.Tensor,     # [B] tokens written
    layer: int,
) -> None:
    """Plain version of K4 (both entries): an ``index_put_`` scatter of the
    written tokens' [Hkv, D] rows."""
    B, S = k_new.shape[:2]
    pg, row, ok = _token_addresses(page_ids, offs, valid, S, k_pages.shape[3])
    pg, row = pg[ok], row[ok]
    k_pages[layer, pg, :, row] = k_new[ok].to(k_pages.dtype)
    v_pages[layer, pg, :, row] = v_new[ok].to(v_pages.dtype)


def paged_write_cuda(
    k_pages, v_pages, k_new, v_new, page_ids, offs, valid, layer: int,
) -> None:
    """Launch K4 on CUDA tensors; same arguments as the plain version,
    except that the decode entry passes one ``page_ids`` column and no
    ``valid`` (every token written), the chunk entry two columns and
    ``valid``."""
    L, P, Hkv, page, D = k_pages.shape
    B, S = k_new.shape[:2]
    esize = k_pages.element_size()
    if (D * esize) % 16:
        raise NotImplementedError(f"K4 copies 16-byte chunks: D={D} x {esize} B")
    if S > page or not 0 <= layer < L:
        raise ValueError(f"chunk S={S} > page {page} or layer {layer} outside {L}")
    check(k_pages, "k_pages", k_pages.dtype)
    check(v_pages, "v_pages", k_pages.dtype, k_pages.shape)
    check(k_new, "k_new", k_pages.dtype, (B, S, Hkv, D))
    check(v_new, "v_new", k_pages.dtype, (B, S, Hkv, D))
    n_pg = page_ids.shape[1]
    check(page_ids, "page_ids", torch.int32, (B, n_pg))
    check(offs, "offs", torch.int32, (B,))
    if valid is not None:
        check(valid, "valid", torch.int32, (B,))
    KERNEL.launch(
        "qtt_paged_write",
        launch_key("decode" if valid is None else "chunk", B, S, Hkv, page, D, k_pages.dtype),
        k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), offs.data_ptr(),
        None if valid is None else valid.data_ptr(), B, S, Hkv, page,
        D * esize, P, layer, n_pg, L, stream_ptr(k_new.device),
    )


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def paged_write_decode(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, Hkv, D], one token per slot
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B] physical page per token
    offs: torch.Tensor,      # [B] in-page row per token
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token per slot into ``layer``; returns the page tensors,
    updated in place."""
    _check_group(k_pages)
    kn = k_new[:, None].to(k_pages.dtype)
    vn = v_new[:, None].to(v_pages.dtype)
    if k_pages.device.type != "cuda":
        B = k_new.shape[0]
        paged_write_plain(
            k_pages, v_pages, kn, vn, page_ids.reshape(B, 1).expand(B, 2),
            offs, torch.ones(B, dtype=torch.int32), layer,
        )
    else:
        paged_write_cuda(
            k_pages, v_pages, kn.contiguous(), vn.contiguous(),
            _i32(page_ids).reshape(-1, 1), _i32(offs), None, layer,
        )
    return k_pages, v_pages


def paged_write_chunk(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, S, Hkv, D], S <= page
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B, 2] the chunk's (first, second) page
    offs: torch.Tensor,      # [B] in-page row of the chunk's first token
    valid: torch.Tensor,     # [B] tokens of the chunk actually fed
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-prefill page write; returns the page tensors, updated in
    place."""
    _check_group(k_pages)
    S, page = k_new.shape[1], k_pages.shape[3]
    if S > page:
        raise ValueError(f"chunk S={S} must be <= page_size={page}")
    kn = k_new.to(k_pages.dtype)
    vn = v_new.to(v_pages.dtype)
    if k_pages.device.type != "cuda":
        paged_write_plain(k_pages, v_pages, kn, vn, page_ids, offs, valid, layer)
    else:
        paged_write_cuda(
            k_pages, v_pages, kn.contiguous(), vn.contiguous(), _i32(page_ids),
            _i32(offs), _i32(valid), layer,
        )
    return k_pages, v_pages
