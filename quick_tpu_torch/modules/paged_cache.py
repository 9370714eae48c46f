"""Paged KV cache with block tables (port of
``quick_tpu/modules/paged_cache.py``).

- K/V live in fixed-size pages ``[L, n_pages, H_kv, page_size, D]``.
- Each batch slot owns a row of a block table mapping logical position
  ``p`` to physical page ``block_table[slot, p // page_size]``.
- Page 0 is the TRASH page: unallocated table entries point at it, so
  padded and out-of-range writes land there harmlessly (attention masks
  them by length, and the allocator never hands page 0 out).

The block table and the per-slot ``length`` are int32 tensors on the
cache's device, so a serving step never needs their values on the host.
The JAX cache is immutable and returns updated copies; here ``update``
writes the pages IN PLACE (the page-write kernels K4 / K4q, or the plain
scatter) and returns the cache object itself. ``with_length`` and
``select`` return new views that share the page tensors (and scale tiles).
``PageAllocator`` is the host-side free list.

INT8 pages (``create(dtype=torch.int8)``) hold per-token-per-head absmax
codes; their f32 scales live in ``kv_scales`` [L, P, 8, Hkv*page], the JAX
package's layout kept byte for byte: one tile per page, row 0 the k
scales and row 1 the v scales at column ``head * page + token``, rows 2-7
padding (a TPU tile; ROADMAP notes a leaner layout for the card).

DeepSeek's MLA latent pages (``create(..., v_head_dim=)``, JAX :75-95) hold
one kv head with planes of unequal width: the rope'd k_pe
[L, P, 1, page, dr] in ``k_pages`` and the latent [L, P, 1, page, R] in
``v_pages``; their INT8 tiles keep the same layout (row 0 the k_pe scales,
row 1 the latent scales), and ``layer`` gathers each plane at its own width.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from quick_tpu_torch.device import DeviceLike, resolve_device
from quick_tpu_torch.ops.paged_attention import gather_pages
from quick_tpu_torch.ops.paged_write import (
    group_for,
    paged_write_chunk,
    paged_write_decode,
    quantize_kv,
)

TRASH_PAGE = 0


@dataclasses.dataclass
class PagedKVCache:
    """Block-table KV cache for ``max_slots`` concurrent sequences.

    k_pages / v_pages: [L, n_pages, H_kv, page_size, D] (v: D_v, which
                       differs from D on MLA latent pages)
    block_table:       [max_slots, max_pages_per_seq] int32 page ids
    length:            [max_slots] int32 valid tokens per slot
    kv_scales:         [L, n_pages, 8, H_kv * page_size] f32 scale tiles of
                       INT8 pages (row 0 k, row 1 v); None for float pages
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    length: torch.Tensor
    kv_scales: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls, n_layers: int, n_pages: int, page_size: int, max_slots: int,
        max_seq: int, n_kv: int, head_dim: int,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
        v_head_dim: Optional[int] = None,
    ) -> "PagedKVCache":
        """A zeroed cache on ``device`` (the card unless given "cpu");
        every table entry points at the trash page. ``torch.int8`` makes
        INT8 pages with their scale tiles. ``v_head_dim`` widens the v
        plane (MLA: the k plane holds k_pe, the v plane the latent)."""
        dev = resolve_device(device)
        n_pt = (max_seq + page_size - 1) // page_size
        shape = (n_layers, n_pages, n_kv, page_size, head_dim)
        quant = dtype == torch.int8
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=dev),
            v_pages=torch.zeros(shape[:-1] + (v_head_dim or head_dim,), dtype=dtype, device=dev),
            block_table=torch.full((max_slots, n_pt), TRASH_PAGE, dtype=torch.int32, device=dev),
            length=torch.zeros((max_slots,), dtype=torch.int32, device=dev),
            kv_scales=(torch.zeros((n_layers, n_pages, 8, n_kv * page_size),
                                   dtype=torch.float32, device=dev) if quant else None),
        )

    @property
    def quantized(self) -> bool:
        return self.kv_scales is not None

    # -- geometry -------------------------------------------------------------
    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_slots(self) -> int:
        return self.block_table.shape[0]

    @property
    def max_seq(self) -> int:
        return self.block_table.shape[1] * self.page_size

    # -- device-side ops -------------------------------------------------------
    def update(
        self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
        start: torch.Tensor,
    ) -> "PagedKVCache":
        """Write k_new / v_new [B, S, H_kv, D] at logical positions
        ``start[b] + j`` of ``layer``, in place. Positions past ``max_seq``
        go to the trash page; other out-of-range positions hit
        allocated-or-trash pages and are masked by ``length`` when read.

        The routing is the JAX package's (:141-232) with the card in the
        TPU's place: chunks of 2..page_size tokens and single tokens go to
        the page-write kernel (K4, or K4q for INT8 pages, which quantizes
        the rows itself) when the page size is a multiple of the dtype's
        group (INT8: 32), anything else (and every CPU tensor) to a
        scatter, which for INT8 pages quantizes first (``quantize_kv``) and
        scatters the scales into the tiles too."""
        B, S = k_new.shape[:2]
        page = self.page_size
        n_pt = self.block_table.shape[1]
        pos = start.reshape(-1, 1).to(torch.int64) + torch.arange(S, device=start.device)
        page_slot = torch.clamp(pos // page, max=n_pt - 1)
        pg = torch.gather(self.block_table, 1, page_slot)  # [B, S]
        # positions past the table's capacity go to the TRASH page —
        # clamping alone would overwrite the slot's own last real page
        pg = torch.where(pos < self.max_seq, pg, torch.full_like(pg, TRASH_PAGE))
        off = pos % page
        kernel_ok = page % group_for(self.k_pages.dtype) == 0 and self.k_pages.is_cuda
        if 1 < S <= page and kernel_ok:
            # every chunk row is written (valid = S): padding rows land on
            # future-own or trash pages as in the scatter, masked at read.
            # The second span page is the first token's past the page
            # boundary; a chunk that does not cross aims it at the trash
            # page (no row of it is written)
            i_star = torch.clamp(page - off[:, :1], 0, S - 1)
            pg2 = torch.gather(pg, 1, i_star)[:, 0]
            crossing = off[:, 0] + S > page
            pg2 = torch.where(crossing, pg2, torch.full_like(pg2, TRASH_PAGE))
            pgs = torch.stack([pg[:, 0].to(torch.int32), pg2], dim=1)
            valid = torch.full((B,), S, dtype=torch.int32, device=pg.device)
            paged_write_chunk(self.k_pages, self.v_pages, k_new, v_new, pgs,
                              off[:, 0], valid, layer, kv_scales=self.kv_scales)
        elif S == 1 and kernel_ok:
            paged_write_decode(self.k_pages, self.v_pages, k_new[:, 0],
                               v_new[:, 0], pg[:, 0], off[:, 0], layer,
                               kv_scales=self.kv_scales)
        else:
            if self.quantized:
                (k_new, ks), (v_new, vs) = quantize_kv(k_new), quantize_kv(v_new)
            # [L, P, H, page, D]: the advanced indices (page, off) straddle
            # the head axis, so the indexed shape is [B, S, H, D] = k_new's
            self.k_pages[layer, pg, :, off] = k_new.to(self.k_pages.dtype)
            self.v_pages[layer, pg, :, off] = v_new.to(self.v_pages.dtype)
            if self.quantized:
                # token (slot, j)'s head h scale -> column h * page + off
                H = k_new.shape[2]
                col = torch.arange(H, device=off.device) * page + off[:, :, None]
                self.kv_scales[layer, pg[:, :, None], 0, col] = ks
                self.kv_scales[layer, pg[:, :, None], 1, col] = vs
        return self

    def layer(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense head-major [B, H_kv, max_seq, D] gather of layer ``i``'s
        pages (the contract of ``KVCache.layer``); INT8 pages come back
        dequantized in bf16 (codes and scales rounded to bf16, then one
        bf16 product), as the JAX package's ``layer`` does."""
        k = gather_pages(self.k_pages, self.block_table, i)
        v = gather_pages(self.v_pages, self.block_table, i)
        if not self.quantized:
            return k, v
        B, H = k.shape[:2]
        n_pt, page = self.block_table.shape[1], self.page_size
        sc = self.kv_scales[i][self.block_table.long()]  # [B, n_pt, 8, H*page]

        def per_token(row):  # [B, n_pt, H*page] -> [B, H, n_pt*page, 1]
            t = row.reshape(B, n_pt, H, page).transpose(1, 2)
            return t.reshape(B, H, n_pt * page, 1).to(torch.bfloat16)

        return (k.to(torch.bfloat16) * per_token(sc[:, :, 0]),
                v.to(torch.bfloat16) * per_token(sc[:, :, 1]))

    def with_length(self, length: torch.Tensor) -> "PagedKVCache":
        return dataclasses.replace(self, length=length.to(torch.int32))

    # -- sub-batch views (decoupled prefill, runtime/serving.py) ---------------
    def select(self, slot_ids: torch.Tensor, row_valid: torch.Tensor) -> "PagedKVCache":
        """Sub-batch VIEW over the same page pool: block-table rows and
        lengths gathered for ``slot_ids``; rows with ``row_valid`` False get
        all-trash table rows and length 0, so any slot id works as padding.
        The pages are shared: writes through the view write the cache, and
        ``merge`` folds the lengths back."""
        ids = slot_ids.long()
        bt = torch.where(row_valid[:, None], self.block_table[ids],
                         torch.full_like(self.block_table[ids], TRASH_PAGE))
        ln = torch.where(row_valid, self.length[ids], torch.zeros_like(self.length[ids]))
        return dataclasses.replace(self, block_table=bt, length=ln)

    def merge(self, sub: "PagedKVCache", slot_ids: torch.Tensor,
              row_valid: torch.Tensor) -> "PagedKVCache":
        """Fold a ``select`` view's lengths back by scatter-max: max makes
        duplicate and padding slot ids harmless (lengths only grow between
        retirements, and invalid rows contribute 0). The pages and scale
        tiles are already shared."""
        upd = torch.where(row_valid, sub.length, torch.zeros_like(sub.length))
        ln = self.length.scatter_reduce(0, slot_ids.long(), upd, reduce="amax")
        return dataclasses.replace(self, k_pages=sub.k_pages, v_pages=sub.v_pages,
                                   kv_scales=sub.kv_scales, length=ln)


class PageAllocator:
    """Host-side page free-list. Page 0 is never handed out (trash page)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free: List[int] = list(range(1, n_pages))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, or None if not enough free."""
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        return pages

    def release(self, pages: List[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot release the trash page")
        self._free.extend(pages)
