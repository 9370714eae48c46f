"""Paged KV cache writes: CUDA kernels K4 (bf16 / f32 pages) and K4q (INT8
pages), each with a decode and a chunk entry, and their plain versions.

Port of ``quick_tpu/ops/paged_write.py``: ``paged_write_decode`` (:92)
writes one token per slot, ``paged_write_chunk`` (:304) a chunk of up to
``page_size`` tokens per slot that spans at most two pages. Pages are
[L, P, Hkv, page, D]; the v plane may be wider than the k plane (DeepSeek's
MLA latent pages: Hkv = 1, k_pe 64 wide, the latent 512, as the JAX
kernels take them, :127, :326-327). The JAX functions return new page arrays; here the
pages are written IN PLACE and the same tensors are returned, so the
``(k_pages, v_pages)`` contract holds.

Both keep the Pallas kernels' precondition that ``page_size`` is a multiple
of the dtype's read-modify-write group (``_group_for`` :33, :116-125), so
that the port takes the same branch as the JAX package; the CUDA kernel
itself writes single rows and does not need it (ROADMAP "gates carry TPU
limits"). The addressing is the Pallas kernels': the chunk's token i lands
at in-page row ``offs[b] + i`` of ``page_ids[b, 0]`` while that is inside
the page, else at row ``offs[b] + i - page`` of ``page_ids[b, 1]``, and
only tokens ``i < valid[b]`` are written.

INT8 pages (``kv_scales`` given, the [L, P, 8, Hkv*page] f32 tiles of
``PagedKVCache``): each token's int8 codes go to its page row and its
per-head k and v scales to column ``h * page + row`` of rows 0 and 1 of
the page's tile, as ``_write_kernel_quant`` (:40) and
``_chunk_write_kernel_quant`` (:262) write them. The new rows are either
int8 codes with their scales ``ks_new`` / ``vs_new`` (the JAX functions'
signature) or float rows, which are quantized first with ``quantize_kv``
(``PagedKVCache._quantize_kv``'s numerics; on the card inside K4q, so a
page write is one launch). K4q reads each row once: a group of lanes holds
the row in registers, 16-byte units a lane, with every load of the lane
started before any is used, and writes the codes as 8- or 16-byte stores;
``int8_write_plan`` picks the lanes a row and the rows a block (and the
scalar path for widths of no whole unit or pointers off 16 bytes), and
``int8_write_lane`` models the kernel's map from lanes to rows. K4 is the
same body's copy kind (``csrc/paged_write_rows.cuh``): bf16 / f32 rows
copied as 16-byte units with no scale tile, planned by ``copy_write_plan``
over the rows' bytes; ``write_lane_units`` models which units (or, on the
scalar path, which elements) each lane writes. Both are programmatic
dependent launches (``WRITE_PDL``).
"""
from __future__ import annotations

import os

from typing import NamedTuple, Optional, Tuple

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, i32, ptr, stream_ptr

#: K4. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by entry
#: ("decode ..." or "chunk ...") and shape.
KERNEL = CudaKernel(
    "paged_write.cu",
    {"qtt_paged_write": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
    ]},
)
#: K4 as a programmatic dependent launch (False: a plain one, for a
#: measurement's comparison); K4q always is one
WRITE_PDL = True


#: K4q, the INT8 page write (one library of its own, so its launches count
#: apart from K4's); keys as ``launch_key`` with ``torch.int8``.
KERNEL_INT8 = CudaKernel(
    "paged_write_int8.cu",
    {"qtt_paged_write_int8": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
    ]},
)
#: K4q's input kinds: float rows it quantizes, or int8 codes it copies
_IN_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
#: K4's kind: rows of any dtype copied as bytes (``kCopy``)
COPY_KIND = 3
#: the unit by input kind, in values: what a lane loads at once (one
#: 16-byte vector of bf16 or of int8 codes, two of f32) and writes as one
#: code store (8 bytes, 16 for copied codes); K4's in bytes, 16
WRITE_UNIT = {0: 8, 1: 8, 2: 16, COPY_KIND: 16}
WRITE_MAX_UNITS = 4  # units a lane holds at most (``kMaxUnits``)
WRITE_LANES = 256  # lanes a block aims at


class Int8WritePlan(NamedTuple):
    """K4q's launch plan: per plane log2 of the lanes a row and the units a
    lane (0: the scalar path, a warp a row), tokens and heads a block."""
    lgk: int
    vk: int
    lgv: int
    vv: int
    tokens_per_block: int
    heads_per_block: int

    @property
    def threads(self) -> int:
        """A block's threads: its rows' lanes (tokens x heads x both planes'
        groups) in whole warps."""
        lanes = self.tokens_per_block * self.heads_per_block * ((1 << self.lgk) + (1 << self.lgv))
        return -(-lanes // 32) * 32

    def grid(self, tokens: int, Hkv: int) -> Tuple[int, int]:
        return -(-tokens // self.tokens_per_block), -(-Hkv // self.heads_per_block)


def _plane_plan(D: int, kind: int, aligned: bool) -> Tuple[int, int]:
    """(log2 lanes, units a lane) of one plane's rows: the fewest lanes (a
    power of two, at most a warp) whose units cover the row's, or (5, 0), the
    scalar path, for a width of no whole units, more than 32 x
    ``WRITE_MAX_UNITS`` units, or pointers off 16 bytes."""
    values = WRITE_UNIT[kind]
    units = D // values
    if not aligned or D % values or units > 32 * WRITE_MAX_UNITS:
        return 5, 0
    lg = min(5, (units - 1).bit_length())
    return lg, -(-units // (1 << lg))


def int8_write_plan(Hkv: int, Dk: int, Dv: int, kind: int, tokens: int,
                    aligned: bool = True) -> Int8WritePlan:
    """K4q's plan for ``tokens`` (B x S) rows of ``Hkv`` heads: every head
    of a token in one block where both planes' lanes fit ``WRITE_LANES``, as
    many tokens as fit beside it (Mistral's 8 heads x 2 x 16 lanes: one;
    DeepSeek's latent, 32 + 8 lanes: six); else one token and as many heads
    as fit."""
    lgk, vk = _plane_plan(Dk, kind, aligned)
    lgv, vv = _plane_plan(Dv, kind, aligned)
    per_head = (1 << lgk) + (1 << lgv)
    if Hkv * per_head <= WRITE_LANES:
        return Int8WritePlan(lgk, vk, lgv, vv, max(1, min(tokens, WRITE_LANES // (Hkv * per_head))),
                             Hkv)
    return Int8WritePlan(lgk, vk, lgv, vv, 1, max(1, WRITE_LANES // per_head))


def copy_write_plan(Hkv: int, Dk: int, Dv: int, esize: int, tokens: int,
                    aligned: bool = True) -> Int8WritePlan:
    """K4's plan: ``int8_write_plan``'s in the copy kind over the rows'
    bytes (``Dk`` / ``Dv`` values of ``esize`` bytes): Mistral's bf16 128-
    wide rows 16 lanes of one unit, 8 heads x two planes a block of 256
    lanes; DeepSeek's latent planes 8 + 32 lanes, six tokens a block."""
    return int8_write_plan(Hkv, Dk * esize, Dv * esize, COPY_KIND, tokens, aligned)


def write_lane_units(plan: Int8WritePlan, plane: int, lane: int, D: int, kind: int):
    """What lane ``lane`` of a plane-``plane`` row writes under ``plan``
    (``D`` the plane's width in the kind's values, bytes for K4): ("units",
    [u, ...]) of ``WRITE_UNIT[kind]`` values each, or ("values", [d, ...])
    on the scalar path, as the kernel's loops run."""
    lg, V = (plan.lgv, plan.vv) if plane else (plan.lgk, plan.vk)
    G = 1 << lg
    if V == 0:
        return "values", list(range(lane, D, G))
    units = D // WRITE_UNIT[kind]
    return "units", [lane + (v << lg) for v in range(min(V, WRITE_MAX_UNITS))
                     if lane + (v << lg) < units]


def int8_write_lane(plan: Int8WritePlan, tokens: int, Hkv: int, bx: int, by: int, t: int):
    """The row of thread ``t`` of block (``bx``, ``by``) under ``plan``, as
    K4q computes it: (plane, token, head, lane in the row's group), or None
    for a lane that holds no row."""
    T, HB = plan.tokens_per_block, plan.heads_per_block
    first = 1 if plan.lgv >= plan.lgk else 0
    n_first = (T * HB) << (plan.lgv if first else plan.lgk)
    local, plane = t, first
    if local >= n_first:
        local, plane = local - n_first, 1 - first
    lg = plan.lgv if plane else plan.lgk
    task = local >> lg
    tok, hl = task // HB, task % HB
    n, h = bx * T + tok, by * HB + hl
    if tok >= T or n >= tokens or h >= Hkv:
        return None
    return plane, n, h, local & ((1 << lg) - 1)


def launch_key(entry: str, B: int, S: int, Hkv: int, page: int, D: int,
               dtype: torch.dtype, Dv: Optional[int] = None) -> str:
    """The ``launches_by_key`` key of one K4 launch (``entry``: "decode" or
    "chunk"); the v plane's width ``Dv`` is named where it differs from
    the k plane's ``D``."""
    dv = f" Dv={Dv}" if Dv is not None and Dv != D else ""
    return f"{entry} B={B} S={S} Hkv={Hkv} page={page} D={D}{dv} {dtype}"


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
    the Pallas chunk kernel addresses them; written is None where ``valid``
    is (every token)."""
    i = torch.arange(S, device=offs.device)[None, :]
    r = offs.to(torch.int64)[:, None] + i
    second = r >= page
    pg = torch.where(second, page_ids[:, 1:2], page_ids[:, 0:1]).to(torch.int64)
    row = torch.where(second, r - page, r)
    return pg, row, None if valid is None else i < valid.to(torch.int64)[:, None]


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as an IEEE division on every device, as the INT8 kernels
    and the JAX package's eager ops compute it: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal instead, one rounding off."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric INT8 (``_quantize_kv``,
    quick_tpu/modules/paged_cache.py:317): x [..., D] -> (codes int8
    [..., D], scales f32 [...]); f32 absmax, ``max(amax / 127, 1e-8)``,
    round half to even, clip to +-127."""
    xf = x.to(torch.float32)
    scale = torch.clamp(div127(xf.abs().amax(dim=-1)), min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def paged_write_plain(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, S, Hkv, Dk] (int8 codes when kv_scales)
    v_new: torch.Tensor,     # [B, S, Hkv, Dv]
    page_ids: torch.Tensor,  # [B, 2] (first, second span page)
    offs: torch.Tensor,      # [B] in-page row of token 0
    valid: Optional[torch.Tensor],  # [B] tokens written; None: all S
    layer: int,
    kv_scales: Optional[torch.Tensor] = None,  # [L, P, 8, Hkv*page] f32
    ks_new: Optional[torch.Tensor] = None,     # [B, S, Hkv] f32
    vs_new: Optional[torch.Tensor] = None,
) -> None:
    """Plain version of K4 and K4q (both entries): an ``index_put_``
    scatter of the written tokens' [Hkv, D] rows and, for INT8 pages, of
    their scales into the tiles' rows 0 (k) and 1 (v). With ``valid`` None
    no mask is taken, so nothing is read back (a captured step can hold
    it)."""
    B, S, Hkv = k_new.shape[:3]
    page = k_pages.shape[3]
    pg, row, ok = _token_addresses(page_ids, offs, valid, S, page)
    if ok is not None:  # the written tokens only
        pg, row, k_new, v_new = pg[ok], row[ok], k_new[ok], v_new[ok]
        if kv_scales is not None:
            ks_new, vs_new = ks_new[ok], vs_new[ok]
    k_pages[layer, pg, :, row] = k_new.to(k_pages.dtype)
    v_pages[layer, pg, :, row] = v_new.to(v_pages.dtype)
    if kv_scales is not None:
        col = torch.arange(Hkv, device=row.device) * page + row[..., None]
        kv_scales[layer, pg[..., None], 0, col] = ks_new.to(torch.float32)
        kv_scales[layer, pg[..., None], 1, col] = vs_new.to(torch.float32)


def paged_write_cuda(
    k_pages, v_pages, k_new, v_new, page_ids, offs, valid, layer: int,
) -> None:
    """Launch K4 on CUDA tensors; same arguments as the plain version,
    except that the decode entry passes one ``page_ids`` column and no
    ``valid`` (every token written), the chunk entry two columns and
    ``valid``. The plan from ``copy_write_plan`` (the scalar path where a
    row is no whole number of 16-byte units or a pointer is off 16 bytes)."""
    L, P, Hkv, page, D = k_pages.shape
    Dv = v_pages.shape[-1]
    B, S = k_new.shape[:2]
    esize = k_pages.element_size()
    if S > page or not 0 <= layer < L:
        raise ValueError(f"chunk S={S} > page {page} or layer {layer} outside {L}")
    check(k_pages, "k_pages", k_pages.dtype)
    check(v_pages, "v_pages", k_pages.dtype, (L, P, Hkv, page, Dv))
    check(k_new, "k_new", k_pages.dtype, (B, S, Hkv, D))
    check(v_new, "v_new", k_pages.dtype, (B, S, Hkv, Dv))
    n_pg = page_ids.shape[1]
    check(page_ids, "page_ids", torch.int32, (B, n_pg))
    check(offs, "offs", torch.int32, (B,))
    if valid is not None:
        check(valid, "valid", torch.int32, (B,))
    aligned = all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages, k_new, v_new))
    plan = copy_write_plan(Hkv, D, Dv, esize, B * S, aligned)
    KERNEL.launch(
        "qtt_paged_write",
        launch_key("decode" if valid is None else "chunk", B, S, Hkv, page, D,
                   k_pages.dtype, Dv),
        k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), offs.data_ptr(),
        None if valid is None else valid.data_ptr(), B, S, Hkv, page,
        D * esize, Dv * esize, P, layer, n_pg, L, *plan, int(WRITE_PDL),
        stream_ptr(k_new.device),
    )


def paged_write_int8_cuda(
    k_pages, v_pages, kv_scales, k_new, v_new, ks_new, vs_new, page_ids,
    offs, valid, layer: int,
) -> None:
    """Launch K4q on CUDA tensors: int8 pages, their scale tiles, and new
    rows that are bf16 / f32 (quantized in the kernel; ``ks_new`` and
    ``vs_new`` None) or int8 codes with f32 scales [B, S, Hkv]. Addressing
    and ``valid`` as ``paged_write_cuda``; the launch plan from
    ``int8_write_plan`` (the scalar path where a pointer is off 16 bytes)."""
    L, P, Hkv, page, D = k_pages.shape
    Dv = v_pages.shape[-1]
    B, S = k_new.shape[:2]
    if S > page or not 0 <= layer < L:
        raise ValueError(f"chunk S={S} > page {page} or layer {layer} outside {L}")
    kind = _IN_KIND.get(k_new.dtype)
    if kind is None or (kind == 2) != (ks_new is not None):
        raise TypeError(
            f"K4q takes bf16 / f32 rows, or int8 codes with their scales: "
            f"got {k_new.dtype}, scales {'given' if ks_new is not None else 'none'}"
        )
    check(k_pages, "k_pages", torch.int8)
    check(v_pages, "v_pages", torch.int8, (L, P, Hkv, page, Dv))
    check(kv_scales, "kv_scales", torch.float32, (L, P, 8, Hkv * page))
    check(k_new, "k_new", k_new.dtype, (B, S, Hkv, D))
    check(v_new, "v_new", k_new.dtype, (B, S, Hkv, Dv))
    if kind == 2:
        check(ks_new, "ks_new", torch.float32, (B, S, Hkv))
        check(vs_new, "vs_new", torch.float32, (B, S, Hkv))
    n_pg = page_ids.shape[1]
    check(page_ids, "page_ids", torch.int32, (B, n_pg))
    check(offs, "offs", torch.int32, (B,))
    if valid is not None:
        check(valid, "valid", torch.int32, (B,))
    aligned = all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages, k_new, v_new))
    plan = int8_write_plan(Hkv, D, Dv, kind, B * S, aligned)
    KERNEL_INT8.launch(
        "qtt_paged_write_int8",
        launch_key("decode" if valid is None else "chunk", B, S, Hkv, page, D,
                   torch.int8, Dv),
        k_pages.data_ptr(), v_pages.data_ptr(), kv_scales.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(),
        None if ks_new is None else ks_new.data_ptr(),
        None if vs_new is None else vs_new.data_ptr(), page_ids.data_ptr(),
        offs.data_ptr(), None if valid is None else valid.data_ptr(), B, S,
        Hkv, page, D, Dv, P, layer, n_pg, L, kind, *plan, stream_ptr(k_new.device),
    )


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _use_write_kernel(device: torch.device) -> bool:
    """Page writes on the card go to K4 / K4q (the JAX package: on the TPU);
    ``QUICK_TPU_PAGED_WRITE=0`` (read at every call) turns them off, as in
    the JAX package (modules/paged_cache.py:309): torch scatters instead."""
    if os.environ.get("QUICK_TPU_PAGED_WRITE", "") == "0":
        return False
    return device.type == "cuda"


def _write(k_pages, v_pages, k_new, v_new, page_ids, offs, valid, layer,
           kv_scales, ks_new, vs_new, n_pg: int):
    """Both entries: K4 or K4q for pages on the card (``_use_write_kernel``),
    else the plain version, the torch scatters.
    ``k_new`` / ``v_new`` are [B, S, Hkv, Dk] / [B, S, Hkv, Dv]; ``valid``
    None writes every token (the decode entry)."""
    B, S = k_new.shape[:2]
    if kv_scales is None:
        kn, vn = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
    elif ks_new is None:
        kn, vn = k_new, v_new  # float rows: quantized below or in K4q
    else:
        kn, vn = k_new.to(torch.int8), v_new.to(torch.int8)
        ks_new, vs_new = ks_new.to(torch.float32), vs_new.to(torch.float32)
    if not _use_write_kernel(k_pages.device):
        if kv_scales is not None and ks_new is None:
            (kn, ks_new), (vn, vs_new) = quantize_kv(kn), quantize_kv(vn)
        paged_write_plain(k_pages, v_pages, kn, vn, page_ids.reshape(B, -1).expand(B, 2),
                          offs, valid, layer, kv_scales, ks_new, vs_new)
        return
    pids = _i32(page_ids).reshape(B, n_pg)
    vt = None if valid is None else _i32(valid)
    if kv_scales is None:
        paged_write_cuda(k_pages, v_pages, kn.contiguous(), vn.contiguous(), pids,
                         _i32(offs), vt, layer)
        return
    paged_write_int8_cuda(
        k_pages, v_pages, kv_scales, kn.contiguous(), vn.contiguous(),
        None if ks_new is None else ks_new.contiguous(),
        None if vs_new is None else vs_new.contiguous(), pids, _i32(offs), vt, layer,
    )


def paged_write_decode(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, Hkv, D], one token per slot
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B] physical page per token
    offs: torch.Tensor,      # [B] in-page row per token
    layer: int,
    kv_scales: Optional[torch.Tensor] = None,  # [L, P, 8, Hkv*page] f32
    ks_new: Optional[torch.Tensor] = None,     # [B, Hkv] f32 (codes given)
    vs_new: Optional[torch.Tensor] = None,
) -> tuple:
    """Write one token per slot into ``layer``; returns the page tensors
    (and, for INT8 pages, the scale tiles), updated in place."""
    _check_group(k_pages)
    _write(k_pages, v_pages, k_new[:, None], v_new[:, None], page_ids, offs, None,
           layer, kv_scales, None if ks_new is None else ks_new[:, None],
           None if vs_new is None else vs_new[:, None], 1)
    return (k_pages, v_pages) if kv_scales is None else (k_pages, v_pages, kv_scales)


def paged_write_chunk(
    k_pages: torch.Tensor,   # [L, P, Hkv, page, D], written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # [B, S, Hkv, D], S <= page
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B, 2] the chunk's (first, second) page
    offs: torch.Tensor,      # [B] in-page row of the chunk's first token
    valid: torch.Tensor,     # [B] tokens of the chunk actually fed
    layer: int,
    kv_scales: Optional[torch.Tensor] = None,  # [L, P, 8, Hkv*page] f32
    ks_new: Optional[torch.Tensor] = None,     # [B, S, Hkv] f32 (codes given)
    vs_new: Optional[torch.Tensor] = None,
) -> tuple:
    """Chunked-prefill page write; returns the page tensors (and, for INT8
    pages, the scale tiles), updated in place."""
    _check_group(k_pages)
    S, page = k_new.shape[1], k_pages.shape[3]
    if S > page:
        raise ValueError(f"chunk S={S} must be <= page_size={page}")
    _write(k_pages, v_pages, k_new, v_new, page_ids, offs, valid, layer,
           kv_scales, ks_new, vs_new, 2)
    return (k_pages, v_pages) if kv_scales is None else (k_pages, v_pages, kv_scales)
