"""INT4 weight packing in the QTPU layout (numpy, byte-identical to
``quick_tpu/quantize/packing.py``) plus tensor forms for the device.

QTPU format — for codes q [K, N] (0..15), group size G, SLAB = G // 8:
``qweight`` is int32 [K // 8, N]. Within group ``g``, word
``(g * SLAB + r, n)`` holds in nibble ``j`` the code ``q[g * G + j * SLAB + r, n]``
(j-major row order). Scales are stored [K // G, N] together with
``zeros_x_scales = z * s`` so a kernel computes
``out = sum_g (x_g @ q_g) * s_g - xsum_g * (z * s)_g``.

Also here, byte-identical to the JAX package: the AutoAWQ GEMM layout
(column-interleaved, ``pack_awq_gemm`` :97 .. ``export_awq_gemm`` :149),
the AutoAWQ GEMV layout (``calculate_zeros_width`` :170,
``import_awq_gemv`` :194) and the exllama / GPTQ layout (``pack_exllama``
:224 .. ``import_exllama`` :271), so AutoAWQ checkpoints load and export.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PACK = 8  # int4 nibbles per int32 word

# AutoAWQ GEMM column interleave and its inverse
AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])
AWQ_REVERSE_ORDER = np.array([0, 4, 1, 5, 2, 6, 3, 7])


def pack_qtpu(q: np.ndarray, group_size: int = 128) -> np.ndarray:
    """Pack codes [K, N] (uint8, 0..15) into QTPU int32 [K // 8, N]."""
    K, N = q.shape
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    if group_size % PACK:
        raise ValueError(f"group_size={group_size} not divisible by {PACK}")
    slab = group_size // PACK
    qg = np.ascontiguousarray(q).reshape(K // group_size, PACK, slab, N)
    qg = qg.astype(np.uint32)
    words = np.zeros((K // group_size, slab, N), dtype=np.uint32)
    for j in range(PACK):
        # mask to the nibble: an out-of-range code must not bleed into the
        # adjacent nibble
        words |= (qg[:, j] & np.uint32(0xF)) << np.uint32(4 * j)
    return words.reshape(K // PACK, N).view(np.int32)


def unpack_qtpu(qweight: np.ndarray, group_size: int = 128) -> np.ndarray:
    """Inverse of :func:`pack_qtpu`: int32 [K // 8, N] -> uint8 codes [K, N]."""
    K8, N = qweight.shape
    K = K8 * PACK
    slab = group_size // PACK
    words = qweight.view(np.uint32).reshape(K // group_size, slab, N)
    out = np.empty((K // group_size, PACK, slab, N), dtype=np.uint8)
    for j in range(PACK):
        out[:, j] = ((words >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    return out.reshape(K, N)


def pack_qtpu_tensor(q: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Tensor form of :func:`pack_qtpu` (any device): uint8 codes [K, N] ->
    int32 [K // 8, N]."""
    K, N = q.shape
    slab = group_size // PACK
    nib = (q.to(torch.int64) & 0xF).reshape(K // group_size, PACK, slab, N)
    shifts = (torch.arange(PACK, device=q.device, dtype=torch.int64) * 4)
    words = (nib << shifts.reshape(1, PACK, 1, 1)).sum(dim=1)  # disjoint
    # two's complement wrap of the unsigned word into int32
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.reshape(K // PACK, N).to(torch.int32)


def unpack_qtpu_tensor(qweight: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Tensor form of :func:`unpack_qtpu`: int32 [K // 8, N] -> int32 codes
    [K, N] (values 0..15)."""
    K8, N = qweight.shape
    slab = group_size // PACK
    ng = K8 * PACK // group_size
    words = qweight.reshape(ng, 1, slab, N)
    shifts = torch.arange(PACK, device=qweight.device, dtype=torch.int32) * 4
    nib = (words >> shifts.reshape(1, PACK, 1, 1)) & 0xF  # [ng, 8, slab, N]
    return nib.reshape(K8 * PACK, N)


# ---------------------------------------------------------------------------
# AutoAWQ GEMM layout: qweight int32 [K, N//8], nibble j of a word holds
# column AWQ_ORDER[j] of its group of 8; qzeros int32 [K//G, N//8] alike;
# scales fp16 [K//G, N]
# ---------------------------------------------------------------------------

def pack_awq_gemm(q_t: np.ndarray) -> np.ndarray:
    """Pack codes [K, N] into AutoAWQ GEMM int32 [K, N // 8]."""
    K, N = q_t.shape
    if N % PACK:
        raise ValueError(f"N={N} not divisible by {PACK}")
    cols = q_t.reshape(K, N // PACK, PACK).astype(np.uint32)
    cols = cols[:, :, AWQ_ORDER]  # nibble j holds column AWQ_ORDER[j]
    words = np.zeros((K, N // PACK), dtype=np.uint32)
    for j in range(PACK):
        words |= (cols[:, :, j] & np.uint32(0xF)) << np.uint32(4 * j)
    return words.view(np.int32)


def unpack_awq_gemm(qweight: np.ndarray) -> np.ndarray:
    """Unpack AutoAWQ GEMM int32 [K, N // 8] -> codes [K, N]."""
    K, N8 = qweight.shape
    words = qweight.view(np.uint32)
    nibbles = np.empty((K, N8, PACK), dtype=np.uint8)
    for j in range(PACK):
        nibbles[:, :, j] = ((words >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    nibbles = nibbles[:, :, AWQ_REVERSE_ORDER]  # invert the interleave
    return nibbles.reshape(K, N8 * PACK)


def import_awq_gemm(
    qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray, group_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AutoAWQ GEMM (qweight [K, N//8], qzeros [K//G, N//8], scales
    [K//G, N]) -> QTPU (qweight [K//8, N] int32, scales f32, z*s f32)."""
    q = unpack_awq_gemm(qweight)
    z = unpack_awq_gemm(qzeros).astype(np.float32)
    s = scales.astype(np.float32)
    return pack_qtpu(q, group_size), s, z * s


def export_awq_gemm(
    qweight_qtpu: np.ndarray, scales: np.ndarray, zeros_x_scales: np.ndarray,
    group_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`import_awq_gemm` (QTPU -> AutoAWQ GEMM triple)."""
    q = unpack_qtpu(qweight_qtpu, group_size)
    s = scales.astype(np.float32)
    z = np.round(zeros_x_scales / np.clip(s, 1e-10, None)).astype(np.uint8)
    return pack_awq_gemm(q), pack_awq_gemm(z), s.astype(np.float16)


# ---------------------------------------------------------------------------
# AutoAWQ GEMV layout: qweight int32 [OC, IC//8] in natural nibble order
# along IC; qzeros int32 [OC, zw] (zw padded); scales fp16 [OC, zw*8],
# zero-padded past the true group count
# ---------------------------------------------------------------------------

def calculate_zeros_width(in_features: int, group_size: int = 128, pack_num: int = PACK) -> int:
    """Padded zeros width of the GEMV layout."""
    if group_size >= 128:
        size_multiplier = 1
    elif group_size == 64:
        size_multiplier = 2
    elif group_size == 32:
        size_multiplier = 4
    else:
        raise NotImplementedError(f"group_size={group_size}")
    base = -(-(in_features // group_size) // pack_num)
    return -(-base // size_multiplier) * size_multiplier


def _unpack_words_lastdim(words: np.ndarray) -> np.ndarray:
    """int32 [..., W] -> uint8 nibbles [..., W*8], natural order."""
    w = words.view(np.uint32)
    out = np.empty(w.shape + (PACK,), np.uint8)
    for j in range(PACK):
        out[..., j] = ((w >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    return out.reshape(*w.shape[:-1], w.shape[-1] * PACK)


def import_awq_gemv(
    qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray, group_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AutoAWQ GEMV triple -> QTPU arrays (as :func:`import_awq_gemm`)."""
    OC, IC8 = qweight.shape
    IC = IC8 * PACK
    ng = IC // group_size
    q = _unpack_words_lastdim(qweight).T            # [IC, OC]
    z = _unpack_words_lastdim(qzeros)[:, :ng].T     # [ng, OC]
    s = scales[:, :ng].astype(np.float32).T         # [ng, OC]
    return (
        pack_qtpu(np.ascontiguousarray(q), group_size),
        np.ascontiguousarray(s),
        np.ascontiguousarray(z.astype(np.float32) * s),
    )


# ---------------------------------------------------------------------------
# Exllama / GPTQ layout: qweight packs 8 consecutive K rows per int32 in
# natural nibble order; qzeros packs 8 consecutive N columns per int32,
# each zero point stored minus 1
# ---------------------------------------------------------------------------

def pack_exllama(q: np.ndarray, zeros: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Codes [K, N] + integer zeros [K//G, N] -> exllama (qweight [K//8, N],
    qzeros [K//G, N//8])."""
    K, N = q.shape
    if K % PACK or N % PACK:
        raise ValueError(f"K={K}, N={N} must be divisible by {PACK}")
    rows = q.reshape(K // PACK, PACK, N).astype(np.uint32)
    qweight = np.zeros((K // PACK, N), np.uint32)
    for j in range(PACK):
        qweight |= rows[:, j, :] << np.uint32(4 * j)
    iz = (zeros.astype(np.int64) - 1).astype(np.uint32) & np.uint32(0xF)
    cols = iz.reshape(zeros.shape[0], N // PACK, PACK)
    qzeros = np.zeros((zeros.shape[0], N // PACK), np.uint32)
    for j in range(PACK):
        qzeros |= cols[:, :, j] << np.uint32(4 * j)
    return qweight.view(np.int32), qzeros.view(np.int32)


def unpack_exllama(qweight: np.ndarray, qzeros: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exllama (qweight [K//8, N], qzeros [K//G, N//8]) -> codes [K, N] +
    integer zeros [K//G, N] (the +1 restored)."""
    K8, N = qweight.shape
    words = qweight.view(np.uint32)
    q = np.empty((K8, PACK, N), np.uint8)
    for j in range(PACK):
        q[:, j, :] = ((words >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    zw = qzeros.view(np.uint32)
    z = np.empty((qzeros.shape[0], qzeros.shape[1], PACK), np.uint8)
    for j in range(PACK):
        z[:, :, j] = ((zw >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    zeros = (z.reshape(qzeros.shape[0], -1).astype(np.int64) + 1) & 0xF
    return q.reshape(K8 * PACK, N), zeros.astype(np.uint8)


def gemm_to_exllama(qweight: np.ndarray, qzeros: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """AutoAWQ GEMM tensors -> exllama tensors: unpack, un-interleave,
    repack row- / columnwise with the zeros minus 1."""
    return pack_exllama(unpack_awq_gemm(qweight), unpack_awq_gemm(qzeros))


def import_exllama(
    qweight: np.ndarray, qzeros: np.ndarray, scales: np.ndarray, group_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exllama / GPTQ triple -> QTPU arrays (as :func:`import_awq_gemm`)."""
    q, z = unpack_exllama(qweight, qzeros)
    s = scales.astype(np.float32)
    return pack_qtpu(q, group_size), s, z.astype(np.float32) * s
