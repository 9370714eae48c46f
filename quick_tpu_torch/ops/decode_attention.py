"""Single-query decode attention over the dense head-major KV cache: CUDA
kernel K7 and its plain version.

Port of ``quick_tpu/ops/decode_attention.py``: ``dense_decode_attention``
(:230) over the WHOLE [L, B, Hkv, T, D] cache stack plus ``layer`` (slicing
a layer first would copy it), per-row lengths, scale, ALiBi slopes and the
tanh softcap, and ``supports`` (:278) with the tile picker's feasibility
rule (:197), kept so both packages take the same branch. CUDA tensors go to
``csrc/decode_attention.cu`` (bf16 cache), the dense instantiation of K5's
key-split kernel (``csrc/paged_decode.cuh``: the cache is B pages of T
keys); CPU tensors to the plain version, which runs the Pallas kernel's
algorithm: chunks of ``c`` keys (the chunk ``_pick_tiles`` picks), an
online softmax in f32, and p rounded to the cache dtype before p @ v
(:98-105).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from quick_tpu_torch.ops._cuda import (
    CudaKernel, ZeroedWords, check, f32, i32, ptr, sm_count, stream_ptr,
)

NEG_INF = -1e30

#: K7 (one launch; its last block of a (row, head group) merges the key
#: splits). ``launches_by_key`` names the shape and the split.
KERNEL = CudaKernel(
    "decode_attention.cu",
    {
        "qtt_dense_decode_attention": [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, f32, f32, ptr,
        ],
    },
)
_COUNTERS = ZeroedWords("K7")  # the merge counters, zero between launches
KERNEL_HEAD_DIMS = (64, 128, 256)
TILE = 64  # keys per staged tile in the kernel (paged_decode.cuh k5::kBK)


def _pick_tiles(B: int, Hkv: int, T: int, D: int, itemsize: int = 2) -> Optional[Tuple[int, int]]:
    """The JAX package's (nb sequences, c tokens) per grid step (:197): ~2 MB
    of K+V per step at the cache dtype. Only ``c`` matters here (the plain
    version's chunk); ``None`` means the JAX package takes the einsum path."""
    budget = (2 << 20) // (Hkv * D * 2 * itemsize)
    if budget < 8:
        return None
    c = next((cand for cand in (128, 256, 64, 32, 16, 8)
              if cand <= T and T % cand == 0 and cand <= budget), None)
    if c is None:
        return None
    nb = 1
    while nb * 2 <= B and B % (nb * 2) == 0 and nb * 2 * c <= budget and nb < 8:
        nb *= 2
    return nb, c


def supports(B: int, Hq: int, Hkv: int, T: int, D: int) -> bool:
    """Whether the JAX package's kernel handles these shapes (:278)."""
    if Hq % Hkv != 0 or T % 8 != 0 or D % 8 != 0:
        return False
    return _pick_tiles(B, Hkv, T, D) is not None


def split_plan(B: int, Hkv: int, T: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of K7's key range: enough blocks of (kv head, row,
    split) for two per SM, in whole 64-key tiles. Decided from shapes only,
    never from the lengths on the card."""
    tiles = -(-T // TILE)
    splits = min(tiles, max(1, -(-2 * sms // (B * Hkv))))
    chunk = TILE * -(-tiles // splits)
    return chunk, -(-T // chunk)


def launch_key(B: int, Hq: int, Hkv: int, T: int, D: int, splits: int) -> str:
    return f"B={B} Hq={Hq} Hkv={Hkv} T={T} D={D} splits={splits}"


def dense_decode_attention_plain(
    q, k, v, lengths, layer, scale, alibi_slopes=None, logit_softcap=None,
) -> torch.Tensor:
    """Plain version of K7, the Pallas kernel's algorithm in PyTorch.
    q [B, Hq, D], k / v [L, B, Hkv, T, D], lengths [B]. Returns [B, Hq, D]."""
    B, Hq, D = q.shape
    Hkv, T = k.shape[2], k.shape[3]
    gq = Hq // Hkv
    tiles = _pick_tiles(B, Hkv, T, D, itemsize=k.element_size())
    c = tiles[1] if tiles is not None else T
    kl, vl = k[layer], v[layer]  # [B, Hkv, T, D] views
    ln = lengths.to(q.device, torch.int64).reshape(B, 1, 1, 1)
    qg = q.reshape(B, Hkv, gq, D).to(torch.float32)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        slopes = slopes.reshape(1, Hkv, gq, 1)
    m = torch.full((B, Hkv, gq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, gq, D), dtype=torch.float32, device=q.device)
    for base in range(0, T, c):
        kc = kl[:, :, base:base + c].to(torch.float32)  # [B, Hkv, c, D]
        s = torch.einsum("bhgd,bhtd->bhgt", qg, kc) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s * (1.0 / logit_softcap))
        pos = torch.arange(base, base + kc.shape[2], device=q.device).reshape(1, 1, 1, -1)
        mask = pos < ln
        if slopes is not None:
            s = s + slopes * (pos - (ln - 1)).to(torch.float32)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = p.to(vl.dtype).to(torch.float32)
        acc = acc * alpha + torch.einsum(
            "bhgt,bhtd->bhgd", pv, vl[:, :, base:base + c].to(torch.float32))
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, Hq, D).to(q.dtype)


def dense_decode_attention_cuda(
    q, k, v, lengths, layer, scale, alibi_slopes=None, logit_softcap=None,
) -> torch.Tensor:
    """Launch K7 on CUDA tensors; same arguments as the plain version
    (lengths an int32 [B] tensor on the card). Its merge counters
    (``_COUNTERS``) are made by an eager launch before any capture; one
    launch at a time on a device."""
    L, B, Hkv, T, D = k.shape
    Hq = q.shape[1]
    if D not in KERNEL_HEAD_DIMS or q.shape[-1] != D or v.shape[-1] != D:
        raise NotImplementedError(
            f"K7 takes head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}/{D}/{v.shape[-1]}"
        )
    if Hq % Hkv or Hq // Hkv > 32 or not 0 <= layer < L or B > 65535:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} layer={layer} L={L} B={B}")
    check(q, "q", torch.bfloat16, (B, Hq, D))
    check(k, "k", torch.bfloat16)
    check(v, "v", torch.bfloat16, k.shape)
    check(lengths, "lengths", torch.int32, (B,))
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(q.device, torch.float32).contiguous()
        check(slopes, "alibi_slopes", torch.float32, (Hq,))
    chunk, splits = split_plan(B, Hkv, T, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    # the split partials: acc [B, Hq, splits, D], then (m, l) [B, Hq, splits, 2]
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
    counters = _COUNTERS.get(q.device, B * Hkv * -(-(Hq // Hkv) // 16))
    KERNEL.launch(
        "qtt_dense_decode_attention", launch_key(B, Hq, Hkv, T, D, splits),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        part.data_ptr(), part[B * Hq * splits * D:].data_ptr(), counters.data_ptr(),
        B, Hq, Hkv, T, D, L, int(layer), chunk, splits, float(scale),
        float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def dense_decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, D] or [B, Hq, D]
    k: torch.Tensor,        # [L, B, Hkv, T, D] cache stack, or [B, Hkv, T, D]
    v: torch.Tensor,
    lengths: Union[int, torch.Tensor],  # [B] or scalar: valid tokens (incl. current)
    layer: int = 0,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attention output in the rank of ``q``. Pass the whole cache stack
    plus ``layer`` from a model step. The current step's K/V must already
    be in the cache (the cache updates before attention)."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    if k.ndim == 4:
        k, v, layer = k[None], v[None], 0
    B, _, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if not isinstance(lengths, torch.Tensor) or lengths.ndim == 0:
        lengths = torch.full((B,), int(lengths), dtype=torch.int32, device=q.device)
    if q.device.type != "cuda":
        out = dense_decode_attention_plain(q, k, v, lengths, int(layer), scale,
                                           alibi_slopes, logit_softcap)
    else:
        out = dense_decode_attention_cuda(
            q.contiguous(), k, v, lengths.to(q.device, torch.int32).contiguous(),
            int(layer), scale, alibi_slopes, logit_softcap,
        )
    return out[:, None] if squeeze else out
