"""Causal GQA attention: the golden einsum path and the flash dispatch.

Port of ``quick_tpu/ops/attention.py``. ``causal_attention`` computes the
scores with f32 accumulation, softmax in f32 and keeps the probabilities
in f32 for p @ v — the reference numerics the kernels are held against.
Where the JAX package dispatches to its Pallas flash kernel (``_use_flash``
:21, TPU only), the port dispatches to the CUDA flash kernel K2 for CUDA
tensors; CPU tensors always take the einsum path, as JAX on the CPU does.
"""
from __future__ import annotations

import os

from typing import Optional, Union

import torch

NEG_INF = -1e9

IntOrTensor = Union[int, torch.Tensor]


def _use_flash(S: int, T: int, D: int, device: torch.device) -> bool:
    """The flash kernel for score matrices big enough to matter — the JAX
    gate's shape rule, taken on the card instead of the TPU.
    ``QUICK_TPU_FLASH=0`` (read at every call) turns it off, as in the JAX
    package (:25): the einsum path instead."""
    if os.environ.get("QUICK_TPU_FLASH", "") == "0":
        return False
    return device.type == "cuda" and S >= 64 and T >= 128 and D % 8 == 0


def _per_batch(v: Optional[IntOrTensor], B: int, device) -> Optional[torch.Tensor]:
    """Scalar or [B] -> int64 tensor [B, 1, 1, 1, 1] for broadcasting."""
    if v is None:
        return None
    t = torch.as_tensor(v, device=device).to(torch.int64)
    return t.reshape(-1, 1, 1, 1, 1) if t.ndim > 0 else t


def causal_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D] — or [B, Hkv, T, D] if kv_heads_major
    v: torch.Tensor,
    q_offset: IntOrTensor = 0,
    kv_len: Optional[IntOrTensor] = None,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq]
    kv_heads_major: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention, f32 softmax. Returns [B, S, Hq, Dv]."""
    S, D = q.shape[1], q.shape[3]
    T = k.shape[2] if kv_heads_major else k.shape[1]
    if scale is None:
        scale = D ** -0.5
    if _use_flash(S, T, D, q.device):
        from quick_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, q_offset=q_offset, kv_len=kv_len, scale=scale,
            alibi_slopes=alibi_slopes, kv_heads_major=kv_heads_major,
            window=window, logit_softcap=logit_softcap,
        )
    return einsum_attention(
        q, k, v, q_offset, kv_len, scale, alibi_slopes, kv_heads_major,
        window, logit_softcap,
    )


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, T, Hkv, D] (or [B, Hkv, T, D] if heads-major)
    v_cache: torch.Tensor,
    cache_len: IntOrTensor,  # scalar or [B]: valid entries (incl. current)
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_heads_major: bool = False,
) -> torch.Tensor:
    """Single-token decode attention over a (padded) KV cache (:164): the
    einsum path with the query at ``cache_len - 1``."""
    q_offset = cache_len - 1 if isinstance(cache_len, torch.Tensor) else int(cache_len) - 1
    return causal_attention(
        q, k_cache, v_cache, q_offset=q_offset, kv_len=cache_len, scale=scale,
        alibi_slopes=alibi_slopes, kv_heads_major=kv_heads_major,
    )


def einsum_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D] — or [B, Hkv, T, D] if kv_heads_major
    v: torch.Tensor,
    q_offset: IntOrTensor = 0,
    kv_len: Optional[IntOrTensor] = None,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq]
    kv_heads_major: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """The einsum path of ``causal_attention`` on any device (no kernel):
    the plain version the paged-attention kernels are held against."""
    B, S, Hq, D = q.shape
    T = k.shape[2] if kv_heads_major else k.shape[1]
    n_kv = k.shape[1] if kv_heads_major else k.shape[2]
    if scale is None:
        scale = D ** -0.5
    kh = k if kv_heads_major else k.transpose(1, 2)  # [B, Hkv, T, D]
    vh = v if kv_heads_major else v.transpose(1, 2)
    g = Hq // n_kv
    # [B, Hkv, g, S, D]: query heads grouped under their kv head
    qg = q.reshape(B, S, n_kv, g, D).permute(0, 2, 3, 1, 4).to(torch.float32)
    scores = torch.einsum(
        "bkgsd,bktd->bkgst", qg, kh.to(torch.float32)
    ) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    off = _per_batch(q_offset, B, q.device)
    q_pos = torch.arange(S, device=q.device).reshape(1, 1, 1, S, 1) + off
    k_pos = torch.arange(T, device=q.device).reshape(1, 1, 1, 1, T)
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        sl = sl.reshape(1, n_kv, g, 1, 1)
        scores = scores + sl * (k_pos - q_pos).to(torch.float32)
    if kv_len is not None:
        mask = mask & (k_pos < _per_batch(kv_len, B, q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, vh.to(torch.float32))
    Dv = v.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv).to(q.dtype)
