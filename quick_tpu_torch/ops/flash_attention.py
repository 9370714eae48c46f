"""Causal GQA flash attention: CUDA kernel K2 and its plain version.

Port of ``quick_tpu/ops/flash_attention.py::flash_attention`` (:248) with
the same contract as ``causal_attention``: per-batch query offset and kv
length, GQA by head division, ALiBi, sliding window and tanh softcap; v may
be narrower than q / k (DeepSeek's MLA expanded prefill: 192 / 128). CUDA
tensors go to ``csrc/flash_attention.cu``; CPU tensors to the plain
version, which computes the same masked softmax without tiling and, like
the kernel, rounds p to the value dtype before p @ v and returns 0 for a
row with no visible key.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, f32, i32, ptr, stream_ptr

NEG_INF = -1e30

#: K2. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "flash_attention.cu",
    {"qtt_flash_attention": [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        i32, f32, i32, f32, ptr,
    ]},
)
KERNEL_HEAD_DIMS = (64, 128, 256)
#: (q / k width, v width) pairs K2 takes besides the equal ones
KERNEL_ASYMMETRIC_DIMS = ((192, 128),)


def flash_attention_plain(
    q: torch.Tensor,     # [B, S, Hq, D]
    k: torch.Tensor,     # [B, Hkv, T, D] head-major
    v: torch.Tensor,
    qoff: torch.Tensor,  # [B] int
    klen: torch.Tensor,  # [B] int, <= T
    scale: float,
    alibi_slopes: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K2. Returns [B, S, Hq, Dv] in q's dtype."""
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(torch.float32)) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    dev = q.device
    q_pos = torch.arange(S, device=dev).reshape(1, 1, 1, S, 1) + qoff.to(
        dev, torch.int64).reshape(B, 1, 1, 1, 1)
    k_pos = torch.arange(T, device=dev).reshape(1, 1, 1, 1, T)
    if alibi_slopes is not None:
        sl = alibi_slopes.to(dev, torch.float32).reshape(1, Hkv, g, 1, 1)
        s = s + sl * (k_pos - q_pos).to(torch.float32)
    mask = (k_pos <= q_pos) & (k_pos < klen.to(dev, torch.int64).reshape(B, 1, 1, 1, 1))
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum(
        "bkgst,bktd->bkgsd", p.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    Dv = v.shape[-1]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, Dv).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qoff: torch.Tensor,
    klen: torch.Tensor,
    scale: float,
    alibi_slopes: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Launch K2 on CUDA tensors; same arguments as the plain version."""
    B, S, Hq, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if not ((D in KERNEL_HEAD_DIMS and Dv == D) or (D, Dv) in KERNEL_ASYMMETRIC_DIMS):
        raise NotImplementedError(
            f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS} with equal "
            f"q/k and v widths, or (q/k, v) in {KERNEL_ASYMMETRIC_DIMS}; got "
            f"{D} and {Dv}"
        )
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    check(q, "q", torch.bfloat16, (B, S, Hq, D))
    check(k, "k", torch.bfloat16, (B, Hkv, T, D))
    check(v, "v", torch.bfloat16, (B, Hkv, T, Dv))
    check(qoff, "qoff", torch.int32, (B,))
    check(klen, "klen", torch.int32, (B,))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
        check(slopes, "alibi_slopes", torch.float32, (Hq,))
    out = q.new_empty((B, S, Hq, Dv))
    KERNEL.launch(
        "qtt_flash_attention", launch_key(B, S, T, Hq, Hkv, D, Dv),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qoff.data_ptr(),
        klen.data_ptr(), None if slopes is None else slopes.data_ptr(),
        out.data_ptr(), B, S, T, Hq, Hkv, D, Dv, float(scale),
        int(window or 0), float(logit_softcap or 0.0), stream_ptr(q.device),
    )
    return out


def launch_key(B: int, S: int, T: int, Hq: int, Hkv: int, D: int, Dv: int) -> str:
    """The ``launches_by_key`` key of one K2 launch (v's width named only
    where it differs from q / k's)."""
    return f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D}" + (f" Dv={Dv}" if Dv != D else "")


def _per_batch_i32(v: Union[int, torch.Tensor], B: int, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device, torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(v), dtype=torch.int32, device=device)


def flash_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D] — or [B, Hkv, T, D] if kv_heads_major
    v: torch.Tensor,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_heads_major: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with the contract of ``causal_attention``."""
    B, S, Hq, D = q.shape
    kt = k if kv_heads_major else k.transpose(1, 2)
    vt = v if kv_heads_major else v.transpose(1, 2)
    T = kt.shape[2]
    if scale is None:
        scale = D ** -0.5
    qoff = _per_batch_i32(q_offset, B, q.device)
    klen = _per_batch_i32(T if kv_len is None else kv_len, B, q.device)
    klen = torch.clamp(klen, max=T)
    args = (qoff, klen, float(scale), alibi_slopes, window, logit_softcap)
    if q.device.type != "cuda":
        return flash_attention_plain(q, kt, vt, *args)
    return flash_attention_cuda(
        q.contiguous(), kt.contiguous(), vt.contiguous(), *args
    )
