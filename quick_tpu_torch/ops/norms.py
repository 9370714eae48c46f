"""Normalization ops: CUDA kernel K13 (RMSNorm) and its plain version (port
of ``quick_tpu/ops/norms.py``).

The JAX package leaves its model path's ``rms_norm`` (:17) to XLA, which
fuses the expression into one pass; its Pallas ``_rms_norm_kernel`` (:38)
serves its benchmark. Eager PyTorch runs the expression as about nine
calls, so on CUDA tensors ``rms_norm`` launches K13 (``csrc/rms_norm.cu``),
the hand-written counterpart of ``_rms_norm_kernel``; on CPU tensors it runs
``rms_norm_plain``. The RMSNorm of the decode GEMM's prologue stays inside
K1 (ops/quantized_matmul.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, f32, i32, ptr, stream_ptr

#: K13. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "rms_norm.cu",
    {"qtt_rms_norm": [ptr, i32, ptr, i32, i32, f32, i32, i32, ptr, ptr]},
)
_TYPES = (torch.bfloat16, torch.float32)  # the x and weight types K13 takes


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 with cast back to x.dtype (HF Llama numerics)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def launch_key(M: int, D: int, dtype: torch.dtype = torch.bfloat16) -> str:
    key = f"M={M} D={D}"
    return key if dtype == torch.bfloat16 else f"{key} {str(dtype).removeprefix('torch.')}"


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch K13 on CUDA tensors: x [..., D] bf16 or f32, weight [D] bf16
    or f32; returns x's shape and type, contiguous. The rows may be strided
    (a last-dim slice such as ``ckv[..., :R]``): K13 takes the row stride
    when the leading dims flatten to one stride, and the wrapper copies x
    otherwise."""
    D = x.shape[-1]
    if x.dtype not in _TYPES or weight.dtype not in _TYPES:
        raise TypeError(f"K13 takes x and weight in {_TYPES}, got {x.dtype}, {weight.dtype}")
    x2 = x.reshape(-1, D)  # a view where the strides allow
    if x2.stride(-1) != 1 or (x2.shape[0] > 1 and x2.stride(0) < D):
        x2 = x2.contiguous()
    M, ld = x2.shape[0], (x2.stride(0) if x2.shape[0] > 1 else D)
    check(weight, "weight", weight.dtype, (D,))
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M:
        KERNEL.launch(
            "qtt_rms_norm", launch_key(M, D, x.dtype),
            x2.data_ptr(), ld, weight.data_ptr(), M, D, float(eps),
            int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
            out.data_ptr(), stream_ptr(x.device),
        )
    return out.reshape(x.shape)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, f32 math, cast back to x.dtype: K13 on
    CUDA tensors, ``rms_norm_plain`` on CPU tensors."""
    if x.device.type == "cuda":
        return rms_norm_cuda(x, weight, eps)
    return rms_norm_plain(x, weight, eps)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
