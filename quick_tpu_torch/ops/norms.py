"""Normalization ops: CUDA kernel K13 (RMSNorm) and its plain version (port
of ``quick_tpu/ops/norms.py``).

The JAX package leaves its model path's ``rms_norm`` (:17) to XLA, which
fuses the expression into one pass; its Pallas ``_rms_norm_kernel`` (:38)
serves its benchmark. Eager PyTorch runs the expression as about nine
calls, so on CUDA tensors ``rms_norm`` launches K13 (``csrc/rms_norm.cu``),
the hand-written counterpart of ``_rms_norm_kernel``; on CPU tensors it runs
``rms_norm_plain``. The RMSNorm of the decode GEMM's prologue stays inside
K1 (ops/quantized_matmul.py).

K13 holds each row in registers as 16-byte units of 8 values spread over a
group of lanes; ``norm_plan`` picks the lanes a row, the units a lane and
the rows a block from the shapes, or the scalar path, and ``norm_elements``
lists what a thread of a block reads, as the kernel computes it (the CPU
tests hold the plan to covering every value once).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from quick_tpu_torch.ops._cuda import CudaKernel, check, f32, i32, ptr, stream_ptr

#: K13. ``KERNEL.launches`` counts its launches, ``launches_by_key`` by shape.
KERNEL = CudaKernel(
    "rms_norm.cu",
    {"qtt_rms_norm": [ptr, i32, ptr, i32, i32, f32, i32, i32, i32, i32, i32, i32, ptr, ptr]},
)
_TYPES = (torch.bfloat16, torch.float32)  # the x and weight types K13 takes
UNIT = 8  # values a unit: 16 bytes of bf16, 32 of f32
NORM_MAX_UNITS = 4  # units a lane holds at most (``kMaxUnits``; 0: every row scalar)
NORM_MAX_LANES = 128  # lanes a row at most: a row in registers holds at most 4096 values
NORM_BLOCK = 256  # threads a block at most (``kBlock``)
NORM_MAX_ROWS = 8  # one-warp rows a block at most
NORM_PDL = True  # a programmatic dependent launch (False: a plain one, for measurements)


class NormPlan(NamedTuple):
    """K13's launch: ``lanes`` a row (a power of two, 32-128; the scalar
    path's block of 256), ``units`` a lane (0 on the scalar path), ``rows``
    a block, and whether the row is read in vector units."""
    lanes: int
    units: int
    rows: int
    vector: bool


def norm_plan(M: int, D: int, ldx: int, x_dtype: torch.dtype, aligned: bool = True) -> NormPlan:
    """The fewest lanes (at least a warp) whose ``NORM_MAX_UNITS`` units
    hold the row; a warp's rows are packed up to ``NORM_MAX_ROWS`` a block
    (at most M), a row that spans warps has its block to itself (its sum
    crosses warps through shared memory: two 128-lane rows a block ran
    1.07x one). The scalar path where a row is
    no whole number of units, longer than ``NORM_MAX_LANES`` x
    ``NORM_MAX_UNITS`` units, or its base (``aligned``: x's and the weight's
    data pointers on 16 bytes) or its stride ``ldx`` is off 16 bytes."""
    esize = 2 if x_dtype == torch.bfloat16 else 4
    units = D // UNIT
    if (not aligned or D % UNIT or (M > 1 and ldx * esize % 16) or NORM_MAX_UNITS == 0
            or units > NORM_MAX_LANES * NORM_MAX_UNITS):
        return NormPlan(NORM_BLOCK, 0, 1, False)
    lanes = 32
    while lanes * NORM_MAX_UNITS < units:
        lanes *= 2
    rows = 1 if lanes > 32 else max(1, min(NORM_MAX_ROWS, NORM_BLOCK // lanes, M))
    return NormPlan(lanes, -(-units // lanes), rows, True)


def norm_grid(plan: NormPlan, M: int) -> int:
    return -(-M // plan.rows)


def norm_elements(plan: NormPlan, M: int, D: int, bx: int, t: int) -> Tuple[int, List[int]]:
    """(row, the row's value indices) thread ``t`` of block ``bx`` reads
    under ``plan``, as K13 computes them; (-1, []) for a thread that holds
    no row."""
    if not plan.vector:
        return bx, list(range(t, D, NORM_BLOCK))
    lg = plan.lanes.bit_length() - 1
    row, lane = bx * plan.rows + (t >> lg), t & (plan.lanes - 1)
    if row >= M:
        return -1, []
    out = []
    for v in range(plan.units):
        u = lane + (v << lg)
        if u < D // UNIT:
            out += range(UNIT * u, UNIT * u + UNIT)
    return row, out


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
        aligned = x2.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0
        plan = norm_plan(M, D, ld, x.dtype, aligned)
        KERNEL.launch(
            "qtt_rms_norm", launch_key(M, D, x.dtype),
            x2.data_ptr(), ld, weight.data_ptr(), M, D, float(eps),
            int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
            plan.lanes.bit_length() - 1, plan.units, plan.rows, int(NORM_PDL),
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
