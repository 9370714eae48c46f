"""Linear layers: float and W4A16-quantized (port of
``quick_tpu/modules/linear.py``).

Weights are stored [K(in), N(out)] as in the JAX package. ``QuantLinear``
holds the QTPU-packed codes and calls ``ops.quantized_matmul``, which goes
to the CUDA kernels on CUDA tensors, with W4A8 activations where
``QUICK_TPU_A8=1`` (``a8_enabled``). Under ``QUICK_TPU_BF16_SCALES=1`` the
model constructors round every QuantLinear's scales through bf16
(``round_scales_bf16``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from quick_tpu_torch.ops.quantized_matmul import quantized_matmul
from quick_tpu_torch.quantize.numerics import quantize_tensor
from quick_tpu_torch.quantize.packing import pack_qtpu_tensor


def a8_enabled() -> bool:
    """``QUICK_TPU_A8=1`` routes every quantized linear with more than 96
    flattened rows through the W4A8 kernels (``_a8_enabled``,
    quick_tpu/modules/linear.py:24); decode rows keep W4A16. Read at every
    call."""
    return os.environ.get("QUICK_TPU_A8", "0") == "1"


def moe_a8_enabled() -> bool:
    """``QUICK_TPU_MOE_A8=1`` runs the grouped expert GEMMs on int8
    activations (quick_tpu/modules/blocks.py:576); they fall back to W4A16
    at G != 128 or bm % 32. Read at every call."""
    return os.environ.get("QUICK_TPU_MOE_A8", "0") == "1"


@dataclasses.dataclass
class Linear:
    """Plain (non-quantized) linear, weight [K, N]."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    @property
    def in_features(self) -> int:
        return self.weight.shape[0]

    @property
    def out_features(self) -> int:
        return self.weight.shape[1]


@dataclasses.dataclass
class QuantLinear:
    """W4A16 linear in the QTPU packed layout.

    qweight: int32 [K // 8, N]; scales / zeros_x_scales: f32 [K // G, N].
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    zeros_x_scales: torch.Tensor
    bias: Optional[torch.Tensor] = None
    group_size: int = 128

    def __call__(
        self, x: torch.Tensor, fuse_norm: Optional[tuple] = None,
        fuse_glu: bool = False,
    ) -> torch.Tensor:
        # fuse_norm = (rms_weight, eps): x is RAW and the RMSNorm runs in the
        # kernel's prologue; fuse_glu: x is the raw [., 2K] gate_up output
        return quantized_matmul(
            x, self.qweight, self.scales, self.zeros_x_scales,
            group_size=self.group_size, bias=self.bias, a8=a8_enabled(),
            fuse_norm=fuse_norm, fuse_glu=fuse_glu,
        )

    @property
    def in_features(self) -> int:
        return self.qweight.shape[0] * 8

    @property
    def out_features(self) -> int:
        return self.qweight.shape[1]

    @classmethod
    def from_float(
        cls,
        weight: torch.Tensor,  # [K, N]
        bias: Optional[torch.Tensor] = None,
        group_size: int = 128,
        zero_point: bool = True,
    ) -> "QuantLinear":
        """RTN-quantize and pack a float weight."""
        qt = quantize_tensor(weight, group_size=group_size, zero_point=zero_point)
        return cls(
            qweight=pack_qtpu_tensor(qt.q, group_size),
            scales=qt.scales,
            zeros_x_scales=qt.zeros * qt.scales,
            bias=bias,
            group_size=group_size,
        )

    @classmethod
    def from_linear(cls, lin: Linear, group_size: int = 128) -> "QuantLinear":
        return cls.from_float(lin.weight, lin.bias, group_size)


AnyLinear = QuantLinear | Linear


def round_scales_bf16(tree):
    """Every QuantLinear in ``tree`` (dataclasses, lists, tuples, dicts)
    with its scales and zeros_x_scales rounded through bf16, the JAX
    package's ``cast_scales`` (:135) under ``QUICK_TPU_BF16_SCALES=1``;
    codes and biases untouched. The values stay in their f32 tensors:
    ``_quantized_matmul_jnp`` promotes bf16 scales to f32 (:109-111), so the
    plain paths and the kernels, which read f32, compute the JAX package's
    numbers."""
    if isinstance(tree, QuantLinear):
        return dataclasses.replace(
            tree, scales=tree.scales.to(torch.bfloat16).to(tree.scales.dtype),
            zeros_x_scales=tree.zeros_x_scales.to(torch.bfloat16).to(tree.zeros_x_scales.dtype))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: round_scales_bf16(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(round_scales_bf16(v) for v in tree)
    if isinstance(tree, dict):
        return {k: round_scales_bf16(v) for k, v in tree.items()}
    return tree


def cast_scales_env(tree):
    """``round_scales_bf16(tree)`` under ``QUICK_TPU_BF16_SCALES=1``
    (``scales_dtype_env``, quick_tpu/modules/linear.py:123), else ``tree``:
    the switch as the JAX package's choke points read it."""
    return round_scales_bf16(tree) if os.environ.get("QUICK_TPU_BF16_SCALES") == "1" else tree


def _concat_bias(lins) -> Optional[torch.Tensor]:
    if all(lin.bias is None for lin in lins):
        return None
    ref = lins[0].qweight if isinstance(lins[0], QuantLinear) else lins[0].weight
    return torch.cat([
        lin.bias if lin.bias is not None
        else torch.zeros(lin.out_features, dtype=torch.float32, device=ref.device)
        for lin in lins
    ])


def concat_linears(*lins: AnyLinear) -> AnyLinear:
    """Fuse linears sharing an input into one wide linear (offline QKV /
    gate-up fusion: in the QTPU layout the output channels concatenate)."""
    first = lins[0]
    if isinstance(first, QuantLinear):
        return QuantLinear(
            qweight=torch.cat([lin.qweight for lin in lins], dim=1),
            scales=torch.cat([lin.scales for lin in lins], dim=1),
            zeros_x_scales=torch.cat([lin.zeros_x_scales for lin in lins], dim=1),
            bias=_concat_bias(lins),
            group_size=first.group_size,
        )
    return Linear(
        weight=torch.cat([lin.weight for lin in lins], dim=1),
        bias=_concat_bias(lins),
    )
