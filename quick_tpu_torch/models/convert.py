"""Flat parameter dicts <-> ModelParams (port of the RMSNorm families' part,
dense and MoE, and of the DeepSeek MLA blocks, of
``quick_tpu/utils/checkpoint.py::params_to_flat`` (:60) and
``flat_to_params`` (:143)).

The names are the JAX package's (``embed``, ``blocks.{i}.attn.qkv.qweight``,
``lm_head.weight``, ...), so the numpy dict that
``quick_tpu.utils.checkpoint.params_to_flat`` produces loads here unchanged
and both packages compute with the same weights. Arrays may be numpy
(including the ``bfloat16`` numpy dtype JAX arrays convert to) or tensors.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.device import DeviceLike, resolve_device
from quick_tpu_torch.models.model import ModelParams, _tables, check_supported
from quick_tpu_torch.modules.blocks import AttentionParams, BlockParams, MLPParams, MoEParams
from quick_tpu_torch.modules.linear import Linear, QuantLinear
from quick_tpu_torch.modules.mla import MLAParams

ArrayLike = Union[np.ndarray, torch.Tensor]


def to_tensor(a: ArrayLike, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> tensor on ``device``; numpy bfloat16 (an
    extension dtype torch cannot read) goes through its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flat_to_lin(prefix: str, flat, group_size: int, dev) -> "QuantLinear | Linear":
    bias = to_tensor(flat[f"{prefix}.bias"], dev) if f"{prefix}.bias" in flat else None
    if f"{prefix}.qweight" in flat:
        return QuantLinear(
            qweight=to_tensor(flat[f"{prefix}.qweight"], dev),
            scales=to_tensor(flat[f"{prefix}.scales"], dev),
            zeros_x_scales=to_tensor(flat[f"{prefix}.zeros_x_scales"], dev),
            bias=bias,
            group_size=group_size,
        )
    return Linear(weight=to_tensor(flat[f"{prefix}.weight"], dev), bias=bias)


def params_from_flat(
    flat: Dict[str, ArrayLike],
    cfg: ModelConfig,
    device: DeviceLike = None,
    group_size: int = 128,
) -> ModelParams:
    """The port's params from a flat dict named as the JAX package names
    them; a block with ``mlp.router.weight`` is an MoE block, one with
    ``attn.kv_a_norm`` an MLA block (``attn.q``, ``attn.q_b``,
    ``attn.kv_a``, ``attn.kv_a_norm``, ``attn.kv_b``, ``attn.q_a_norm``,
    ``attn.o``); the q / k norms are ``attn.q_norm`` / ``attn.k_norm``, the
    post-norms ``attn_post_norm`` / ``mlp_post_norm``, and a block without
    pre-norms (olmo2) has no ``attn_norm`` / ``mlp_norm``. The rope tables,
    gemma3's local ones too, are rebuilt from ``cfg`` (:249-261)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def lin(prefix):
        return _flat_to_lin(prefix, flat, group_size, dev)

    def opt(key):
        return to_tensor(flat[key], dev) if key in flat else None

    def opt_lin(prefix):
        has = f"{prefix}.weight" in flat or f"{prefix}.qweight" in flat
        return lin(prefix) if has else None

    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"blocks.{i}"
        if f"{p}.mlp.router.weight" in flat:
            mlp = MoEParams(
                router=lin(f"{p}.mlp.router"),
                gate_up_proj=lin(f"{p}.mlp.gate_up"),
                down_proj=lin(f"{p}.mlp.down"),
                shared_gate_up=opt_lin(f"{p}.mlp.shared_gate_up"),
                shared_down=opt_lin(f"{p}.mlp.shared_down"),
                score_bias=(to_tensor(flat[f"{p}.mlp.score_bias"], dev)
                            if f"{p}.mlp.score_bias" in flat else None),
                shared_gate=opt_lin(f"{p}.mlp.shared_gate"),
            )
        else:
            mlp = MLPParams(gate_up_proj=lin(f"{p}.mlp.gate_up"), down_proj=lin(f"{p}.mlp.down"))
        if f"{p}.attn.kv_a_norm" in flat:  # deepseek MLA
            attn = MLAParams(
                q_proj=lin(f"{p}.attn.q"),
                kv_a_proj=lin(f"{p}.attn.kv_a"),
                kv_a_norm=to_tensor(flat[f"{p}.attn.kv_a_norm"], dev),
                kv_b_proj=lin(f"{p}.attn.kv_b"),
                o_proj=lin(f"{p}.attn.o"),
                q_b_proj=opt_lin(f"{p}.attn.q_b"),
                q_a_norm=(to_tensor(flat[f"{p}.attn.q_a_norm"], dev)
                          if f"{p}.attn.q_a_norm" in flat else None),
            )
        else:
            attn = AttentionParams(
                qkv_proj=lin(f"{p}.attn.qkv"), o_proj=lin(f"{p}.attn.o"),
                q_norm=(to_tensor(flat[f"{p}.attn.q_norm"], dev)
                        if f"{p}.attn.q_norm" in flat else None),
                k_norm=(to_tensor(flat[f"{p}.attn.k_norm"], dev)
                        if f"{p}.attn.k_norm" in flat else None),
            )
        blocks.append(BlockParams(
            attn_norm=opt(f"{p}.attn_norm"), attn=attn, mlp_norm=opt(f"{p}.mlp_norm"), mlp=mlp,
            attn_post_norm=opt(f"{p}.attn_post_norm"), mlp_post_norm=opt(f"{p}.mlp_post_norm"),
        ))
    return ModelParams(
        embed=to_tensor(flat["embed"], dev),
        blocks=blocks,
        final_norm=to_tensor(flat["final_norm"], dev),
        lm_head=_flat_to_lin("lm_head", flat, group_size, dev),
        **_tables(cfg, dev),
    )


def _lin_to_flat(prefix: str, lin, out: Dict[str, torch.Tensor], put) -> None:
    fields = (
        ("qweight", "scales", "zeros_x_scales", "bias")
        if isinstance(lin, QuantLinear) else ("weight", "bias")
    )
    for f in fields:
        t = getattr(lin, f)
        if t is not None:
            out[f"{prefix}.{f}"] = put(t)


def params_to_flat(params: ModelParams, cpu: bool = True) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_flat`: the keys, dtypes and bytes of
    ``quick_tpu.utils.checkpoint.params_to_flat`` (:60) for the RMSNorm
    families with dense or MoE blocks (post-norms at :87-90) and for MLA
    blocks, in its order (which decides the shard
    boundaries on save), as contiguous tensors — on the CPU, or where they
    lie with ``cpu=False``.
    A tied ``lm_head.weight`` (a transposed view of the embedding) becomes
    its own contiguous copy, as ``np.asarray`` makes it in the JAX package.
    Tensors, not numpy arrays: numpy has no bf16 without ``ml_dtypes``."""

    def put(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        return (t.cpu() if cpu else t).contiguous()

    out: Dict[str, torch.Tensor] = {"embed": put(params.embed)}
    for i, blk in enumerate(params.blocks):
        p = f"blocks.{i}"
        if blk.attn_norm is not None:
            out[f"{p}.attn_norm"] = put(blk.attn_norm)
        if blk.mlp_norm is not None:
            out[f"{p}.mlp_norm"] = put(blk.mlp_norm)
        a = blk.attn
        if isinstance(a, MLAParams):
            _lin_to_flat(f"{p}.attn.q", a.q_proj, out, put)
            _lin_to_flat(f"{p}.attn.kv_a", a.kv_a_proj, out, put)
            _lin_to_flat(f"{p}.attn.kv_b", a.kv_b_proj, out, put)
            _lin_to_flat(f"{p}.attn.o", a.o_proj, out, put)
            out[f"{p}.attn.kv_a_norm"] = put(a.kv_a_norm)
            if a.q_b_proj is not None:
                _lin_to_flat(f"{p}.attn.q_b", a.q_b_proj, out, put)
                out[f"{p}.attn.q_a_norm"] = put(a.q_a_norm)
        else:
            _lin_to_flat(f"{p}.attn.qkv", a.qkv_proj, out, put)
            _lin_to_flat(f"{p}.attn.o", a.o_proj, out, put)
            if a.q_norm is not None:
                out[f"{p}.attn.q_norm"] = put(a.q_norm)
                out[f"{p}.attn.k_norm"] = put(a.k_norm)
        if blk.attn_post_norm is not None:
            out[f"{p}.attn_post_norm"] = put(blk.attn_post_norm)
        if blk.mlp_post_norm is not None:
            out[f"{p}.mlp_post_norm"] = put(blk.mlp_post_norm)
        mlp = blk.mlp
        if isinstance(mlp, MoEParams):
            _lin_to_flat(f"{p}.mlp.router", mlp.router, out, put)
        _lin_to_flat(f"{p}.mlp.gate_up", mlp.gate_up_proj, out, put)
        _lin_to_flat(f"{p}.mlp.down", mlp.down_proj, out, put)
        if isinstance(mlp, MoEParams):
            if mlp.shared_gate_up is not None:
                _lin_to_flat(f"{p}.mlp.shared_gate_up", mlp.shared_gate_up, out, put)
                _lin_to_flat(f"{p}.mlp.shared_down", mlp.shared_down, out, put)
            if mlp.shared_gate is not None:
                _lin_to_flat(f"{p}.mlp.shared_gate", mlp.shared_gate, out, put)
            if mlp.score_bias is not None:
                out[f"{p}.mlp.score_bias"] = put(mlp.score_bias)
    out["final_norm"] = put(params.final_norm)
    _lin_to_flat("lm_head", params.lm_head, out, put)
    return out
