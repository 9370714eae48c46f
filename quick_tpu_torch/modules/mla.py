"""Multi-head Latent Attention, DeepSeek-V2 / V3 (port of
``quick_tpu/modules/mla.py``).

The cache holds only the compressed latent of each token: the rope'd k_pe
(``qk_rope_head_dim``) in the k slot and the normed latent c
(``kv_lora_rank``) in the v slot, shared by every query head (MQA). ``kv_b``
stays float: its weight is split into W_UK and W_UV and used as einsum
operands. ``mla_attention_forward`` takes one of three branches, as the JAX
package does:

- a one-token step over a paged cache on the card: W_UK is absorbed into
  the queries (q_c = q_nope @ W_UK) and the paged MLA kernel K10 / K10q
  (``ops/mla_paged_attention.py``) attends over the latent pages, then the
  context re-projects through W_UV (:139-164);
- the expanded prefill, when the query span is a sizable fraction of the
  cache extent (``_use_expanded``): k = [c @ W_UK | k_pe], v = c @ W_UV per
  head, through ``causal_attention`` (K2 at q / k 192, v 128 on the card;
  :180-217);
- otherwise the absorbed MQA einsums over the latent (dense-cache decode,
  short serving chunks): torch ops, as the JAX package leaves them to XLA
  (:219-258).

The precision of each step is the JAX package's: q_c is summed in f32 and
rounded to bf16, the absorbed probabilities stay f32, and ctx @ W_UV runs
in f32. Tensor parallelism (head-sharded q_b / kv_b / o) is ROADMAP A15.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.modules.cache import KVCache, write_start
from quick_tpu_torch.modules.linear import AnyLinear, Linear
from quick_tpu_torch.ops.norms import rms_norm

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass
class MLAParams:
    """DeepSeek MLA projections (``MLAParams`` :51; HF modeling_deepseek_v2
    naming). ``q_proj`` is the full query projection (V2-Lite, q_lora_rank
    None) or the q_a down-projection; ``q_b_proj`` / ``q_a_norm`` only in
    the latter case."""

    q_proj: AnyLinear            # [D, hq*(dn+dr)] or [D, q_lora_rank]
    kv_a_proj: AnyLinear         # [D, R + dr]
    kv_a_norm: torch.Tensor      # [R]
    kv_b_proj: Linear            # [R, hq*(dn+dv)], float (absorbed use)
    o_proj: AnyLinear            # [hq*dv, D]
    q_b_proj: Optional[AnyLinear] = None  # [q_lora_rank, hq*(dn+dr)]
    q_a_norm: Optional[torch.Tensor] = None  # [q_lora_rank]


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """(dn + dr)^-0.5, times the deepseek-yarn mscale^2 correction
    (``mla_softmax_scale`` :67)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    d = dict(cfg.rope_scaling) if cfg.rope_scaling else {}
    msad = d.get("mscale_all_dim")
    factor = float(d.get("factor", 1.0))
    if msad and factor > 1.0:
        m = 0.1 * float(msad) * math.log(factor) + 1.0
        scale = scale * m * m
    return scale


def _use_expanded(S: int, T: int) -> bool:
    """Expand the latent to per-head K / V (and ride the flash kernel) when
    the query span is a sizable fraction of the cache extent (``_use_expanded``
    :80); ``QUICK_TPU_MLA_EXPANDED=0/1`` forces a branch, as in the JAX
    package."""
    env = os.environ.get("QUICK_TPU_MLA_EXPANDED", "")
    if env in ("0", "1"):
        return env == "1"
    return S >= 32 and 8 * S >= T


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of two operands upcast to f32 (``preferred_element_type=f32``
    on bf16 inputs: exact products, f32 sums)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def mla_attention_forward(
    p: MLAParams,
    cfg: ModelConfig,
    x: torch.Tensor,            # [B, S, D]
    rope_cos: torch.Tensor,     # tables over qk_rope_head_dim
    rope_sin: torch.Tensor,
    cache,                      # KVCache (k [L,B,1,Smax,dr], v [L,B,1,Smax,R])
    # or the PagedKVCache of latent pages; None without a cache
    layer_idx: int,
    positions: torch.Tensor,    # [B, S]
    return_pre_o: bool = False,  # return the [B, S, hq*dv] activation BEFORE
    # o_proj (the AWQ o-group calibration input); prefill branches only
) -> Tuple[torch.Tensor, Optional[object]]:
    """``mla_attention_forward`` (:94); the cache is written in place."""
    from quick_tpu_torch.modules.blocks import _use_paged_kernel
    from quick_tpu_torch.ops.rope import apply_rope

    B, S, _ = x.shape
    hq = cfg.num_attention_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, R = cfg.v_head_dim, cfg.kv_lora_rank
    scale = mla_softmax_scale(cfg)

    q = p.q_proj(x)
    if p.q_b_proj is not None:  # q-LoRA (full v2 / v3)
        q = p.q_b_proj(rms_norm(q, p.q_a_norm, cfg.rms_norm_eps))
    q = q.reshape(B, S, hq, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, rope_cos, rope_sin)

    ckv = p.kv_a_proj(x)  # [B, S, R + dr]
    c = rms_norm(ckv[..., :R], p.kv_a_norm, cfg.rms_norm_eps)
    k_pe = apply_rope(ckv[..., None, R:], positions, rope_cos, rope_sin)

    wkv_b = p.kv_b_proj.weight.reshape(R, hq, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]

    if cache is not None:
        start = write_start(cache, S)  # a dense step's on the device; the paged [B]
        cache = cache.update(layer_idx, k_pe, c[:, :, None, :], start)  # in place
        if S == 1 and _use_paged_kernel(cache):
            from quick_tpu_torch.ops.mla_paged_attention import mla_paged_decode_attention

            q_c = _f32_einsum("bshd,rhd->bshr", q_nope, w_uk.to(q_nope.dtype)).to(q_nope.dtype)
            ctx_c = mla_paged_decode_attention(
                q_c[:, 0], q_pe[:, 0], cache.k_pages, cache.v_pages, cache.block_table,
                start + 1, layer=layer_idx, scale=scale, kv_scales=cache.kv_scales,
            )[:, None]  # [B, 1, hq, R]
            out = _f32_einsum("bshr,rhd->bshd", ctx_c, w_uv).to(x.dtype)
            return p.o_proj(out.reshape(B, S, hq * dv)), cache
        # the head-major read: the dense cache's views, or the paged
        # cache's gather (INT8 pages come back dequantized)
        k_l, v_l = cache.layer(layer_idx)  # [B, 1, T, dr] / [B, 1, T, R]
        kpe_all, c_all = k_l[:, 0], v_l[:, 0]
        kv_len = start + S
        q_offset = start
    else:
        kpe_all, c_all = k_pe[:, :, 0], c
        kv_len, q_offset = S, 0
    T = c_all.shape[1]

    if _use_expanded(S, T):
        from quick_tpu_torch.ops.attention import causal_attention

        k_nope = _f32_einsum("btr,rhd->bthd", c_all, w_uk.to(c_all.dtype)).to(q_nope.dtype)
        v_exp = _f32_einsum("btr,rhd->bthd", c_all, w_uv.to(c_all.dtype)).to(q_nope.dtype)
        k_full = torch.cat(
            [k_nope, kpe_all[:, :, None, :].expand(B, T, hq, dr).to(k_nope.dtype)], dim=-1)
        q_full = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
        out = causal_attention(q_full, k_full, v_exp, q_offset=q_offset, kv_len=kv_len,
                               scale=scale).reshape(B, S, hq * dv)
        return (out if return_pre_o else p.o_proj(out)), cache

    # absorbed MQA over the latent: no cache expansion
    q_c = _f32_einsum("bshd,rhd->bshr", q_nope, w_uk.to(q_nope.dtype)).to(q_nope.dtype)
    scores = (_f32_einsum("bshr,btr->bhst", q_c, c_all)
              + _f32_einsum("bshd,btd->bhst", q_pe, kpe_all)) * scale
    off = torch.as_tensor(q_offset, device=x.device)
    off = off.reshape(-1, 1, 1, 1) if off.ndim > 0 else off
    q_pos = torch.arange(S, device=x.device).reshape(1, 1, S, 1) + off
    k_pos = torch.arange(T, device=x.device).reshape(1, 1, 1, T)
    klen = torch.as_tensor(kv_len, device=x.device)
    klen = klen.reshape(-1, 1, 1, 1) if klen.ndim > 0 else klen
    mask = (k_pos <= q_pos) & (k_pos < klen)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    attn = torch.softmax(scores, dim=-1)
    # probabilities stay f32, as the dense einsum path
    ctx_c = _f32_einsum("bhst,btr->bshr", attn, c_all).to(x.dtype)  # [B, S, hq, R]
    out = _f32_einsum("bshr,rhd->bshd", ctx_c, w_uv.to(ctx_c.dtype)).to(x.dtype)
    out = out.reshape(B, S, hq * dv)
    return (out if return_pre_o else p.o_proj(out)), cache


def make_mla_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> KVCache:
    """The dense latent cache (``make_mla_cache`` :261): k slot
    [L, B, 1, Smax, dr] (rope'd k_pe), v slot [L, B, 1, Smax, R] (normed
    latent)."""
    return KVCache.create(cfg.num_hidden_layers, batch, max_seq, 1, cfg.qk_rope_head_dim,
                          dtype, device=device, v_head_dim=cfg.kv_lora_rank)
