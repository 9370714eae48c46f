"""The decoder-only model: parameters and forward (port of
``quick_tpu/models/model.py``).

``ModelParams`` is a plain dataclass of tensors; ``model_forward`` is a
function of (params, tokens, cache), as in the JAX package. Random
initializers draw from a ``torch.Generator`` seeded by the caller; they do
not reproduce ``jax.random``'s numbers — to hold the two packages to the
same weights, build them in one and carry them over with
``models/convert.py::params_from_flat``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from quick_tpu_torch.config import ModelConfig
from quick_tpu_torch.device import DeviceLike, resolve_device
from quick_tpu_torch.modules.blocks import (
    AnyCache,
    AttentionParams,
    BlockParams,
    MLPParams,
    MoEParams,
    _fuse_decode_norm_ok,
    block_forward,
    dense_decode_route,
    scalar_as,
)
from quick_tpu_torch.modules.cache import KVCache
from quick_tpu_torch.modules.linear import Linear, QuantLinear, cast_scales_env
from quick_tpu_torch.modules.mla import MLAParams
from quick_tpu_torch.ops.norms import rms_norm
from quick_tpu_torch.ops.rope import local_rope_tables, rope_table


@dataclasses.dataclass
class ModelParams:
    embed: torch.Tensor  # [V, D]
    blocks: List[BlockParams]
    final_norm: torch.Tensor
    lm_head: "Linear | QuantLinear"
    rope_cos: torch.Tensor
    rope_sin: torch.Tensor
    #: gemma3's dual rope: the sliding-window layers read these tables
    #: (``cfg.rope_local_theta``, no scaling) instead of rope_cos / rope_sin
    rope_cos_local: Optional[torch.Tensor] = None
    rope_sin_local: Optional[torch.Tensor] = None

    def layer_tables(self, cfg: ModelConfig, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) that layer ``layer_idx`` ropes with: the local tables
        on a sliding layer where the model has them (``model_forward``
        :131-139)."""
        if self.rope_cos_local is not None and cfg.layer_is_sliding(layer_idx):
            return self.rope_cos_local, self.rope_sin_local
        return self.rope_cos, self.rope_sin


#: the other families' config switches, each at the value the RMSNorm
#: families' path has; the port does not run them yet (ROADMAP A12): the
#: LayerNorm families (cohere's LayerNorm qk-norm among them), ALiBi,
#: parallel residual, learned positions, the embedding norm, the ungated
#: MLP, relu and MPT's qkv clip
_RMSNORM_PATH = dict(
    use_alibi=False, parallel_residual=False, use_rope=True, learned_pos=False,
    embed_norm=False, layernorm="rmsnorm", qkv_clip=None, gated_mlp=True,
)
#: the MLP activations the port runs (GeGLU is gelu's tanh form)
_ACTS = ("silu", "gelu")


#: the MoE routers ``moe_forward`` runs
PORTED_ROUTERS = ("mixtral", "softmax_all", "deepseek")


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the RMSNorm families: the llama path with dense or MoE
    ("mixtral", "softmax_all" and "deepseek" routers) MLPs, DeepSeek's MLA
    attention, qwen3's and gemma3's per-head and olmo2's full-width RMS
    qk-norm, gemma's GeGLU, embedding scale, sandwich norms, query scale,
    dual rope and logit softcap, olmo2's post-norms without pre-norms, and
    granite's and minicpm's multipliers. The other families' switches raise
    until their slices land."""
    if cfg.is_moe and cfg.moe_router not in PORTED_ROUTERS:
        raise NotImplementedError(
            f"{cfg.model_type}: the {cfg.moe_router!r} MoE router is not ported "
            f"(the port runs {PORTED_ROUTERS})"
        )
    off = [k for k, v in _RMSNORM_PATH.items() if getattr(cfg, k) != v]
    if cfg.act_fn not in _ACTS:
        off.append(f"act_fn={cfg.act_fn!r}")
    if off:
        raise NotImplementedError(
            f"{cfg.model_type}: {', '.join(off)} not ported yet; the port "
            "runs the RMSNorm families (ROADMAP A12)"
        )


def embed_scaled(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The embedding path's scales (``model_forward`` :98-104): gemma's
    x * sqrt(D), with the scalar rounded to x's dtype first (59.75 for D =
    3584), then granite's embedding_multiplier / minicpm's scale_emb."""
    if cfg.embed_scale:
        x = x * scalar_as(cfg.hidden_size ** 0.5, x.dtype)
    if cfg.embed_multiplier is not None:
        x = x * scalar_as(cfg.embed_multiplier, x.dtype)
    return x


def model_forward(
    params: ModelParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    cache: Optional[AnyCache] = None,
    positions: Optional[torch.Tensor] = None,
    last_token_only: bool = False,
    advance: Optional[torch.Tensor] = None,  # [B] valid-token counts:
    # chunked serving steps advance per-slot lengths by this instead of S
    last_valid: Optional[torch.Tensor] = None,  # [B] per-row valid counts:
    # the head runs on each row's LAST VALID position only ([B, 1, V])
) -> Tuple[torch.Tensor, Optional[AnyCache]]:
    """Returns (logits [B, S, V] f32 or [B, 1, V], cache). The cache is
    updated in place and returned with its new length.

    ``cache`` is the dense KVCache (a host int length shared by every row)
    or a PagedKVCache ([B] per-slot lengths on the device); with the latter
    the per-slot start positions, the length update and the last-valid
    gather all stay on the device."""
    B, S = tokens.shape
    dev = tokens.device
    # a one-token step over the dense cache reads its length on the device
    # (a captured decode step stays right on replay)
    dense_step = S == 1 and isinstance(cache, KVCache)
    if positions is None:
        start = cache.length if cache is not None else 0
        if dense_step:
            start = cache.length_dev.reshape(1, 1)
        elif isinstance(start, torch.Tensor):
            start = start.reshape(-1, 1)  # [B, 1] per-slot starts
        positions = torch.arange(S, device=dev)[None, :] + start
        # clamp: padded chunk positions must not overrun the rope table
        positions = torch.clamp(positions, max=cfg.max_position_embeddings - 1)
        positions = positions.expand(B, S)
    # chunked serving steps carry per-slot valid counts: padding tokens get
    # zero MoE combine weights (:88-92)
    token_mask = None
    if advance is not None and cfg.is_moe:
        token_mask = (torch.arange(S, device=dev)[None, :]
                      < torch.as_tensor(advance, device=dev).reshape(-1, 1))
    x = params.embed[tokens].to(torch.bfloat16)
    x = embed_scaled(x, cfg)
    decode_lengths = None
    if dense_step and not cfg.is_mla and any(
        dense_decode_route(cfg, cache, B, params.rope_cos, i, dev) == "dense_kernel"
        for i in range(len(params.blocks))
    ):
        # the dense decode kernel reads per-row lengths from the card: one
        # [B] tensor per forward, shared by every layer
        decode_lengths = (cache.length_dev + 1).expand(B).contiguous()
    for i, blk in enumerate(params.blocks):
        x, cache = block_forward(
            blk, cfg, x, *params.layer_tables(cfg, i), cache, i, positions,
            decode_lengths=decode_lengths, token_mask=token_mask,
        )
    if isinstance(cache, KVCache) and advance is None:
        cache = cache.advance(S)
    elif cache is not None:
        cache = cache.with_length(cache.length + (S if advance is None else advance))
    if last_token_only:
        x = x[:, -1:]
    if last_valid is not None and S > 1:
        # S == 1 (decode) skips the gather, as in the JAX package (:149-154)
        idx = torch.clamp(last_valid.to(torch.int64) - 1, min=0)
        x = torch.gather(x, 1, idx.reshape(B, 1, 1).expand(B, 1, x.shape[-1]))
    if _fuse_decode_norm_ok(params.lm_head, x):
        # int4 head: the final RMSNorm rides in the GEMM kernel's prologue
        logits = params.lm_head(x, fuse_norm=(params.final_norm, cfg.rms_norm_eps))
    else:
        logits = params.lm_head(rms_norm(x, params.final_norm, cfg.rms_norm_eps))
    logits = logits.to(torch.float32)
    if cfg.logit_scale is not None:
        # granite's 1 / logits_scaling, minicpm's dim_model_base / D: in f32,
        # before any softcap (:174-178)
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits, cache


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def _ones(n, dtype, device):
    return torch.ones(n, dtype=dtype, device=device)


def _block(cfg: ModelConfig, attn: AttentionParams, mlp: MLPParams, dtype,
           device) -> BlockParams:
    """Ones for the block's norms: the pre-norms unless ``pre_norms`` is
    off (olmo2), the post-norms under ``use_post_norms`` (gemma2 / gemma3 /
    olmo2; the initializers' :290-300 and :420-430)."""
    D = cfg.hidden_size
    pre = _ones(D, dtype, device) if cfg.pre_norms else None
    return BlockParams(
        attn_norm=pre, attn=attn, mlp_norm=None if pre is None else _ones(D, dtype, device),
        mlp=mlp,
        attn_post_norm=_ones(D, dtype, device) if cfg.use_post_norms else None,
        mlp_post_norm=_ones(D, dtype, device) if cfg.use_post_norms else None,
    )


def _qk_norms(cfg: ModelConfig, dtype, device) -> dict:
    """The q / k RMSNorm weights, ones: per-head [head_dim] (qwen3, gemma3)
    or full-width [heads * head_dim] (olmo2's ``qk_norm_full``; the
    initializers' :246-251 and :379-384), or none."""
    if not cfg.use_qk_norm:
        return {}
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return dict(q_norm=_ones(hq * hd if cfg.qk_norm_full else hd, dtype, device),
                k_norm=_ones(hkv * hd if cfg.qk_norm_full else hd, dtype, device))


def _tables(cfg: ModelConfig, device) -> dict:
    """The rope tables, and gemma3's local ones where the config has them
    (:305, :435)."""
    cos, sin = rope_table(
        cfg.max_position_embeddings, cfg.rotary_dim or cfg.head_dim,
        cfg.rope_theta, cfg.rope_scaling, device=device,
    )
    lcos, lsin = local_rope_tables(cfg, device=device)
    return dict(rope_cos=cos, rope_sin=sin, rope_cos_local=lcos, rope_sin_local=lsin)


def _randn(gen, shape, dtype, device, scale):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _moe_params(cfg: ModelConfig, expert_lin, float_lin) -> MoEParams:
    """A random MoE layer (the MoE branches of ``init_float_params`` :254
    and ``init_quant_params`` :387): ``expert_lin(kin, kout, experts=None)``
    builds the experts (stacked) and the shared expert, ``float_lin`` the
    router and qwen2_moe's [D, 1] shared-expert gate, both float."""
    D, E = cfg.hidden_size, cfg.num_local_experts
    Fe = cfg.moe_intermediate_size or cfg.intermediate_size
    Fs = cfg.shared_intermediate_size or Fe * cfg.n_shared_experts
    router = float_lin(D, E)
    return MoEParams(
        router=router,
        gate_up_proj=expert_lin(D, 2 * Fe, experts=E),
        down_proj=expert_lin(Fe, D, experts=E),
        shared_gate_up=expert_lin(D, 2 * Fs) if Fs else None,
        shared_down=expert_lin(Fs, D) if Fs else None,
        # deepseek v3's selection bias (zeros, as the JAX initializers)
        score_bias=(torch.zeros(E, dtype=torch.float32, device=router.weight.device)
                    if cfg.scoring_func == "sigmoid" else None),
        shared_gate=float_lin(D, 1) if Fs and cfg.shared_expert_gate else None,
    )


def _init_mla(cfg: ModelConfig, make, float_make, dtype, device) -> MLAParams:
    """Random MLAParams (``_init_mla`` :188): ``make(kin, kout)`` builds
    the quantized or float linears; kv_b is always ``float_make``'s (it is
    consumed as the absorbed W_UK / W_UV einsum operands)."""
    D, hq = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q = make(D, cfg.q_lora_rank)
        q_b = make(cfg.q_lora_rank, hq * (dn + dr))
        q_a_norm = _ones(cfg.q_lora_rank, dtype, device)
    else:
        q, q_b, q_a_norm = make(D, hq * (dn + dr)), None, None
    return MLAParams(
        q_proj=q, kv_a_proj=make(D, R + dr), kv_a_norm=_ones(R, dtype, device),
        kv_b_proj=float_make(R, hq * (dn + dv)), o_proj=make(hq * dv, D),
        q_b_proj=q_b, q_a_norm=q_a_norm,
    )


def init_float_params(
    cfg: ModelConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> ModelParams:
    """Random-init float model (dense or MoE layers)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def dense(kin, kout, experts=None):
        lead = () if experts is None else (experts,)
        return Linear(_randn(gen, lead + (kin, kout), dtype, dev, 1.0 / math.sqrt(kin)))

    blocks = []
    for i in range(cfg.num_hidden_layers):
        if cfg.is_mla:
            attn = _init_mla(cfg, dense, dense, dtype, dev)
        else:
            qkv = dense(D, (hq + 2 * hkv) * hd)
            if cfg.attention_bias:
                qkv = Linear(qkv.weight, torch.zeros((hq + 2 * hkv) * hd, dtype=dtype, device=dev))
            attn = AttentionParams(qkv_proj=qkv, o_proj=dense(hq * hd, D),
                                   **_qk_norms(cfg, dtype, dev))
        if cfg.layer_is_moe(i):
            mlp = _moe_params(cfg, dense, dense)
        else:
            mlp = MLPParams(gate_up_proj=dense(D, 2 * F), down_proj=dense(F, D))
        blocks.append(_block(cfg, attn, mlp, dtype, dev))
    embed = _randn(gen, (cfg.vocab_size, D), dtype, dev, 0.02)
    lm_head = Linear(embed.T) if cfg.tie_word_embeddings else dense(D, cfg.vocab_size)
    return ModelParams(
        embed=embed, blocks=blocks, final_norm=_ones(D, dtype, dev), lm_head=lm_head,
        **_tables(cfg, dev),
    )


def init_quant_params(
    cfg: ModelConfig, seed: int = 0, group_size: int = 128,
    dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
) -> ModelParams:
    """Random-init an already-quantized model (packed int32 qweights, f32
    scales and z*s, tied float lm_head) — ``init_quant_params`` (:330) with
    the same distributions, drawn on ``device``; under
    ``QUICK_TPU_BF16_SCALES=1`` the scales are rounded through bf16."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    G = group_size

    def qlin(kin, kout, experts=None):
        lead = () if experts is None else (experts,)
        qweight = torch.randint(
            -2**31, 2**31, lead + (kin // 8, kout), generator=gen, device=dev,
            dtype=torch.int32,
        )
        u = torch.rand(lead + (kin // G, kout), generator=gen, device=dev)
        scales = (u * 0.004 + 0.001) / math.sqrt(kin)
        zeros = torch.round(torch.rand(lead + (kin // G, kout), generator=gen, device=dev) * 15)
        return QuantLinear(qweight, scales, zeros * scales, None, G)

    def fdense(kin, kout):
        return Linear(_randn(gen, (kin, kout), dtype, dev, 1.0 / math.sqrt(kin)))

    blocks = []
    for i in range(cfg.num_hidden_layers):
        if cfg.is_mla:
            attn = _init_mla(cfg, qlin, fdense, dtype, dev)
        else:
            attn = AttentionParams(
                qkv_proj=qlin(D, (hq + 2 * hkv) * hd), o_proj=qlin(hq * hd, D),
                **_qk_norms(cfg, dtype, dev),
            )
        if cfg.layer_is_moe(i):
            mlp = _moe_params(cfg, qlin, fdense)
        else:
            mlp = MLPParams(gate_up_proj=qlin(D, 2 * F), down_proj=qlin(F, D))
        blocks.append(_block(cfg, attn, mlp, dtype, dev))
    embed = _randn(gen, (cfg.vocab_size, D), dtype, dev, 0.02)
    # QUICK_TPU_BF16_SCALES=1: scales rounded through bf16 (:437-455)
    return cast_scales_env(ModelParams(
        embed=embed, blocks=blocks, final_norm=_ones(D, dtype, dev),
        lm_head=Linear(embed.T), **_tables(cfg, dev),
    ))


#: user-facing / HF-style layer names -> fused linears (the JAX package's
#: ``_NAME_ALIASES``, :459)
_NAME_ALIASES = {
    "q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv", "qkv_proj": "qkv",
    "W_pack": "qkv", "query_key_value": "qkv", "Wqkv": "qkv", "c_attn": "qkv",
    "o_proj": "o", "out_proj": "o", "dense": "o", "c_proj": "o",
    "gate_proj": "gate_up", "up_proj": "gate_up", "w1": "gate_up",
    "w3": "gate_up", "fc1": "gate_up", "fc_in": "gate_up",
    "dense_h_to_4h": "gate_up", "c_fc": "gate_up",
    "down_proj": "down", "w2": "down", "fc2": "down", "fc_out": "down",
    "dense_4h_to_h": "down",
    "gate": "router",
}


def canonical_skips(modules_to_not_convert) -> frozenset:
    """``modules_to_not_convert`` as fused-linear names ({'qkv', 'o',
    'gate_up', 'down', 'router'}), matched by substring, longer alias keys
    first (``canonical_skips`` :477)."""
    out = set()
    keys = sorted(_NAME_ALIASES, key=len, reverse=True)
    for pat in modules_to_not_convert or ():
        if pat in ("qkv", "o", "gate_up", "down", "router"):
            out.add(pat)
            continue
        for key in keys:
            if key in pat:
                out.add(_NAME_ALIASES[key])
                break
        else:
            out.add(pat)  # unknown: kept verbatim (matches nothing)
    return frozenset(out)


def quantize_params(
    params: ModelParams,
    cfg: ModelConfig,
    group_size: int = 128,
    zero_point: bool = True,
    modules_to_not_convert=None,
) -> ModelParams:
    """RTN-quantize every block linear to W4A16 (``quantize_params`` :498):
    stacked MoE experts expert by expert; MLA's q (q_a, q_b), kv_a and o
    (kv_b stays float: it is consumed as einsum operands, :551-567); the
    embedding, lm_head, MoE router and qwen2_moe shared-expert gate stay
    float. Linears named in ``modules_to_not_convert`` stay float too."""
    skip = canonical_skips(modules_to_not_convert)

    def q(lin, name):
        if isinstance(lin, QuantLinear) or name in skip:
            return lin
        return QuantLinear.from_float(lin.weight, lin.bias, group_size, zero_point)

    def q_stacked(lin, name):
        """A stacked-expert weight [E, K, N], quantized expert by expert."""
        if isinstance(lin, QuantLinear) or name in skip:
            return lin
        qls = [QuantLinear.from_float(lin.weight[e], None if lin.bias is None else lin.bias[e],
                                      group_size, zero_point)
               for e in range(lin.weight.shape[0])]
        return QuantLinear(
            qweight=torch.stack([ql.qweight for ql in qls]),
            scales=torch.stack([ql.scales for ql in qls]),
            zeros_x_scales=torch.stack([ql.zeros_x_scales for ql in qls]),
            bias=None if qls[0].bias is None else torch.stack([ql.bias for ql in qls]),
            group_size=group_size,
        )

    def q_mlp(mlp):
        if not isinstance(mlp, MoEParams):
            return dataclasses.replace(mlp, gate_up_proj=q(mlp.gate_up_proj, "gate_up"),
                                       down_proj=q(mlp.down_proj, "down"))
        return dataclasses.replace(
            mlp,
            gate_up_proj=q_stacked(mlp.gate_up_proj, "gate_up"),
            down_proj=q_stacked(mlp.down_proj, "down"),
            shared_gate_up=None if mlp.shared_gate_up is None else q(mlp.shared_gate_up, "gate_up"),
            shared_down=None if mlp.shared_down is None else q(mlp.shared_down, "down"),
        )

    def q_attn(attn):
        if isinstance(attn, MLAParams):
            return dataclasses.replace(
                attn, q_proj=q(attn.q_proj, "qkv"), kv_a_proj=q(attn.kv_a_proj, "qkv"),
                o_proj=q(attn.o_proj, "o"),
                q_b_proj=None if attn.q_b_proj is None else q(attn.q_b_proj, "qkv"),
            )
        return dataclasses.replace(attn, qkv_proj=q(attn.qkv_proj, "qkv"),
                                   o_proj=q(attn.o_proj, "o"))

    blocks = [dataclasses.replace(blk, attn=q_attn(blk.attn), mlp=q_mlp(blk.mlp))
              for blk in params.blocks]
    return dataclasses.replace(params, blocks=blocks)
