"""Port parity for AWQ on MoE and MLA blocks: ``_awq_moe`` for mixtral and
qwen2_moe (the shared expert and its sigmoid gate) with ``skip``, and
``awq_quantize_mla_block`` for deepseek_v2 with and without q-LoRA, each
one block from the same input against ``quick_tpu`` on the CPU, the JAX
search run eagerly; the rule is tests/_awq_parity.py's.

The float experts route on the block's normed input. Each test asserts that
every routed token's least routing margin (``_torch_port.least_route_gap``)
is above ``GAP``, so a comparison cannot flake on a router tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _awq_parity import assert_close, assert_params_equal, check_searches, recorded, to_torch
from _torch_port import least_route_gap

import quick_tpu.quantize.awq as jawq
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.quantize.awq as tawq
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_float_params as jax_init_float
from quick_tpu.models.auto import apply_model_type as jax_apply
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import apply_model_type
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.modules.linear import Linear, QuantLinear
from quick_tpu_torch.modules.mla import MLAParams

G = 32
CALIB = (2, 32)
BASE = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            num_local_experts=4, num_experts_per_tok=2)
MLA = dict(BASE, model_type="deepseek_v2", num_key_value_heads=4, kv_lora_rank=64,
           qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, head_dim=48, rotary_dim=16,
           moe_router="deepseek", moe_intermediate_size=64, n_shared_experts=2,
           norm_topk_prob=False, rms_norm_eps=1e-6)
CASES = {
    "mixtral_skip_down": (dict(BASE, model_type="mixtral"), {"down"}),
    # shared expert (128 wide) gated by sigmoid(shared_gate(x)), qkv biases
    "qwen2_moe_skip_gate_up": (dict(BASE, model_type="qwen2_moe", moe_intermediate_size=64,
                                    shared_intermediate_size=128), {"gate_up"}),
    # V2-Lite's layout: full q projection, an MoE layer with two shared experts
    "deepseek_v2_moe": (dict(MLA, first_k_dense_replace=0), set()),
    # q-LoRA (the q_a_norm -> q_b fold) over a dense MLP layer
    "deepseek_v2_qlora_dense": (dict(MLA, q_lora_rank=64, first_k_dense_replace=1), set()),
}
#: least gap between the k-th and (k+1)-th routing score of a routed token
GAP = 1e-4
#: x_next, the JAX grid choices imposed: the float MoE combine (f32 sums of
#: bf16 expert outputs in other orders) stays within a bf16 step; MLA's
#: float attention (the expanded einsums, rope and softmax summed in other
#: orders) feeds the MLP inputs a bf16 step apart, which its SiLU-GLU and
#: two products carry to a few steps
X_TOL = {"mixtral_skip_down": 2.0 ** -7, "qwen2_moe_skip_gate_up": 2.0 ** -7,
         "deepseek_v2_moe": 5e-2, "deepseek_v2_qlora_dense": 5e-2}


def _expected_kinds(name, cfg) -> list:
    """The searches of one block in call order."""
    if cfg.is_mla:
        attn = ["scale"] * (2 if cfg.q_lora_rank else 1) + ["scale", "clip"]
    else:
        attn = ["scale", "clip", "clip"]  # GQA: no o scale group
    if not cfg.layer_is_moe(0):
        return attn + ["scale", "scale", "clip", "clip"]
    per_expert = ["scale", "clip", "clip"]
    shared = per_expert if cfg.n_shared_experts or cfg.shared_intermediate_size else []
    return attn + ["scale"] + per_expert * cfg.num_local_experts + shared


@pytest.mark.parametrize("name", list(CASES))
def test_awq_moe_mla_block_matches_jax(monkeypatch, name):
    """One block from the same input: every search by the rule; with the
    JAX grid choices imposed, the packed experts, shared expert and
    attention byte-equal (float where ``skip`` keeps them; kv_b, the router
    and the shared-expert gate float) and x_next within X_TOL."""
    kw, skip = CASES[name]
    jcfg, tcfg = jax_apply(JaxConfig(**kw)), apply_model_type(ModelConfig(**kw))
    jparams = jax_init_float(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_flat(jck.params_to_flat(jparams), tcfg, device="cpu")
    calib = np.random.default_rng(1).integers(0, kw["vocab_size"], CALIB).astype(np.int32)
    x = jparams.embed[jnp.asarray(calib)].astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(CALIB[1])[None], CALIB)
    jfn, tfn = ((jawq.awq_quantize_mla_block, tawq.awq_quantize_mla_block) if tcfg.is_mla
                else (jawq.awq_quantize_block, tawq.awq_quantize_block))
    gaps = []
    orig_moe = tawq.moe_forward

    def moe_forward(p, cfg, h, token_mask=None):
        gaps.append(least_route_gap(p, cfg, h, token_mask))
        return orig_moe(p, cfg, h, token_mask)

    monkeypatch.setattr(tawq, "moe_forward", moe_forward)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            ref = jfn(jparams.blocks[0], jcfg, x, pos, jparams.rope_cos, jparams.rope_sin,
                      JaxQuantConfig(q_group_size=G), skip=frozenset(skip))
        out = tfn(tparams.blocks[0], tcfg, to_torch(x), torch.from_numpy(np.array(pos)),
                  tparams.rope_cos, tparams.rope_sin, QuantConfig(q_group_size=G),
                  skip=frozenset(skip))
    assert [r[0] for r in prec] == _expected_kinds(name, tcfg)
    check_searches(jrec, prec)
    if tcfg.layer_is_moe(0):
        assert len(gaps) == 1 + 20 + 1 and min(gaps) > GAP, gaps
    assert_close(out.x_next, ref.x_next, X_TOL[name], "x_next")
    assert_params_equal(out.block, ref.block)
    mlp = out.block.mlp
    if tcfg.layer_is_moe(0):
        for nm, lin in (("gate_up", mlp.gate_up_proj), ("down", mlp.down_proj),
                        ("gate_up", mlp.shared_gate_up), ("down", mlp.shared_down)):
            if lin is not None:  # mixtral has no shared expert
                assert isinstance(lin, Linear if nm in skip else QuantLinear), nm
        assert isinstance(mlp.router, Linear)
        assert (mlp.shared_gate is not None) == tcfg.shared_expert_gate
    if tcfg.is_mla:
        a = out.block.attn
        assert isinstance(a, MLAParams) and isinstance(a.kv_b_proj, Linear)
        assert all(isinstance(lin, QuantLinear) for lin in (a.q_proj, a.kv_a_proj, a.o_proj))
        assert (a.q_b_proj is None) == (tcfg.q_lora_rank is None)
