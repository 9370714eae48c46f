"""Port parity under ``QUICK_TPU_MOE_GROUPED=0``: the JAX package sends
quantized experts off the grouped kernel, to its per-expert loop at
B*S <= 32 tokens and to the einsum over every expert above
(quick_tpu/modules/blocks.py:669-708). The port must take the same
branches and give quick_tpu's outputs there, for tiny Mixtral and
qwen2_moe models, each routed token's expert choice held apart from a
tie by ``least_route_gap`` (see tests/test_torch_moe.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32, least_route_gap
from test_torch_moe import BASE, GAP, MODELS, TOL, TOL_BF16, _bf16, _tokens, quant_models  # noqa: F401

import quick_tpu_torch.modules.blocks as tblocks
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.modules.blocks import moe_forward as jax_moe_forward
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.runtime import make_cache

SWITCH = "QUICK_TPU_MOE_GROUPED"


@pytest.fixture
def ungrouped(monkeypatch):
    """The switch set, JAX's traces cleared around the test (it reads the
    switch while tracing), and the port's grouped calls counted."""
    calls = []
    orig = tblocks._grouped_moe

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tblocks, "_grouped_moe", counted)
    monkeypatch.setenv(SWITCH, "0")
    jax.clear_caches()
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("B,S", [(2, 8), (2, 24)], ids=["loop_16_tokens", "einsum_48_tokens"])
def test_moe_forward_under_switch_matches_jax(quant_models, ungrouped, name, B, S):
    """One MoE layer of quantized experts: per expert at 16 tokens, the
    einsum at 48; the grouped kernel is never called."""
    jcfg, jparams, tcfg, tparams = quant_models[name]
    jp, tp = jparams.blocks[0].mlp, tparams.blocks[0].mlp
    x = np.random.default_rng(8).standard_normal((B, S, BASE["hidden_size"])).astype(np.float32)
    xj, xt = _bf16(x)
    assert least_route_gap(tp, tcfg, xt) > GAP
    want = jax_moe_forward(jp, jcfg, xj)
    got = tblocks.moe_forward(tp, tcfg, xt)
    assert not ungrouped, "the grouped kernel ran under QUICK_TPU_MOE_GROUPED=0"
    np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logits_under_switch_match_jax(quant_models, ungrouped, monkeypatch, name):
    """A 36-token prefill (72 tokens: the einsum) and two decode steps at
    B=2 (the per-expert loop) of the whole tiny model."""
    jcfg, jparams, tcfg, tparams = quant_models[name]
    B, S, steps = 2, 36, 2
    toks = _tokens(B, S + steps, seed=5)
    jc, tc = jax_cache(jcfg, B, 48), make_cache(tcfg, B, 48, device="cpu")
    gaps = []
    orig = tblocks.moe_forward

    def routed(p, cfg, x, token_mask=None):
        gaps.append(least_route_gap(p, cfg, x, token_mask))
        return orig(p, cfg, x, token_mask)

    monkeypatch.setattr(tblocks, "moe_forward", routed)
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + steps)]:
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert len(gaps) == 2 * (1 + steps) and min(gaps) > GAP, gaps
    assert not ungrouped, "the grouped kernel ran under QUICK_TPU_MOE_GROUPED=0"
