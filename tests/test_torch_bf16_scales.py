"""Port parity under ``QUICK_TPU_BF16_SCALES=1``: the JAX package casts
every QuantLinear's scales and zeros_x_scales to bf16 at its two choke
points (``AutoQuickModel.__init__`` and ``init_quant_params``); the port
rounds them through bf16 at the same two places and keeps them in f32
tensors. A tiny quantized llama, random-init and loaded from a checkpoint
the test writes, must give quick_tpu's logits under the switch.

The switch moves the logits by one bf16 rounding of the scales (~4e-3 on
this model), far inside the model tolerance (3e-2, as
tests/test_torch_model.py). So each logits test also holds the port's
switched logits within a quarter of that move of quick_tpu's: a port that
ignores the switch sits a whole move away."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.utils.checkpoint as jck
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.models.auto import AutoQuickModel as JaxAuto
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import init_quant_params, model_forward
from quick_tpu_torch.modules.linear import QuantLinear
from quick_tpu_torch.runtime import make_cache

TINY = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=64,
)
TOL = dict(atol=3e-2, rtol=3e-2)  # as tests/test_torch_model.py
SWITCH = "QUICK_TPU_BF16_SCALES"


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _tokens(B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


def _jax_logits(params, cfg, toks):
    logits, _ = jax_forward(params, cfg, jnp.asarray(toks), jax_cache(cfg, toks.shape[0], 32))
    return np.asarray(logits, np.float32)


def _port_logits(params, cfg, toks):
    logits, _ = model_forward(params, cfg, torch.from_numpy(toks).long(),
                              make_cache(cfg, toks.shape[0], 32, device="cpu"))
    return f32(logits)


def _quant_linears(tree):
    out = []

    def walk(v):
        if isinstance(v, QuantLinear):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for w in v:
                walk(w)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))

    walk(tree)
    return out


def _assert_switched_logits(port, jax_on, jax_off):
    """Within the model tolerance of quick_tpu's switched logits, and
    within a quarter of the switch's own move of them."""
    np.testing.assert_allclose(port, jax_on, **TOL)
    move = float(np.abs(jax_on - jax_off).max())
    gap = float(np.abs(port - jax_on).max())
    assert move > 0, "the switch did not move quick_tpu's logits"
    assert gap <= move / 4, f"port {gap:.3e} from quick_tpu under the switch; the switch moves {move:.3e}"


@pytest.fixture(scope="module")
def tiny():
    """The port's random quantized llama (seed 0), carried to quick_tpu by
    name, both unswitched."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    tparams = init_quant_params(tcfg, seed=0, device="cpu")
    flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
    return jcfg, jck.flat_to_params(flat, jcfg), tcfg, tparams


def test_init_quant_params_rounds_scales_under_switch(monkeypatch):
    """init_quant_params under the switch: every QuantLinear's scales and
    zeros_x_scales are the unswitched ones rounded through bf16, still f32;
    codes untouched."""
    cfg = ModelConfig(**TINY)
    off = init_quant_params(cfg, seed=0, device="cpu")
    monkeypatch.setenv(SWITCH, "1")
    on = init_quant_params(cfg, seed=0, device="cpu")
    pairs = list(zip(_quant_linears(off), _quant_linears(on)))
    assert len(pairs) == 2 * TINY["num_hidden_layers"] * 2
    for a, b in pairs:
        assert b.scales.dtype == b.zeros_x_scales.dtype == torch.float32
        assert torch.equal(b.qweight, a.qweight)
        for x, y in ((a.scales, b.scales), (a.zeros_x_scales, b.zeros_x_scales)):
            assert torch.equal(y, x.to(torch.bfloat16).to(torch.float32))
            assert not torch.equal(y, x)


def test_random_model_logits_match_jax_under_switch(tiny, monkeypatch):
    """AutoQuickModel around the random model in both packages under the
    switch (the JAX package's choke point for every load path)."""
    jcfg, jparams, tcfg, tparams = tiny
    toks = _tokens()
    jax_off = _jax_logits(jparams, jcfg, toks)
    monkeypatch.setenv(SWITCH, "1")
    jm = JaxAuto(jparams, jcfg)
    tm = AutoQuickModel(tparams, tcfg)
    tq, jq = tm.params.blocks[0].attn.qkv_proj, jm.params.blocks[0].attn.qkv_proj
    np.testing.assert_array_equal(f32(tq.scales), np.asarray(jq.scales, np.float32))
    _assert_switched_logits(_port_logits(tm.params, tcfg, toks),
                            _jax_logits(jm.params, jcfg, toks), jax_off)


def test_checkpoint_logits_match_jax_under_switch(tiny, monkeypatch, tmp_path):
    """A checkpoint quick_tpu writes, loaded by both packages'
    from_quantized under the switch: equal scales (the port's in f32, the
    JAX package's in bf16) and logits."""
    jcfg, jparams, tcfg, _ = tiny
    jck.save_quantized(jparams, jcfg, JaxQuantConfig(), str(tmp_path))
    toks = _tokens(seed=2)
    jax_off = _jax_logits(JaxAuto.from_quantized(str(tmp_path)).params, jcfg, toks)
    monkeypatch.setenv(SWITCH, "1")
    jm = JaxAuto.from_quantized(str(tmp_path))
    tm = AutoQuickModel.from_quantized(str(tmp_path), device="cpu")
    jb, tb = jm.params.blocks[1].mlp.down_proj, tm.params.blocks[1].mlp.down_proj
    assert jb.scales.dtype == jnp.bfloat16 and tb.scales.dtype == torch.float32
    np.testing.assert_array_equal(f32(tb.scales), np.asarray(jb.scales, np.float32))
    np.testing.assert_array_equal(f32(tb.zeros_x_scales), np.asarray(jb.zeros_x_scales, np.float32))
    _assert_switched_logits(_port_logits(tm.params, tm.cfg, toks),
                            _jax_logits(jm.params, jm.cfg, toks), jax_off)
