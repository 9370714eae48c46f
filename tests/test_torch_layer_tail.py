"""Port parity for the decode layer tail (``QUICK_TPU_LAYER_TAIL=1``): K14's
plain version against the JAX package's Pallas kernel in interpret mode; a
tiny llama's decode forward under the switch, over the dense and the paged
cache, against ``quick_tpu`` under the same switch; and the gate's
refusals.

Under the switch the JAX package rounds as its tail kernel does (the norm
weight through bf16, its own order of the f32 group sums), which is not the
unfused chain's rounding. The model-level tests measure that gap between
the JAX package's two paths and hold the port's tail to a quarter of it:
a port that ignored the switch would sit a whole gap away."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.utils.checkpoint as jck
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JPaged
from quick_tpu.ops.fused_layer_tail import fused_layer_tail as jax_tail
from quick_tpu.quantize.packing import pack_qtpu
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant, model_forward
from quick_tpu_torch.modules import blocks as tblocks
from quick_tpu_torch.modules.linear import QuantLinear
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.fused_layer_tail import fused_layer_tail
from quick_tpu_torch.runtime import make_cache

G = 128
TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            model_type="mistral")
B, PROMPT, MAX_SEQ = 2, 6, 32
TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # 8-token pages


def _mk(rng, K, N, s=0.02):
    q = rng.integers(0, 16, (K, N), dtype=np.uint8)
    return (pack_qtpu(q, G), rng.random((K // G, N), dtype=np.float32) * s,
            rng.random((K // G, N), dtype=np.float32) * s * 0.5)


@pytest.mark.parametrize("M", [1, 3, 8])
def test_plain_matches_pallas_interpret(M):
    """``fused_layer_tail_plain`` against the Pallas kernel in interpret
    mode on tests/test_layer_tail.py's shapes and inputs. Tolerance: one
    bf16 step of max|ref| (2^-7 of it); both sum each group's products in
    f32 and the groups in the Pallas kernel's K steps."""
    rng = np.random.default_rng(0)
    K1, D, I = 512, 384, 768
    ws = [_mk(rng, K1, D), _mk(rng, D, 2 * I), _mk(rng, I, D)]
    nw = (rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    ao = jnp.asarray(rng.standard_normal((M, K1)) * 0.1, jnp.bfloat16)
    xr = jnp.asarray(rng.standard_normal((M, D)) * 0.1, jnp.bfloat16)
    ref = jax_tail(ao, xr, jnp.asarray(nw), *[jnp.asarray(a) for w in ws for a in w],
                   interpret=True)
    out = fused_layer_tail(
        torch.from_numpy(f32(ao)).to(torch.bfloat16), torch.from_numpy(f32(xr)).to(torch.bfloat16),
        torch.from_numpy(nw), *[torch.from_numpy(np.asarray(a)) for w in ws for a in w])
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, D)
    r = f32(ref)
    assert np.abs(f32(out) - r).max() <= 2.0 ** -7 * np.abs(r).max()


@pytest.fixture(scope="module")
def pair():
    """A tiny llama with random QTPU weights (seed 0), built by the port and
    carried over to quick_tpu by name. The block linears' scales are 64x
    the initializer's, so that the MLP moves the residual stream by more
    than its bf16 rounding, and the MLP norm weights random f32 values, so
    that rounding them to bf16 moves them."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    flat = {k: v.view(torch.int16).numpy().view(jnp.bfloat16) if v.dtype == torch.bfloat16
            else v.numpy()
            for k, v in params_to_flat(t_init_quant(tcfg, seed=0, device="cpu")).items()}
    for k in flat:
        if k.startswith("blocks.") and k.endswith(("scales", "zeros_x_scales")):
            flat[k] = flat[k] * 64
    rng = np.random.default_rng(3)
    for i in range(TINY["num_hidden_layers"]):
        flat[f"blocks.{i}.mlp_norm"] = (1.0 + 0.1 * rng.standard_normal(TINY["hidden_size"])
                                       ).astype(np.float32)
    return jcfg, jck.flat_to_params(flat, jcfg), tcfg, params_from_flat(flat, tcfg, device="cpu")


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


def _jax_decode(jcfg, jparams, monkeypatch, tail: bool, paged: bool):
    """quick_tpu's logits of one decode step after a prefill, with the
    switch as given, run eagerly (``jax.disable_jit``: the switch is read
    at every call). The jitted forward rounds as XLA-CPU fuses it, which
    moves with the host; the port equals the eager forward."""
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "1" if tail else "0")
    with jax.disable_jit():
        if paged:
            jc = JPaged.create(TINY["num_hidden_layers"], 9, 8, max_slots=B, max_seq=MAX_SEQ,
                               n_kv=TINY["num_key_value_heads"], head_dim=64,
                               dtype=jnp.bfloat16)
            jc = dataclasses.replace(jc, block_table=jnp.asarray(TABLE))
        else:
            jc = jax_cache(jcfg, B, MAX_SEQ)
        _, jc = jax_forward(jparams, jcfg, jnp.asarray(_tokens(PROMPT, 1)), jc)
        jl, _ = jax_forward(jparams, jcfg, jnp.asarray(_tokens(1, 2)), jc)
    return f32(jl)


def _port_decode(tcfg, tparams, monkeypatch, tail: bool, paged: bool):
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "1" if tail else "0")
    if paged:
        tc = PagedKVCache.create(TINY["num_hidden_layers"], 9, 8, B, MAX_SEQ,
                                 TINY["num_key_value_heads"], 64, torch.bfloat16, device="cpu")
        tc.block_table.copy_(torch.from_numpy(TABLE))
    else:
        tc = make_cache(tcfg, B, MAX_SEQ, device="cpu")
    _, tc = model_forward(tparams, tcfg, torch.from_numpy(_tokens(PROMPT, 1)).long(), tc)
    tl, _ = model_forward(tparams, tcfg, torch.from_numpy(_tokens(1, 2)).long(), tc)
    return f32(tl)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_decode_under_switch_matches_jax(pair, monkeypatch, paged):
    """The decode step ([2, 1]: the tail's rows) of a 2-layer llama under
    the switch: the port within a quarter of the gap that the JAX package's
    tail and its unfused chain leave between them, and the port's own two
    paths that gap apart too (the switch is read)."""
    jcfg, jparams, tcfg, tparams = pair
    jt = _jax_decode(jcfg, jparams, monkeypatch, True, paged)
    ju = _jax_decode(jcfg, jparams, monkeypatch, False, paged)
    gap = np.abs(jt - ju).max()
    assert gap > 0, "the two JAX paths agree: the test cannot tell the roundings apart"
    tt = _port_decode(tcfg, tparams, monkeypatch, True, paged)
    tu = _port_decode(tcfg, tparams, monkeypatch, False, paged)
    assert np.abs(tt - jt).max() <= 0.25 * gap, (np.abs(tt - jt).max(), gap)
    assert np.abs(tu - ju).max() <= 0.25 * gap, (np.abs(tu - ju).max(), gap)
    assert np.abs(tt - tu).max() > 0.5 * gap


def _gate_case(name):
    cfg = ModelConfig(**TINY)
    p = t_init_quant(cfg, seed=0, device="cpu").blocks[0]
    x = torch.zeros((2, 1, TINY["hidden_size"]), dtype=torch.bfloat16)
    if name == "moe":
        cfg = ModelConfig(**dict(TINY, num_local_experts=4, num_experts_per_tok=2,
                                 model_type="mixtral"))
        p = t_init_quant(cfg, seed=0, device="cpu").blocks[0]
    elif name == "g64":
        p = t_init_quant(cfg, seed=0, group_size=64, device="cpu").blocks[0]
    elif name == "bias":
        o = p.attn.o_proj
        p.attn.o_proj = QuantLinear(o.qweight, o.scales, o.zeros_x_scales,
                                    torch.zeros(o.out_features), o.group_size)
    elif name == "rows":
        x = torch.zeros((3, 3, TINY["hidden_size"]), dtype=torch.bfloat16)
    return p, cfg, x


@pytest.mark.parametrize("name", ["moe", "g64", "bias", "rows"])
def test_gate_refuses(monkeypatch, name):
    """``_use_layer_tail`` refuses an MoE layer, G = 64, a biased linear and
    more than 8 rows, and takes the plain llama decode block."""
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "1")
    assert not tblocks._use_layer_tail(*_gate_case(name))
    p, cfg, _ = _gate_case("none")
    x = torch.zeros((2, 4, TINY["hidden_size"]), dtype=torch.bfloat16)
    assert tblocks._use_layer_tail(p, cfg, x)
    monkeypatch.setenv("QUICK_TPU_LAYER_TAIL", "0")
    assert not tblocks._use_layer_tail(p, cfg, x)
