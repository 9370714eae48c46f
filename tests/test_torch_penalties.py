"""Port parity for history penalties (ROADMAP A6): ``apply_penalties``
value for value against the JAX package's, and penalised greedy
generate() token for token against ``quick_tpu.runtime.generate`` on a tiny
llama, for each of the three penalties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.utils.checkpoint as jck
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.runtime import generate as jax_generate
from quick_tpu.runtime.generate import SamplingParams as JaxSamplingParams
from quick_tpu.runtime.generate import apply_penalties as jax_apply
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant
from quick_tpu_torch.runtime import SamplingParams, generate
from quick_tpu_torch.runtime.generate import apply_penalties

TINY = dict(vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
#: strong enough to move this model's greedy stream: its top logit leads
#: the next by ~2
PENALTIES = [dict(repetition_penalty=5.0), dict(frequency_penalty=0.7),
             dict(presence_penalty=2.5)]


@pytest.mark.parametrize("rep,freq,pres", [(1.3, 0.0, 0.0), (1.0, 0.7, 0.0), (1.0, 0.0, 0.9),
                                           (0.8, 0.25, 0.5)])
def test_apply_penalties_value_exact(rng, rep, freq, pres):
    """Scalar coefficients and per-row ones ([B]), logits of both signs,
    counts and prompt marks in every combination: equal bit for bit."""
    B, V = 3, 50
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    seen = rng.random((B, V)) < 0.3
    for coef in ((rep, freq, pres), tuple(np.full(B, c, np.float32) * [1.0, 0.5, 2.0]
                                          for c in (rep, freq, pres))):
        ref = jax_apply(jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(seen), *coef)
        out = apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts),
                              torch.from_numpy(seen),
                              *[c if np.isscalar(c) else torch.from_numpy(c) for c in coef])
        np.testing.assert_array_equal(f32(out), f32(ref))


@pytest.fixture(scope="module")
def pair():
    """A tiny llama with random QTPU weights (seed 0), built by the port and
    carried over to quick_tpu by name."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    tparams = t_init_quant(tcfg, seed=0, device="cpu")
    flat = {k: v.view(torch.int16).numpy().view(jnp.bfloat16) if v.dtype == torch.bfloat16
            else v.numpy() for k, v in params_to_flat(tparams).items()}
    return jcfg, jck.flat_to_params(flat, jcfg), tcfg, tparams


@pytest.mark.parametrize("kw", PENALTIES, ids=["repetition", "frequency", "presence"])
def test_penalised_greedy_generate_matches_jax(pair, kw):
    """Greedy generate() of 12 tokens after 8-token prompts, with one
    penalty: the same tokens as quick_tpu's (its decode_loop carries the
    counts through the scan), and other tokens than without the penalty."""
    jcfg, jparams, tcfg, tparams = pair
    prompt = np.random.default_rng(1).integers(0, TINY["vocab_size"], (2, 8)).astype(np.int32)
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompt), 12,
                                  sampling=JaxSamplingParams(**kw)))
    out = generate(tparams, tcfg, torch.from_numpy(prompt).long(), 12,
                   sampling=SamplingParams(**kw)).numpy()
    np.testing.assert_array_equal(out, ref)
    plain = generate(tparams, tcfg, torch.from_numpy(prompt).long(), 12).numpy()
    assert not np.array_equal(out, plain)
