"""Port parity for W4A8 models on the CPU: a tiny llama with
``QUICK_TPU_A8=1`` (prefill logits and greedy generate()), a tiny Mixtral
with ``QUICK_TPU_A8=1 QUICK_TPU_MOE_A8=1``, and the Engine with A8 whose
prefill sub-batches are 128 rows, each against ``quick_tpu`` with the same
switches. The JAX package reads the switches when it traces, so its jit
caches are cleared whenever they change.

Where the JAX package quantizes the activations inside ``jit``, XLA divides
by the row scale as a multiply by its reciprocal: a code may land one step
away from the port's true division (ROADMAP §C). The logits are held to the
model tests' 3e-2, and greedy rows may part only at a bf16 tie of the
reference's logits (``assert_greedy_match``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_greedy_match, f32, least_route_gap

import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.modules.blocks as tblocks
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.runtime import generate as jax_generate
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant, model_forward
from quick_tpu_torch.ops import grouped_matmul as tgm
from quick_tpu_torch.runtime import Engine, generate

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
MODELS = {
    "llama": TINY,
    "mixtral": dict(TINY, num_local_experts=4, num_experts_per_tok=2, model_type="mixtral"),
}
#: logits, as tests/test_torch_model.py
TOL = dict(atol=3e-2, rtol=3e-2)
#: least gap between the k-th and (k+1)-th router logit of a routed token
GAP = 1e-4


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def models():
    """Each tiny model with random QTPU weights (seed 0), built by the port
    and carried over to quick_tpu by name."""
    out = {}
    for name, kw in MODELS.items():
        jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
        tparams = t_init_quant(tcfg, seed=0, device="cpu")
        flat = {k: _numpy(v) for k, v in params_to_flat(tparams).items()}
        out[name] = (jcfg, jck.flat_to_params(flat, jcfg), tcfg, tparams)
    return out


@pytest.fixture
def a8(monkeypatch):
    """QUICK_TPU_A8=1 and QUICK_TPU_MOE_A8=1 for both packages."""
    jax.clear_caches()
    monkeypatch.setenv("QUICK_TPU_A8", "1")
    monkeypatch.setenv("QUICK_TPU_MOE_A8", "1")
    yield
    monkeypatch.delenv("QUICK_TPU_A8")
    monkeypatch.delenv("QUICK_TPU_MOE_A8")
    jax.clear_caches()


@pytest.fixture
def routes(monkeypatch):
    """Counts the port's grouped GEMM calls by ``a8`` and records the least
    router gap of every MoE call's routed tokens."""
    seen = {"a8": 0, "a16": 0, "gaps": []}
    grouped, moe = tgm.quantized_matmul_grouped, tblocks.moe_forward

    def counted(*a, **kw):
        seen["a8" if kw.get("a8") else "a16"] += 1
        return grouped(*a, **kw)

    def gapped(p, cfg, x, token_mask=None):
        seen["gaps"].append(least_route_gap(p, cfg, x, token_mask))
        return moe(p, cfg, x, token_mask)

    monkeypatch.setattr(tgm, "quantized_matmul_grouped", counted)
    monkeypatch.setattr(tblocks, "moe_forward", gapped)
    return seen


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
def test_a8_model_logits_and_greedy_tokens_match_jax(models, a8, routes, name):
    """B = 2, S = 64: the prefill's 128 rows take W4A8 in both packages (and
    MOE_A8's grouped int8 GEMMs for Mixtral); logits within 3e-2; greedy
    generate() of 8 tokens equal but for bf16 ties."""
    jcfg, jparams, tcfg, tparams = models[name]
    toks = _tokens(2, 64)
    tl, _ = model_forward(tparams, tcfg, torch.from_numpy(toks).long())
    jl = jax_forward(jparams, jcfg, jnp.asarray(toks))[0]
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    ref = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(toks), 8, max_seq=80))
    out = generate(tparams, tcfg, torch.from_numpy(toks), 8, max_seq=80)
    ref_logits = jax_forward(jparams, jcfg, jnp.asarray(ref[:, :-1]))[0]
    assert assert_greedy_match(out.numpy(), ref, ref_logits, 64) >= 12
    if tcfg.is_moe:
        assert routes["a8"] > 0 and routes["a16"] == 0
        assert min(routes["gaps"]) > GAP, routes["gaps"]


def test_a8_changes_the_prefill_but_not_decode(models, monkeypatch):
    """The switch is read at each call: with A8 the 128-row prefill's
    logits move by the activations' int8 rounding; a [2, 1] decode forward
    gives the W4A16 logits exactly."""
    _, _, tcfg, tparams = models["llama"]
    toks = torch.from_numpy(_tokens(2, 64)).long()
    monkeypatch.delenv("QUICK_TPU_A8", raising=False)
    a16, _ = model_forward(tparams, tcfg, toks)
    d16, _ = model_forward(tparams, tcfg, toks[:, :1])
    monkeypatch.setenv("QUICK_TPU_A8", "1")
    a8, _ = model_forward(tparams, tcfg, toks)
    d8, _ = model_forward(tparams, tcfg, toks[:, :1])
    assert not torch.equal(a8, a16)
    np.testing.assert_allclose(f32(a8), f32(a16), **TOL)
    assert torch.equal(d8, d16)


@pytest.mark.parametrize("name", list(MODELS))
def test_a8_engine_streams_match_jax(models, a8, routes, name):
    """The Engine with 4 slots and 32-token chunks: its [4, 32] prefill
    sub-batches are 128 rows, so they take W4A8; its [4, 1] decode windows
    stay W4A16. Greedy streams token-equal to the JAX Engine's with the same
    switches, and the same schedule."""
    jcfg, jparams, tcfg, tparams = models[name]
    rng = np.random.default_rng(2)
    reqs = [([int(t) for t in rng.integers(0, 512, int(rng.integers(20, 60)))],
             int(rng.integers(4, 10))) for _ in range(5)]
    geometry = dict(max_slots=4, max_seq=128, page_size=16, chunk=32, prefill_rows=4,
                    decode_window=4)
    outs = []
    for cls, params, cfg, extra in ((JaxEngine, jparams, jcfg, {}),
                                    (Engine, tparams, tcfg, dict(device="cpu"))):
        eng = cls(params, cfg, **geometry, **extra)
        uids = [eng.submit(p, n) for p, n in reqs]
        done = eng.run()
        outs.append(([done[u] for u in uids], eng.stats))
    (jout, jstats), (tout, tstats) = outs
    assert tout == jout
    assert [len(o) for o in tout] == [n for _, n in reqs]
    for key, value in jstats.items():
        assert tstats[key] == value, key
    assert tstats["prefill_substeps"] > 0
    if tcfg.is_moe:
        assert routes["a8"] > 0 and min(routes["gaps"]) > GAP, routes["gaps"]
