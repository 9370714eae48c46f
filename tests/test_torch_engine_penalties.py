"""Port parity for the Engine's history penalties and ``logit_bias``
(``Engine(enable_penalties=True)``): the port's Engine on the CPU against
the JAX Engine on the CPU, on one tiny quantized llama carried across with
params_from_flat (its forward gives the JAX model's logits bit for bit, as
in test_torch_serving.py) and one trace of eight requests: half carry
repetition 1.2, frequency 0.5 and presence 0.5, a quarter a ``logit_bias``
of +5 on one token. Greedy streams token-exact and the schedule the same
over bf16 pages, INT8 pages and ``reserve="optimistic"`` with preemptions
(the penalty state rebuilt at re-admission); on a tiny Mixtral over bf16
pages and a tiny DeepSeek-V2 over INT8 latent pages the same, except that a
stream may part from the JAX one where its two best post-penalty candidates
lie within one bf16 step of each other in both engines (the JAX paged INT8
program rounds a logit a step away from the port's, and the repetition
penalty can bring two candidates that close); delivered logprobs (post-
penalty) within one bf16 step; a bias that outweighs every logit forces its
token; and the submit errors without ``enable_penalties``."""
import jax
import numpy as np
import pytest
import torch

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params
from quick_tpu.runtime.generate import SamplingParams as JaxSamplingParams
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu.utils.checkpoint import flat_to_params, params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.convert import params_to_flat as t_params_to_flat
from quick_tpu_torch.models.model import init_quant_params as t_init_quant
from quick_tpu_torch.runtime import Engine, SamplingParams

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
GEOMETRY = dict(max_slots=4, max_seq=64, page_size=16, chunk=8, enable_penalties=True)
PEN = dict(repetition_penalty=1.2, frequency_penalty=0.5, presence_penalty=0.5)
#: each case: the engine options of the run compared with the JAX engine
CASES = {
    "bf16_window_4": dict(decode_window=4),
    "int8_pages": dict(decode_window=4, dtype="int8"),
    # 7 usable pages: full reservation would need 2-3 per request
    "optimistic_preemption": dict(decode_window=2, prefill_rows=2, reserve="optimistic",
                                  n_pages=8),
    "step_at_a_time": dict(decode_window=1),
}


#: the MoE and MLA models (config, group, page dtype), as in
#: test_torch_moe.py and test_torch_deepseek.py
OTHER_MODELS = {
    "mixtral_bf16": (dict(TINY, num_local_experts=4, num_experts_per_tok=2,
                          model_type="mixtral"), 128, None),
    "deepseek_v2_int8": (dict(TINY, vocab_size=256, num_hidden_layers=3, num_key_value_heads=4,
                              kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32, head_dim=48, rotary_dim=16, intermediate_size=192,
                              num_local_experts=8, num_experts_per_tok=2,
                              moe_router="deepseek", moe_intermediate_size=64,
                              first_k_dense_replace=1, rms_norm_eps=1e-6,
                              model_type="deepseek_v2", n_shared_experts=2,
                              norm_topk_prob=False), 64, "int8"),
}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_flat(params_to_flat(jparams), tcfg, device="cpu")


def _trace(seed: int = 0, vocab: int = 512):
    """Eight requests of 4-19 prompt tokens and 8-19 new tokens: requests
    0, 2, 4, 6 penalised, 1 and 5 with a +5 bias on a token of their prompt."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        prompt = [int(t) for t in rng.integers(0, vocab, int(rng.integers(4, 20)))]
        bias = {prompt[-1]: 5.0} if i % 4 == 1 else None
        out.append((prompt, int(rng.integers(8, 20)), i % 2 == 0, bias))
    return out


def _serve(engine_cls, params, cfg, samp_cls, trace, top=False, **kw):
    """(engine, streams, logprobs, or with ``top`` each token's two best
    (id, logprob) candidates)."""
    eng = engine_cls(params, cfg, **GEOMETRY, logprobs_topk=2 if top else 0, **kw)
    uids = [eng.submit(p, n, sampling=samp_cls(**PEN) if pen else None, logit_bias=bias)
            for p, n, pen, bias in trace]
    outs = eng.run()
    lps = [eng.requests[u].top_logprobs if top else eng.requests[u].logprobs for u in uids]
    return eng, [outs[u] for u in uids], lps


@pytest.mark.parametrize("case", list(CASES))
def test_penalised_engine_streams_match_jax(models, case):
    jcfg, jparams, tcfg, tparams = models
    trace = _trace()
    kw = dict(CASES[case])
    int8 = kw.pop("dtype", None) == "int8"
    jkw = dict(kw, dtype=jax.numpy.int8) if int8 else kw
    tkw = dict(kw, dtype=torch.int8) if int8 else kw
    jeng, jout, jlp = _serve(JaxEngine, jparams, jcfg, JaxSamplingParams, trace, **jkw)
    teng, tout, tlp = _serve(Engine, tparams, tcfg, SamplingParams, trace, device="cpu", **tkw)
    assert tout == jout
    assert [len(o) for o in tout] == [n for _, n, _, _ in trace]
    for key, value in jeng.stats.items():
        assert teng.stats[key] == value, key
    # post-penalty logprobs: one bf16 step of a logit at most, rarely
    for a, b in zip(tlp, jlp):
        np.testing.assert_allclose(a, b, atol=2 ** -5)
    diff = np.abs(np.concatenate(tlp) - np.concatenate(jlp))
    assert (diff > 1e-4).mean() < 0.05, diff
    if kw.get("reserve") == "optimistic":
        assert teng.stats["preemptions"] > 0
    # the penalties moved the streams: the same trace unpenalised differs
    plain = Engine(tparams, tcfg, device="cpu", **{**GEOMETRY, **tkw, "enable_penalties": False})
    uids = [plain.submit(p, n) for p, n, _, _ in trace]
    outs = plain.run()
    assert [outs[u] for u in uids] != tout


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jax.numpy.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("name", list(OTHER_MODELS))
def test_penalised_moe_and_mla_engines_match_jax(name):
    """The penalised Engine on a tiny Mixtral (bf16 pages) and a tiny
    DeepSeek-V2 (INT8 latent pages), random QTPU weights built by the port
    and carried over to quick_tpu: streams token-exact, the same schedule."""
    kw, G, dtype = OTHER_MODELS[name]
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    tparams = t_init_quant(tcfg, seed=0, group_size=G, device="cpu")
    jparams = flat_to_params({k: _numpy(v) for k, v in t_params_to_flat(tparams).items()}, jcfg,
                             group_size=G)
    trace = _trace(1, kw["vocab_size"])
    jkw = dict(decode_window=4, **({"dtype": jax.numpy.int8} if dtype else {}))
    tkw = dict(decode_window=4, **({"dtype": torch.int8} if dtype else {}))
    jeng, jout, jtop = _serve(JaxEngine, jparams, jcfg, JaxSamplingParams, trace, True, **jkw)
    teng, tout, ttop = _serve(Engine, tparams, tcfg, SamplingParams, trace, True, device="cpu",
                              **tkw)
    assert [len(o) for o in tout] == [n for _, n, _, _ in trace]
    for key, value in jeng.stats.items():
        assert teng.stats[key] == value, key
    parted = 0
    for t, j, tt, jt in zip(tout, jout, ttop, jtop):
        if t == j:
            continue
        k = next(i for i, (a, b) in enumerate(zip(t, j)) if a != b)
        for own, other, top2 in ((t[k], j[k], tt[k]), (j[k], t[k], jt[k])):
            (first, lp1), (second, lp2) = top2
            assert (first, second) == (own, other) and lp1 - lp2 <= 2 ** -5, (k, top2)
        parted += 1
    assert parted <= 1, parted


def test_logit_bias_forces_its_token(models):
    """A bias that outweighs every logit makes its token every sample of
    that request only, in both engines; a negative one bans its token."""
    jcfg, jparams, tcfg, tparams = models
    trace = [([3, 4, 5], 6, False, {7: 1e4}), ([3, 4, 5], 6, False, None)]
    _, jout, _ = _serve(JaxEngine, jparams, jcfg, JaxSamplingParams, trace, decode_window=2)
    _, tout, tlp = _serve(Engine, tparams, tcfg, SamplingParams, trace, device="cpu",
                          decode_window=2)
    assert tout == jout and tout[0] == [7] * 6 and tout[1] != tout[0]
    np.testing.assert_allclose(tlp[0], 0.0, atol=1e-6)  # the whole mass on token 7
    ban = tout[1][0]
    _, bout, _ = _serve(Engine, tparams, tcfg, SamplingParams,
                        [([3, 4, 5], 6, False, {ban: -1e4})], device="cpu", decode_window=2)
    assert ban not in bout[0]


@pytest.mark.parametrize("what", ["sampling", "logit_bias", "engine_sampling"])
def test_submit_errors_without_enable_penalties(models, what):
    """Without enable_penalties the JAX Engine's ValueError, in both."""
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, "enable_penalties": False}
    for engine_cls, params, cfg, samp_cls, dev in (
            (Engine, tparams, tcfg, SamplingParams, dict(device="cpu")),
            (JaxEngine, jparams, jcfg, JaxSamplingParams, {})):
        with pytest.raises(ValueError, match="enable_penalties"):
            if what == "engine_sampling":
                engine_cls(params, cfg, sampling=samp_cls(**PEN), **geo, **dev)
            eng = engine_cls(params, cfg, **geo, **dev)
            if what == "sampling":
                eng.submit([1, 2], 3, sampling=samp_cls(**PEN))
            else:
                eng.submit([1, 2], 3, logit_bias={5: 1.0})
