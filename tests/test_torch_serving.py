"""Port parity for serving: the port's continuous-batching Engine on the CPU
against the JAX Engine on the CPU, on one request trace (six requests that
share a one-page prefix) and one tiny quantized llama whose weights are
carried across with params_from_flat. Greedy streams must be token-equal
and the schedule the same (every ``stats`` key the JAX engine keeps).

The model is a quantized one (hidden 128, g=128), as in test_torch_model.py:
its dense forward gives the JAX model's logits bit for bit at this size, so
greedy ties between the top two tokens do not flip; a bf16 float model's
logits differ in the last bit now and then, and at 512 candidates a one-step
tie is common enough to flip a stream."""
import jax
import numpy as np
import pytest
import torch

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params
from quick_tpu.runtime.generate import sample_token_rows as jax_rows
from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.runtime import Engine, SamplingParams, sample_token_rows

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
GEOMETRY = dict(max_slots=4, max_seq=64, page_size=16, chunk=8)

#: each case: the engine options of the runs compared with the JAX engine
CASES = {
    "decode_window_1_and_4": [dict(decode_window=1), dict(decode_window=4)],
    # 7 usable pages: full reservation would need 2-3 per request
    "optimistic_preemption": [dict(decode_window=2, prefill_rows=2, reserve="optimistic",
                                   n_pages=8)],
    "prefix_cache_on_and_off": [dict(decode_window=4), dict(decode_window=4, prefix_cache=False)],
}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_flat(params_to_flat(jparams), tcfg, device="cpu")


def _trace(seed: int = 0):
    """Six requests: a 16-token (one-page) shared prefix, then 2-19 own
    tokens; 8-23 new tokens each."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, 512, 16)]
    return [(prefix + [int(t) for t in rng.integers(0, 512, int(rng.integers(2, 20)))],
             int(rng.integers(8, 24))) for _ in range(6)]


def _serve(engine_cls, params, cfg, reqs, **kw):
    eng = engine_cls(params, cfg, **GEOMETRY, **kw)
    uids = [eng.submit(p, n) for p, n in reqs]
    outs = eng.run()
    return eng, [outs[u] for u in uids], [eng.requests[u].logprobs for u in uids]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_streams_match_jax(models, case):
    jcfg, jparams, tcfg, tparams = models
    reqs = _trace()
    for kw in CASES[case]:
        jeng, jout, jlp = _serve(JaxEngine, jparams, jcfg, reqs, **kw)
        teng, tout, tlp = _serve(Engine, tparams, tcfg, reqs, device="cpu", **kw)
        assert tout == jout, kw
        assert [len(o) for o in tout] == [n for _, n in reqs]
        for key, value in jeng.stats.items():
            assert teng.stats[key] == value, (kw, key)
        # the sampled token's logprob: f32 log-softmax of bf16 logits. Now
        # and then the JAX engine's paged program rounds a logit one bf16
        # step (2^-6 below 4) off its own dense forward, which the port
        # matches; so one step is allowed, and only rarely
        for a, b in zip(tlp, jlp):
            np.testing.assert_allclose(a, b, atol=2 ** -5)
        diff = np.abs(np.concatenate(tlp) - np.concatenate(jlp))
        assert (diff > 1e-4).mean() < 0.05, diff
        if kw.get("reserve") == "optimistic":
            assert teng.stats["preemptions"] > 0
        assert teng.stats["window_forwards"] >= teng.stats["window_steps"]


def test_engine_streaming_stop_and_abort(models):
    """on_token streams exactly the delivered tokens; a stop token ends a
    request; abort retires a request mid-decode (the JAX engine's rules)."""
    _, _, tcfg, tparams = models
    reqs = _trace(1)
    eng = Engine(tparams, tcfg, device="cpu", decode_window=4, **GEOMETRY)
    ref = [o for o in _serve(Engine, tparams, tcfg, reqs, device="cpu", decode_window=4)[1]]
    streamed = {}
    uids = [eng.submit(p, n, on_token=lambda u, t: streamed.setdefault(u, []).append(t))
            for p, n in reqs[:3]]
    stop = ref[3][2]
    u_stop = eng.submit(reqs[3][0], reqs[3][1], stop_token_ids=[stop])
    u_abort = eng.submit(reqs[4][0], reqs[4][1])
    eng.step()
    assert eng.abort(u_abort) and not eng.abort(12345)
    outs = eng.run()
    for u, r in zip(uids, ref):
        assert outs[u] == r and streamed[u] == r
    assert outs[u_stop] == ref[3][: ref[3].index(stop) + 1]
    assert len(outs[u_abort]) < reqs[4][1]
    assert eng.pop_finished(u_stop) == outs[u_stop] and u_stop not in eng.requests


def test_engine_logprobs_topk_and_sampling(models):
    """logprobs_topk returns K alternatives led by the greedy token; sampled
    requests give valid tokens and repeat under the same seed."""
    _, _, tcfg, tparams = models
    reqs = _trace(2)[:3]

    def run(seed):
        eng = Engine(tparams, tcfg, device="cpu", seed=seed, logprobs_topk=3,
                     decode_window=2, **GEOMETRY)
        uids = [eng.submit(p, n, sampling=SamplingParams(temperature=0.8, top_k=20) if i else None)
                for i, (p, n) in enumerate(reqs)]
        outs = eng.run()
        return [outs[u] for u in uids], [eng.requests[u] for u in uids]

    outs, req = run(7)
    assert outs == run(7)[0]
    top = req[0].top_logprobs  # the greedy request
    assert len(top) == len(outs[0]) and all(len(t) == 3 for t in top)
    assert [t[0][0] for t in top] == outs[0]
    np.testing.assert_allclose([t[0][1] for t in top], req[0].logprobs, atol=1e-6)
    assert all(0 <= t < TINY["vocab_size"] for o in outs for t in o)


def test_sample_token_rows_greedy_rows_match_jax(rng):
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 3
    temps = np.asarray([0.0, 0.9, 0.0, 1.3], np.float32)
    top_ks = np.asarray([0, 5, 0, 1], np.int32)
    top_ps = np.asarray([1.0, 0.9, 1.0, 1.0], np.float32)
    ref = np.asarray(jax_rows(jax.numpy.asarray(logits), temps, top_ks, top_ps,
                              jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        out = sample_token_rows(torch.from_numpy(logits), temps, top_ks, top_ps, gen).numpy()
        np.testing.assert_array_equal(out[[0, 2, 3]], ref[[0, 2, 3]])  # greedy, top-1
        assert out[1] in np.argsort(-logits[1])[:5]
    zero = np.zeros(4, np.float32)
    np.testing.assert_array_equal(
        sample_token_rows(torch.from_numpy(logits), zero, zero.astype(np.int32), zero + 1).numpy(),
        logits.argmax(-1))


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "A15"), (dict(enable_penalties=True), "A6"),
])
def test_engine_refuses_unported_options(models, kw, match):
    """``mesh`` (ROADMAP A15) is refused. ``enable_penalties`` (A6, ported)
    behaves as in the JAX Engine: it constructs and a ``logit_bias`` that
    outweighs every logit forces its token in both engines; without it, a
    ``logit_bias`` raises the JAX Engine's ValueError in both."""
    jcfg, jparams, tcfg, tparams = models
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match=match):
            Engine(tparams, tcfg, device="cpu", **GEOMETRY, **kw)
    else:
        outs = []
        for engine_cls, params, cfg, dev in ((Engine, tparams, tcfg, dict(device="cpu")),
                                             (JaxEngine, jparams, jcfg, {})):
            eng = engine_cls(params, cfg, **GEOMETRY, **kw, **dev)
            uid = eng.submit([1, 2], 3, logit_bias={5: 1e4})
            outs.append(eng.run()[uid])
        assert outs[0] == outs[1] == [5, 5, 5]
    for engine_cls, params, cfg, dev in ((Engine, tparams, tcfg, dict(device="cpu")),
                                         (JaxEngine, jparams, jcfg, {})):
        eng = engine_cls(params, cfg, **GEOMETRY, **dev)
        with pytest.raises(ValueError, match="enable_penalties"):
            eng.submit([1, 2], 3, logit_bias={5: 1.0})
