"""The JAX Engine's two switches, read by the port's Engine:
``QUICK_TPU_MIXED_COLD=1`` (the padded mixed step while more slots prefill
than decode, quick_tpu/runtime/serving.py:922-928) and
``QUICK_TPU_ENGINE_TIMING=1`` (host seconds per phase of a turn in
``timing``, :253-279). The engines, model and geometry of
tests/test_torch_serving.py, on the CPU."""
import numpy as np
import pytest
from test_torch_serving import GEOMETRY, _serve, _trace, models  # noqa: F401

from quick_tpu.runtime.serving import Engine as JaxEngine
from quick_tpu_torch.runtime import Engine


def _cold_trace():
    """Eight requests at once into four slots: the first turns find every
    slot prefilling and none decoding (the cold start), and retirements
    later admit new prefills beside decoding slots."""
    rng = np.random.default_rng(3)
    return [([int(t) for t in rng.integers(0, 512, int(rng.integers(10, 30)))],
             int(rng.integers(6, 14))) for _ in range(8)]


def test_mixed_cold_matches_jax(models, monkeypatch):  # noqa: F811
    """Under the switch both engines take the mixed step on the cold start:
    the greedy streams and every ``stats`` key the JAX Engine keeps are
    equal, and the schedule differs from the one without the switch."""
    jcfg, jparams, tcfg, tparams = models
    reqs = _cold_trace()
    kw = dict(decode_window=4, prefill_rows=2)
    _, default_out, _ = _serve(Engine, tparams, tcfg, reqs, device="cpu", **kw)
    default = _serve(Engine, tparams, tcfg, reqs, device="cpu", **kw)[0].stats
    monkeypatch.setenv("QUICK_TPU_MIXED_COLD", "1")
    jeng, jout, _ = _serve(JaxEngine, jparams, jcfg, reqs, **kw)
    teng, tout, _ = _serve(Engine, tparams, tcfg, reqs, device="cpu", **kw)
    assert tout == jout
    assert [len(o) for o in tout] == [n for _, n in reqs]
    for key, value in jeng.stats.items():
        assert teng.stats[key] == value, key
    assert teng.stats["mixed_steps"] > default["mixed_steps"]
    assert tout == default_out  # greedy: the schedule does not change the tokens


@pytest.mark.parametrize("on", [True, False])
def test_engine_timing(models, monkeypatch, on):  # noqa: F811
    """``timing`` always exists with the JAX Engine's eight keys; under the
    switch each is >= 0, admission took time, a serial fetch is part of its
    fetch time; without it every value stays 0."""
    jcfg, jparams, tcfg, tparams = models
    if on:
        monkeypatch.setenv("QUICK_TPU_ENGINE_TIMING", "1")
    else:
        monkeypatch.delenv("QUICK_TPU_ENGINE_TIMING", raising=False)
    jkeys = JaxEngine(jparams, jcfg, **GEOMETRY).timing.keys()
    teng = _serve(Engine, tparams, tcfg, _trace(), device="cpu", decode_window=4)[0]
    t = teng.timing
    assert t.keys() == jkeys
    if on:
        assert all(v >= 0 for v in t.values()) and t["admit"] > 0
        assert t["window_dispatch"] > 0 and t["prefill_dispatch"] > 0
        assert t["window_fetch_serial"] <= t["window_fetch"]
        assert t["pending_fetch_serial"] <= t["pending_fetch"]
    else:
        assert all(v == 0 for v in t.values())
