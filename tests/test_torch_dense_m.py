"""``QUICK_TPU_DENSE_M``, the dense-dequant route: at that many flattened
rows or more, ``quantized_matmul`` dequantizes the weight to bf16 once
(``bf16(code * s - zs)``) and multiplies densely, ahead of the ``a8``
branch (quick_tpu/ops/quantized_matmul.py:1009-1027). The port's route
against quick_tpu's on the same numpy-seeded inputs, under the switch as
the test sets it (quick_tpu reads it while tracing: its traces are cleared
around each test), and a tiny llama's logits under it.

Tolerance. Both routes round the same bf16 weights, sum the products in
other orders (XLA's CPU dot rounds some partial sums: a cancelling output
may move by a bf16 step of the largest one), then round to bf16. So
``assert_dense_equal`` allows every output 2^-7 x the largest |output| and
at most 2 % of the outputs to differ at all; K1's output-side route (what
the port computed before it read the switch) rounds no weight and differs
in ~40 % of them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params, model_forward as jax_forward
from quick_tpu.ops.norms import rms_norm as jax_rms_norm
from quick_tpu.ops.quantized_matmul import quantized_matmul as jax_qmm
from quick_tpu.quantize.packing import pack_qtpu
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu.utils.checkpoint import params_to_flat
import quick_tpu_torch.ops.quantized_matmul as tqmm
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.runtime import make_cache

K, N = 256, 192
TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
SHARE_OFF = 0.02  # the share of outputs that may differ at all


@pytest.fixture
def dense_m(monkeypatch):
    def set_(m: int):
        monkeypatch.setenv("QUICK_TPU_DENSE_M", str(m))
        jax.clear_caches()

    jax.clear_caches()
    yield set_
    jax.clear_caches()


def _case(rng, M, glu=False, G=128):
    x = rng.standard_normal((M, 2 * K if glu else K)).astype(np.float32)
    q = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 0.001).astype(np.float32)
    z = np.round(rng.uniform(size=(K // G, N)) * 15).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    w = (pack_qtpu(q, G), s, (z * s).astype(np.float32))
    return (xj, *map(jnp.asarray, w)), (xt, *map(torch.from_numpy, w))


def assert_dense_equal(out, ref) -> None:
    o, r = f32(out), f32(ref)
    assert o.shape == r.shape and np.isfinite(o).all()
    d = np.abs(o - r)
    assert d.max() <= 2.0 ** -7 * np.abs(r).max(), float(d.max() / np.abs(r).max())
    assert (d > 0).mean() <= SHARE_OFF, float((d > 0).mean())


@pytest.mark.parametrize("M", [16, 40, 128])
@pytest.mark.parametrize("kind", ["plain", "glu", "a8"])
def test_dense_route_matches_quick_tpu(dense_m, M, kind):
    """At 16 rows or more under ``QUICK_TPU_DENSE_M=16``: the plain call,
    ``fuse_glu`` (the GLU applied first) and ``a8=True`` (the gate comes
    first: at 128 rows W4A8 would take the call otherwise) all take the
    dense route in both packages."""
    (xj, *wj), (xt, *wt) = _case(np.random.default_rng(M), M, glu=kind == "glu")
    kw = dict(fuse_glu=kind == "glu", a8=kind == "a8")
    dense_m(16)
    assert tqmm.dense_m_threshold() == 16
    assert_dense_equal(tqmm.quantized_matmul(xt, *wt, **kw), jax_qmm(xj, *wj, **kw))


def test_dense_route_off_by_default(dense_m, monkeypatch):
    """Unset (or 0) the route is off in both packages; at threshold 1 it
    takes every call, at any group size."""
    monkeypatch.delenv("QUICK_TPU_DENSE_M", raising=False)
    assert tqmm.dense_m_threshold() > 2 ** 60
    dense_m(0)
    assert tqmm.dense_m_threshold() > 2 ** 60
    (xj, *wj), (xt, *wt) = _case(np.random.default_rng(1), 3, G=32)
    dense_m(1)
    assert_dense_equal(tqmm.quantized_matmul(xt, *wt, group_size=32),
                       jax_qmm(xj, *wj, group_size=32))
    np.testing.assert_array_equal(
        f32(tqmm.quantized_matmul(xt, *wt, group_size=32)),
        f32(tqmm.quantized_matmul_dense(xt, *wt, group_size=32)))


def test_dense_route_applies_the_norm_first(dense_m):
    """At threshold 1 a ``fuse_norm`` call of 4 rows takes the route with
    the norm applied first, as quick_tpu's docstring promises (:980). Its
    code does not: the norm is applied early only above 8 rows or with
    ``a8`` (:1000-1004), so its fused call multiplies the raw residual (a
    known divergence, ROADMAP.md §C). The port equals quick_tpu's
    norm-first product, and quick_tpu's fused call equals its product of
    the raw x."""
    rng = np.random.default_rng(4)
    (xj, *wj), (xt, *wt) = _case(rng, 4)
    nw = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    dense_m(1)
    out = tqmm.quantized_matmul(xt, *wt, fuse_norm=(torch.from_numpy(nw), 1e-5))
    normed_first = jax_qmm(jax_rms_norm(xj, jnp.asarray(nw), 1e-5), *wj)
    assert_dense_equal(out, normed_first)
    jax_fused = jax_qmm(xj, *wj, fuse_norm=(jnp.asarray(nw), 1e-5))
    np.testing.assert_array_equal(f32(jax_fused), f32(jax_qmm(xj, *wj)))
    assert np.abs(f32(jax_fused) - f32(normed_first)).max() > 0.1


def test_tiny_model_logits_under_dense_m(dense_m):
    """A 2-layer quantized llama (quick_tpu's random weights, seed 3) under
    ``QUICK_TPU_DENSE_M=16``: the 24-row prefill takes the dense route in
    every projection, the 2-row decode steps do not; every step's logits
    within tests/test_torch_model.py's tolerance of quick_tpu's, and the
    prefill's far closer to them than to the port's logits without the
    switch (the route is taken)."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_flat(params_to_flat(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, 512, (2, 12)).astype(np.int32)
    off = f32(model_forward(tparams, tcfg, torch.from_numpy(toks).long(),
                            make_cache(tcfg, 2, 32, device="cpu"))[0])
    dense_m(16)
    jc, tc = jax_cache(jcfg, 2, 32), make_cache(tcfg, 2, 32, device="cpu")
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), jc)
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=3e-2, rtol=3e-2)
    assert np.abs(f32(tl) - f32(jl)).mean() < 0.25 * np.abs(off - f32(jl)).mean()
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(nxt).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=3e-2, rtol=3e-2)
