"""Port parity for W4A8 and RMSNorm ops: ``quantize_activations``, the plain
versions of K11 / K11f (``_quantized_matmul_a8_jnp``, ``_make_kernel_a8``,
``_make_kernel_a8_fused``) and of K12 (``_grouped_fallback(a8=True)``,
``_make_grouped_kernel_a8``), the gates of ``quantized_matmul(a8=True)``,
the switches ``QUICK_TPU_A8`` / ``QUICK_TPU_A8_FUSED``, and ``rms_norm``
against the JAX package's jnp form and ``rms_norm_pallas``; each against
``quick_tpu`` on the CPU on inputs made from a numpy seed. The Pallas bodies
run in interpret mode, as the JAX package's own tests run them."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.ops.grouped_matmul as jgm
import quick_tpu_torch.ops.grouped_matmul as tgm
from quick_tpu.ops.norms import rms_norm as jax_rms_norm, rms_norm_pallas
from quick_tpu.quantize.numerics import quantize_tensor
from quick_tpu.quantize.packing import pack_qtpu
from quick_tpu_torch.modules.linear import QuantLinear, a8_enabled
from quick_tpu_torch.ops import norms as tnorms

# ``quick_tpu.ops.quantized_matmul`` is also the name of the function the
# package exports, so the modules are taken by name
jqm = importlib.import_module("quick_tpu.ops.quantized_matmul")
tqm = importlib.import_module("quick_tpu_torch.ops.quantized_matmul")

#: as tests/test_quantized_matmul.py:110-120 (jnp form against the A8 kernel)
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode. The switch is read when a jitted
    function is traced, so the jit caches are cleared on the way in and out."""
    jax.clear_caches()
    monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
    yield
    monkeypatch.delenv("QUICK_TPU_PALLAS_INTERPRET")
    jax.clear_caches()


def _case(seed, M, K, N, G):
    """The JAX GEMM tests' inputs (tests/test_quantized_matmul.py::_make_case):
    RTN-quantized weights, bf16 activations as a JAX array and a tensor."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    qt = quantize_tensor(jnp.asarray(w), group_size=G)
    qw = pack_qtpu(np.asarray(qt.q), G)
    s = np.asarray(qt.scales)
    zs = np.asarray(qt.zeros * qt.scales, np.float32)
    xj = jnp.asarray((rng.standard_normal((M, K)) * 0.5).astype(np.float32), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return ((xj, jnp.asarray(qw), jnp.asarray(s), jnp.asarray(zs)),
            (xt, *(torch.from_numpy(np.array(a)) for a in (qw, s, zs))))


# --------------------------------------------------- quantize_activations


@pytest.mark.parametrize("M,scale", [(4, 0.5), (97, 3.0), (200, 1e-3)])
def test_quantize_activations_matches_jax(M, scale):
    """Codes and row scales byte-equal to the eager JAX function's (true
    division by 127, round half to even); against the jitted function, where
    XLA multiplies by the reciprocal, a scale may be one ulp off and a code
    one step off. A zero row takes the 1e-8 floor."""
    rng = np.random.default_rng(M)
    x = (rng.standard_normal((M, 256)) * scale).astype(np.float32)
    x[0] = 0.0
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    q, sx = tqm.quantize_activations(xt)
    qj, sj = jqm.quantize_activations(xj)
    assert q.dtype == torch.int8 and sx.dtype == torch.float32 and tuple(sx.shape) == (M, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert sx.numpy().tobytes() == np.asarray(sj).tobytes()
    assert float(sx[0, 0]) == np.float32(1e-8)
    qjj, sjj = jax.jit(jqm.quantize_activations)(xj)
    assert np.abs(np.asarray(qjj, np.int32) - q.numpy().astype(np.int32)).max() <= 1
    assert np.abs(np.asarray(sjj).view(np.int32) - sx.numpy().view(np.int32)).max() <= 1


# ------------------------------------------------------ K11 / K11f contract


@pytest.mark.parametrize("M", [97, 128, 200])
@pytest.mark.parametrize("G", [128, 64])
def test_a8_plain_bit_equal_to_jnp(M, G):
    """The plain version against ``_quantized_matmul_a8_jnp`` run eagerly:
    the same codes, exact integer dots and the same f32 steps give the same
    bf16 outputs bit for bit."""
    (xj, *wj), (xt, *wt) = _case(M, M, 512, 256, G)
    ref = jqm._quantized_matmul_a8_jnp(xj, *wj, G, jnp.bfloat16)
    out = tqm.quantized_matmul_a8_plain(xt, *wt, G)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, 256)
    np.testing.assert_array_equal(f32(out), f32(ref))


@pytest.mark.parametrize("M", [97, 128, 200])
@pytest.mark.parametrize("fused", [False, True])
def test_a8_plain_matches_pallas_a8_kernels(interpret, monkeypatch, M, fused):
    """The plain version against ``_make_kernel_a8`` and, under
    ``QUICK_TPU_A8_FUSED=1``, ``_make_kernel_a8_fused`` (interpret mode,
    ragged M padded by the JAX wrapper) within the JAX tests' 2e-2: the
    Pallas route quantizes inside ``jit``, where a code may differ by one."""
    if fused:
        monkeypatch.setenv("QUICK_TPU_A8_FUSED", "1")
    (xj, *wj), (xt, *wt) = _case(M + 1, M, 512, 256, 128)
    ref = jqm._quantized_matmul_2d_a8(xj, *wj)
    out = tqm.quantized_matmul_a8_plain(xt, *wt, 128)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


@pytest.mark.parametrize("M,G,fused", [(97, 128, False), (200, 128, True), (128, 64, True)])
def test_a8_public_cpu_route_matches_jax(monkeypatch, M, G, fused):
    """``quantized_matmul(a8=True)`` on CPU tensors against the JAX entry
    point's default CPU route (the jitted jnp form); at G = 64 the fused
    switch changes neither."""
    if fused:
        monkeypatch.setenv("QUICK_TPU_A8_FUSED", "1")
    jax.clear_caches()
    (xj, *wj), (xt, *wt) = _case(2 * M, M, 512, 384, G)
    ref = jqm.quantized_matmul(xj, *wj, group_size=G, a8=True)
    out = tqm.quantized_matmul(xt, *wt, group_size=G, a8=True)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    assert tqm.a8_fused_quant() is fused


@pytest.mark.parametrize("M", [1, 4, 96])
def test_a8_gate_keeps_decode_rows_on_w4a16(M):
    """Rows <= 96 under a8 give exactly the W4A16 result (``a8 and rows >
    96``, :1023), as the JAX package's decode rows do."""
    (xj, *wj), (xt, *wt) = _case(M, M, 512, 256, 128)
    out = tqm.quantized_matmul(xt, *wt, a8=True)
    assert torch.equal(out, tqm.quantized_matmul(xt, *wt))
    np.testing.assert_array_equal(f32(jqm.quantized_matmul(xj, *wj, a8=True)),
                                  f32(jqm.quantized_matmul(xj, *wj)))


@pytest.mark.parametrize("prologue", ["norm", "glu"])
@pytest.mark.parametrize("M", [4, 128])
def test_a8_unfuses_the_prologues(prologue, M):
    """``a8`` applies the RMSNorm / SiLU-GLU prologue first at any row count
    (:996-1004), so a8 at 4 rows matches the JAX result of the same call,
    and at 128 rows the W4A8 route after the unfused prologue."""
    K, N = 512, 256
    rng = np.random.default_rng(M)
    (xj, *wj), (xt, *wt) = _case(M + 7, M, K, N, 128)
    kj, kt = {}, {}
    if prologue == "norm":
        w = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kj["fuse_norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-5)
        kt["fuse_norm"] = (torch.from_numpy(np.asarray(kj["fuse_norm"][0], np.float32))
                           .to(torch.bfloat16), 1e-5)
    else:
        g = (rng.standard_normal((M, 2 * K)) * 0.5).astype(np.float32)
        xj = jnp.asarray(g, jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
        kj["fuse_glu"] = kt["fuse_glu"] = True
    ref = jqm.quantized_matmul(xj, *wj, a8=True, **kj)
    out = tqm.quantized_matmul(xt, *wt, a8=True, **kt)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    pre = (tqm.glu_plain(xt) if prologue == "glu"
           else tnorms.rms_norm(xt, kt["fuse_norm"][0], 1e-5))
    assert torch.equal(out, tqm.quantized_matmul(pre, *wt, a8=True))


def test_quant_linear_reads_the_a8_switch_at_each_call(monkeypatch):
    """``QuantLinear`` passes ``a8=a8_enabled()``, which reads QUICK_TPU_A8 at
    every call: on, 128 rows take the W4A8 plain route; off, W4A16."""
    _, (xt, qw, s, zs) = _case(5, 128, 512, 256, 128)
    lin = QuantLinear(qw, s, zs)
    monkeypatch.delenv("QUICK_TPU_A8", raising=False)
    assert not a8_enabled()
    assert torch.equal(lin(xt), tqm.quantized_matmul_plain(xt, qw, s, zs))
    monkeypatch.setenv("QUICK_TPU_A8", "1")
    assert a8_enabled()
    assert torch.equal(lin(xt), tqm.quantized_matmul_a8_plain(xt, qw, s, zs))


# ------------------------------------------------------------ K12 contract


def _grouped_inputs(bm, G=128, seed=3):
    """tests/test_torch_moe.py's grouped inputs, at group G."""
    rng = np.random.default_rng(seed)
    E, K, N = 4, 256, 256
    qw = rng.integers(-2**31, 2**31, (E, K // 8, N), dtype=np.int64).astype(np.int32)
    s = ((rng.uniform(size=(E, K // G, N)) * 0.004 + 0.001) / 16).astype(np.float32)
    zs = (np.round(rng.uniform(size=(E, K // G, N)) * 15) * s).astype(np.float32)
    te = np.asarray([0, 0, 2, 3, 3, 3], np.int32)
    live = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    x = rng.standard_normal((len(te) * bm, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return ((xj, *(jnp.asarray(a) for a in (qw, s, zs, te, live))),
            (xt, *(torch.from_numpy(a) for a in (qw, s, zs, te, live))))


@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("ref", ["fallback", "pallas_interpret"])
def test_grouped_a8_plain_matches_jax(monkeypatch, bm, ref):
    """The plain version of K12 against ``_grouped_fallback(a8=True)`` and
    against ``_make_grouped_kernel_a8`` in interpret mode: dead tiles zero,
    within one bf16 step and the Pallas route's in-jit code rounding."""
    (xj, qwj, sj, zsj, tej, lvj), args = _grouped_inputs(bm)
    if ref == "fallback":
        want = jgm._grouped_fallback(xj, qwj, sj, zsj, tej, lvj, bm, 128, jnp.bfloat16, a8=True)
    else:
        jax.clear_caches()
        monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
        want = jgm.quantized_matmul_grouped(xj, qwj, sj, zsj, tej, bm, tile_live=lvj, a8=True)
    got = tgm.quantized_matmul_grouped(*args, bm, a8=True)
    jax.clear_caches()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (6 * bm, 256)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    assert not f32(got)[5 * bm:].any()
    assert torch.equal(got, tgm.quantized_matmul_grouped_a8_plain(*args[:6], bm))


@pytest.mark.parametrize("G,bm", [(64, 32), (128, 16)])
def test_grouped_a8_falls_back_to_w4a16(G, bm):
    """At G != 128 or bm % 32 != 0 the JAX package drops a8 without a word
    (:233); so does the port: the W4A16 result, equal to the JAX one."""
    (xj, qwj, sj, zsj, tej, lvj), args = _grouped_inputs(bm, G)
    got = tgm.quantized_matmul_grouped(*args, bm, group_size=G, a8=True)
    assert torch.equal(got, tgm.quantized_matmul_grouped(*args, bm, group_size=G))
    want = jgm.quantized_matmul_grouped(xj, qwj, sj, zsj, tej, bm, group_size=G,
                                        tile_live=lvj, a8=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-2, rtol=1e-2)


# ------------------------------------------------------------------ K13


@pytest.mark.parametrize("shape,dtype", [((4, 4096), jnp.bfloat16), ((2, 8, 512), jnp.bfloat16),
                                         ((16, 256), jnp.float32)])
def test_rms_norm_matches_jax_and_pallas(interpret, shape, dtype):
    """``rms_norm`` on CPU tensors (``rms_norm_plain``) against the JAX
    package's jnp ``rms_norm`` and ``rms_norm_pallas`` (interpret): equal in
    bf16, within f32 rounding of the mean in f32."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, jnp.bfloat16)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt)
    wt = torch.from_numpy(np.asarray(wj, np.float32)).to(torch.bfloat16)
    out = tnorms.rms_norm(xt, wt, 1e-5)
    assert out.dtype == tdt and tuple(out.shape) == shape
    assert torch.equal(out, tnorms.rms_norm_plain(xt, wt, 1e-5))
    for ref in (jax_rms_norm(xj, wj, 1e-5), rms_norm_pallas(xj, wj, 1e-5)):
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(f32(out), f32(ref))
        else:
            np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-6, atol=0)


def test_rms_norm_launch_keys():
    """K13's launch keys name rows, width and a type other than bf16."""
    assert tnorms.launch_key(4, 4096) == "M=4 D=4096"
    assert tnorms.launch_key(2, 128, torch.float32) == "M=2 D=128 float32"
