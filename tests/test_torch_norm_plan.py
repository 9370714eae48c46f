"""K13's vector rows on the CPU (``ops/norms.py``: ``norm_plan`` and the
kernel's thread-to-values map ``norm_elements``): every value of every row
read by exactly one thread, vector units only where x's and the weight's
base and x's row stride lie on 16 bytes and the row is a whole number of
units that the registers hold, and the plans of the port's paths
(Mistral's 4096-wide rows, DeepSeek's 512-wide latent slice of a 576-wide
row, f32 rows, D = 5000 on the scalar path); then ``rms_norm`` on CPU
tensors against the JAX package's jnp ``rms_norm`` and ``rms_norm_pallas``
in interpret mode, as tests/test_torch_a8.py holds it, on those shapes.
(K13 itself is held within one step of x's type to its plain version on a
card in test_torch_kernels.py and chip_smoke.py's phase 12a.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu_torch.ops.norms as tnorms
from quick_tpu.ops.norms import rms_norm as jax_rms_norm, rms_norm_pallas

BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode (read when a jitted function is
    traced: the jit caches are cleared on the way in and out)."""
    jax.clear_caches()
    monkeypatch.setenv("QUICK_TPU_PALLAS_INTERPRET", "1")
    yield
    monkeypatch.delenv("QUICK_TPU_PALLAS_INTERPRET")
    jax.clear_caches()


#: (M, D, ldx, dtype, aligned): the paths' norms (generate()'s decode and
#: prefill, the Engines' decode, the latent slice), f32 rows, narrow and
#: odd widths, misaligned bases and strides, D = 5000
CASES = {
    "decode_4": (4, 4096, 4096, BF, True),
    "prefill_512": (512, 4096, 4096, BF, True),
    "engine_16": (16, 4096, 4096, BF, True),
    "int8_engine_64": (64, 4096, 4096, BF, True),
    "latent_16": (16, 512, 576, BF, True),
    "latent_1": (1, 512, 576, BF, True),
    "f32_rows": (16, 128, 128, F32, True),
    "f32_wide": (3, 4096, 4096, F32, True),
    "deepseek_hidden": (4, 2048, 2048, BF, True),
    "narrow": (7, 64, 64, BF, True),
    "odd_width": (5, 100, 100, BF, True),
    "misaligned_base": (4, 512, 576, BF, False),
    "misaligned_stride": (4, 512, 577, BF, True),
    "d5000": (16, 5000, 5000, BF, True),
    "one_row": (1, 4096, 4096, BF, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_value_read_once(case):
    """Over every thread of every block the plan launches, each (row,
    value) of the M x D input is read by exactly one thread; threads past
    the rows hold none; a block has at most 256 threads."""
    M, D, ldx, dt, aligned = CASES[case]
    plan = tnorms.norm_plan(M, D, ldx, dt, aligned)
    threads = plan.lanes * plan.rows if plan.vector else tnorms.NORM_BLOCK
    assert threads <= tnorms.NORM_BLOCK
    seen = np.zeros((M, D), np.int64)
    for bx in range(tnorms.norm_grid(plan, M) if plan.vector else M):
        for t in range(threads):
            row, ks = tnorms.norm_elements(plan, M, D, bx, t)
            if row < 0:
                assert not ks
                continue
            seen[row, ks] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", list(CASES))
def test_vector_units_only_where_aligned(case):
    """Vector units only where the bases are on 16 bytes, x's row stride is
    (a single row has none), the width is a whole number of 8-value units
    and at most 128 lanes x 4 units; then the lanes are a power of two from
    a warp up, the fewest whose units hold the row."""
    M, D, ldx, dt, aligned = CASES[case]
    plan = tnorms.norm_plan(M, D, ldx, dt, aligned)
    esize = 2 if dt == BF else 4
    fits = (aligned and D % 8 == 0 and (M == 1 or ldx * esize % 16 == 0)
            and D // 8 <= tnorms.NORM_MAX_LANES * tnorms.NORM_MAX_UNITS)
    assert plan.vector == fits
    if plan.vector:
        assert plan.lanes in (32, 64, 128) and 1 <= plan.units <= tnorms.NORM_MAX_UNITS
        assert plan.lanes * plan.units * 8 >= D
        assert plan.lanes == 32 or (plan.lanes // 2) * tnorms.NORM_MAX_UNITS * 8 < D
    else:
        assert plan.units == 0 and plan.rows == 1


def test_path_plans():
    """Mistral's rows: 128 lanes x 4 units, a row a block (M = 4: four
    blocks, M = 512: 512); DeepSeek's hidden rows: 64 lanes x 4 units, a
    row a block; its latent slice (D 512 of a 576-wide row) and f32 rows: a
    warp a row, 8 rows a block (M = 16: two blocks); D = 5000 and a base
    off 16 bytes: the scalar path."""
    P = tnorms.NormPlan
    assert tnorms.norm_plan(4, 4096, 4096, BF) == P(128, 4, 1, True)
    assert tnorms.norm_grid(tnorms.norm_plan(4, 4096, 4096, BF), 4) == 4
    assert tnorms.norm_grid(tnorms.norm_plan(512, 4096, 4096, BF), 512) == 512
    assert tnorms.norm_plan(16, 2048, 2048, BF) == P(64, 4, 1, True)
    assert tnorms.norm_plan(16, 512, 576, BF) == P(32, 2, 8, True)
    assert tnorms.norm_grid(tnorms.norm_plan(16, 512, 576, BF), 16) == 2
    assert tnorms.norm_plan(16, 128, 128, F32) == P(32, 1, 8, True)
    assert tnorms.norm_plan(16, 5000, 5000, BF) == P(256, 0, 1, False)
    assert tnorms.norm_plan(16, 512, 576, BF, aligned=False).vector is False


@pytest.mark.parametrize("rows,units,pdl", [(1, 4, True), (8, 0, True), (8, 4, False)])
def test_plan_switches(monkeypatch, rows, units, pdl):
    """The measurement switches kernel_ablate.py and chip_smoke.py set: a
    block a row (NORM_MAX_ROWS 1), every row scalar (NORM_MAX_UNITS 0); the
    plan still reads every value once."""
    monkeypatch.setattr(tnorms, "NORM_MAX_ROWS", rows)
    monkeypatch.setattr(tnorms, "NORM_MAX_UNITS", units)
    monkeypatch.setattr(tnorms, "NORM_PDL", pdl)
    plan = tnorms.norm_plan(16, 512, 576, BF)
    assert plan.vector == (units > 0) and plan.rows == (min(rows, 8) if units else 1)  # 32 lanes
    seen = np.zeros((16, 512), np.int64)
    threads = plan.lanes * plan.rows if plan.vector else tnorms.NORM_BLOCK
    for bx in range(tnorms.norm_grid(plan, 16)):
        for t in range(threads):
            row, ks = tnorms.norm_elements(plan, 16, 512, bx, t)
            if row >= 0:
                seen[row, ks] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,ld,dtype", [((4, 4096), None, jnp.bfloat16),
                                            ((16, 512), 576, jnp.bfloat16),
                                            ((16, 128), None, jnp.float32),
                                            ((4, 2048), None, jnp.bfloat16)])
def test_rms_norm_cpu_matches_jax_and_pallas(interpret, shape, ld, dtype):
    """``rms_norm`` on CPU tensors (``rms_norm_plain``; a strided last-dim
    slice where ``ld`` is given) against the JAX package's jnp ``rms_norm``
    and ``rms_norm_pallas`` (interpret): equal in bf16, within f32 rounding
    of the mean in f32."""
    rng = np.random.default_rng(shape[-1])
    M, D = shape
    x = (rng.standard_normal((M, ld or D)) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    xj, wj = jnp.asarray(x[:, :D], dtype), jnp.asarray(w, jnp.bfloat16)
    tdt = BF if dtype == jnp.bfloat16 else F32
    xt = torch.from_numpy(np.array(jnp.asarray(x, dtype), np.float32)).to(tdt)[:, :D]
    wt = torch.from_numpy(np.asarray(wj, np.float32)).to(BF)
    out = tnorms.rms_norm(xt, wt, 1e-5)
    assert out.dtype == tdt and tuple(out.shape) == shape
    assert torch.equal(out, tnorms.rms_norm_plain(xt, wt, 1e-5))
    for ref in (jax_rms_norm(xj, wj, 1e-5), rms_norm_pallas(xj, wj, 1e-5)):
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(f32(out), f32(ref))
        else:
            np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-6, atol=0)
