"""The JAX package's kernel switches, read by the port where it takes the
same decision (every call reads them): ``QUICK_TPU_PAGED=0`` (paged
attention by gather + einsum, K5 / K6 / K10 off), ``QUICK_TPU_DENSE_KERNEL=0``
(K7 off), ``QUICK_TPU_FLASH=0`` (the einsum prefill, K2 off),
``QUICK_TPU_PAGED_WRITE=0`` (torch scatters, K4 / K4q off),
``QUICK_TPU_FUSED_NORM=0`` (no RMSNorm prologue) and ``QUICK_TPU_MOE_BM``
(the grouped GEMM's tile height). Each test shows the route the switch
takes through the port's gate, on a CUDA device object where the gate asks
for one (no card needed to decide), then holds a tiny model's outputs
under the switch to quick_tpu's under the same switch, at the tolerances
of tests/test_torch_model.py and tests/test_torch_moe.py."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32, least_route_gap
from test_torch_moe import BASE, GAP, TOL_BF16, _bf16, quant_models  # noqa: F401

import quick_tpu_torch.modules.blocks as tblocks
import quick_tpu_torch.ops.grouped_matmul as tgm
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.models import init_quant_params, model_forward as jax_forward
from quick_tpu.modules.blocks import moe_forward as jax_moe_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JCache
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu.utils.checkpoint import params_to_flat
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.models.convert import params_from_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.linear import QuantLinear
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.attention import _use_flash
from quick_tpu_torch.ops.paged_write import _use_write_kernel
from quick_tpu_torch.runtime import make_cache

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
TOL = dict(atol=3e-2, rtol=3e-2)  # logits, as tests/test_torch_model.py
CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def tiny():
    """A tiny quantized llama in both packages (quick_tpu's random weights,
    seed 3, carried over by name)."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = init_quant_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jparams, tcfg, params_from_flat(params_to_flat(jparams), tcfg, device="cpu")


@pytest.fixture
def switch(monkeypatch):
    """Set a switch for quick_tpu (which reads it while tracing: its traces
    are cleared around the test) and for the port."""
    jax.clear_caches()

    def set_(name, value):
        monkeypatch.setenv(name, value)
        jax.clear_caches()

    yield set_
    jax.clear_caches()


def _dense_run(tiny, B=2, S=12, steps=3):
    """A prefill of S tokens and ``steps`` greedy decode steps over the
    dense cache in both packages; every step's logits compared."""
    jcfg, jparams, tcfg, tparams = tiny
    toks = np.random.default_rng(7).integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jax_cache(jcfg, B, 32), make_cache(tcfg, B, 32, device="cpu")
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), jc)
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for _ in range(steps):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc)
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(nxt).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


def _paged_run(tiny):
    """A ragged chunk then three decode steps over paged caches in both
    packages (tests/test_torch_paged_attention.py's protocol); logits and
    the written pages compared."""
    jcfg, jparams, tcfg, tparams = tiny
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jc = JCache.create(2, 9, 8, 2, 32, 2, 32, jnp.bfloat16)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(bt), length=jnp.asarray([0, 5], jnp.int32))
    tc = PagedKVCache.create(2, 9, 8, 2, 32, 2, 32, device="cpu")
    tc.block_table.copy_(torch.from_numpy(bt))
    tc = tc.with_length(torch.tensor([0, 5]))
    toks = np.random.default_rng(5).integers(0, 512, (2, 6)).astype(np.int32)
    valid = np.asarray([6, 4], np.int32)
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), jc, advance=jnp.asarray(valid),
                         last_valid=jnp.asarray(valid))
    tl, tc = model_forward(tparams, tcfg, torch.from_numpy(toks).long(), tc,
                           advance=torch.from_numpy(valid), last_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    one = np.asarray([1, 1], np.int32)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jax_forward(jparams, jcfg, jnp.asarray(nxt), jc, advance=jnp.asarray(one),
                             last_valid=jnp.asarray(one))
        tl, tc = model_forward(tparams, tcfg, torch.from_numpy(nxt).long(), tc,
                               advance=torch.from_numpy(one), last_valid=torch.from_numpy(one))
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    np.testing.assert_array_equal(tc.length.numpy(), [9, 12])
    np.testing.assert_allclose(f32(tc.k_pages)[:, 1:], f32(jc.k_pages)[:, 1:], **TOL)
    np.testing.assert_allclose(f32(tc.v_pages)[:, 1:], f32(jc.v_pages)[:, 1:], **TOL)


def test_paged_switch(tiny, switch):
    """QUICK_TPU_PAGED=0: a paged cache on the card no longer reads its
    pages with K5 / K6 (nor MLA's with K10, the same gate); the model
    runs the gather + einsum route, as quick_tpu's XLA gather."""
    tc = PagedKVCache.create(1, 3, 8, 1, 8, 2, 32, device="cpu")
    on_card = dataclasses.replace(tc, k_pages=types.SimpleNamespace(is_cuda=True))
    assert tblocks._use_paged_kernel(on_card) and not tblocks._use_paged_kernel(tc)
    switch("QUICK_TPU_PAGED", "0")
    assert not tblocks._use_paged_kernel(on_card)
    _paged_run(tiny)
    switch("QUICK_TPU_PAGED", "1")  # the kernel is the card's default already
    assert tblocks._use_paged_kernel(on_card) and not tblocks._use_paged_kernel(tc)


def test_paged_write_switch(tiny, switch):
    """QUICK_TPU_PAGED_WRITE=0: page writes on the card take the torch
    scatters (K4 / K4q's plain version) instead of the kernels."""
    assert _use_write_kernel(CUDA) and not _use_write_kernel(torch.device("cpu"))
    switch("QUICK_TPU_PAGED_WRITE", "0")
    assert not _use_write_kernel(CUDA)
    _paged_run(tiny)
    switch("QUICK_TPU_PAGED_WRITE", "1")
    assert _use_write_kernel(CUDA)


def test_dense_kernel_switch(tiny, switch):
    """QUICK_TPU_DENSE_KERNEL=0: a dense cache of >= 8 MB of K + V a layer
    on the card no longer decodes through K7."""
    big = types.SimpleNamespace(max_seq=1024)  # 2 * 4 * 1024 * 8 * 128 * 2 B = 16 MB
    assert tblocks._use_dense_decode_kernel(4, 32, 8, big, 128, CUDA)
    switch("QUICK_TPU_DENSE_KERNEL", "0")
    assert not tblocks._use_dense_decode_kernel(4, 32, 8, big, 128, CUDA)
    _dense_run(tiny)
    switch("QUICK_TPU_DENSE_KERNEL", "1")
    assert tblocks._use_dense_decode_kernel(4, 32, 8, big, 128, CUDA)


def test_flash_switch(tiny, switch):
    """QUICK_TPU_FLASH=0: prefills on the card take the einsum attention
    instead of K2."""
    assert _use_flash(128, 256, 128, CUDA) and not _use_flash(128, 256, 128, torch.device("cpu"))
    switch("QUICK_TPU_FLASH", "0")
    assert not _use_flash(128, 256, 128, CUDA)
    _dense_run(tiny, S=20)
    switch("QUICK_TPU_FLASH", "1")
    assert _use_flash(128, 256, 128, CUDA)


def test_fused_norm_switch(tiny, switch):
    """QUICK_TPU_FUSED_NORM=0: decode rows no longer fold the pre-GEMM
    RMSNorm into K1's prologue (on every device: the gate reads no
    device)."""
    lin = tiny[3].blocks[0].attn.qkv_proj
    assert isinstance(lin, QuantLinear) and lin.group_size == 128
    x = torch.zeros((4, 1, TINY["hidden_size"]))
    assert tblocks._fuse_decode_norm_ok(lin, x)
    switch("QUICK_TPU_FUSED_NORM", "0")
    assert not tblocks._fuse_decode_norm_ok(lin, x)
    _dense_run(tiny)
    switch("QUICK_TPU_FUSED_NORM", "1")
    assert tblocks._fuse_decode_norm_ok(lin, x)


def test_moe_bm_switch(quant_models, switch, monkeypatch):  # noqa: F811
    """QUICK_TPU_MOE_BM=<n> sets the grouped GEMM's tile height, as in
    quick_tpu; on the card a height K8 (32, 64, 128) or K12 (a multiple of
    32) cannot take raises an error naming the switch. One MoE layer of
    the tiny Mixtral at 48 tokens (the sorted branch) at bm = 64 and 16."""
    assert tgm.pick_grouped_bm(96, 4) == 32
    jcfg, jparams, tcfg, tparams = quant_models["mixtral"]
    jp, tp = jparams.blocks[0].mlp, tparams.blocks[0].mlp
    x = np.random.default_rng(8).standard_normal((2, 24, BASE["hidden_size"])).astype(np.float32)
    xj, xt = _bf16(x)
    assert least_route_gap(tp, tcfg, xt) > GAP
    seen = []
    orig = tgm.build_routing
    monkeypatch.setattr(tgm, "build_routing", lambda sel, E, bm: seen.append(bm) or orig(sel, E, bm))
    for bm in ("64", "16"):
        switch("QUICK_TPU_MOE_BM", bm)
        assert tgm.pick_grouped_bm(96, 4) == int(bm)
        want = jax_moe_forward(jp, jcfg, xj)
        got = tblocks.moe_forward(tp, tcfg, xt)
        np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)
        assert seen[-1] == int(bm)
    tgm.check_grouped_bm(64)
    tgm.check_grouped_bm(96, a8=True)
    for bm, a8 in ((16, False), (96, False), (256, False), (48, True)):
        with pytest.raises(ValueError, match="QUICK_TPU_MOE_BM"):
            tgm.check_grouped_bm(bm, a8=a8)
