"""Port parity for MLA (DeepSeek-V2 / V3 attention): the config dict, the
yarn rope tables and softmax scale, the latent caches' asymmetric writes,
the plain version of the paged MLA decode kernel K10 / K10q, each branch of
``mla_attention_forward`` and the deepseek router, each against
``quick_tpu`` on the CPU on inputs made from a numpy seed. The JAX side
runs its Pallas kernels in interpret mode (``QUICK_TPU_PAGED=1`` for the
paged MLA kernel, ``QUICK_TPU_PAGED_WRITE=1`` for the page writes); the
environment switches are set for the JAX package only. (K10, K10q and the
widened K2 / K4 / K4q are held against these plain versions on a card in
test_torch_kernels.py.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32, least_route_gap

import quick_tpu_torch.modules.blocks as tblocks
from quick_tpu import ModelConfig as JaxConfig
from quick_tpu.modules.blocks import MoEParams as JaxMoE
from quick_tpu.modules.blocks import moe_forward as jax_moe_forward
from quick_tpu.modules.cache import KVCache as JaxKVCache
from quick_tpu.modules.linear import Linear as JaxLinear
from quick_tpu.modules.mla import MLAParams as JaxMLA
from quick_tpu.modules.mla import mla_attention_forward as jax_mla_forward
from quick_tpu.modules.mla import mla_softmax_scale as jax_scale
from quick_tpu.modules.paged_cache import PagedKVCache as JCache
from quick_tpu.ops.mla_paged_attention import mla_paged_decode_attention as jax_mla_paged
from quick_tpu.ops.rope import rope_table as jax_rope_table
from quick_tpu_torch import ModelConfig
from quick_tpu_torch.examples.basic_quant import DEEPSEEK_V2_LITE
from quick_tpu_torch.modules.blocks import MoEParams
from quick_tpu_torch.modules.cache import KVCache
from quick_tpu_torch.modules.linear import Linear
from quick_tpu_torch.modules.mla import MLAParams, make_mla_cache, mla_attention_forward
from quick_tpu_torch.modules.mla import mla_softmax_scale
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.ops.mla_paged_attention import mla_paged_decode_attention_plain
from quick_tpu_torch.ops.rope import rope_table

#: bf16 outputs of f32 sums taken in other orders: one bf16 step and a little
TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
#: least gap between the k-th and (k+1)-th selection score of a routed token
GAP = 1e-4

#: deepseek-ai/DeepSeek-V3 config.json, the fields the port reads (sigmoid
#: scoring with a selection bias, 8 groups of which 4 are kept, q-LoRA)
DEEPSEEK_V3 = dict(
    model_type="deepseek_v3", vocab_size=129280, hidden_size=7168, intermediate_size=18432,
    moe_intermediate_size=2048, num_hidden_layers=61, num_attention_heads=128,
    num_key_value_heads=128, n_shared_experts=1, n_routed_experts=256, num_experts_per_tok=8,
    routed_scaling_factor=2.5, kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, topk_method="noaux_tc", n_group=8, topk_group=4,
    scoring_func="sigmoid", norm_topk_prob=True, first_k_dense_replace=3, moe_layer_freq=1,
    max_position_embeddings=163840, rope_theta=10000,
    rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=1.0, mscale_all_dim=1.0),
    rms_norm_eps=1e-6, tie_word_embeddings=False,
)

#: a tiny MLA geometry with the published yarn scaling
YARN = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
TINY = dict(model_type="deepseek_v2", vocab_size=256, hidden_size=128, intermediate_size=192,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=128, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32, head_dim=48, rotary_dim=16, rope_scaling=YARN)


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


# ------------------------------------------------------------ config, rope

@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v3"])
def test_config_from_hf_matches_jax(name):
    """Both copies of ModelConfig turn the published config.json dicts into
    equal dataclasses (head_dim 192 and rotary_dim 64 derived)."""
    hf = DEEPSEEK_V2_LITE if name == "deepseek_v2_lite" else DEEPSEEK_V3
    t, j = ModelConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert t.to_dict() == j.to_dict()
    assert (t.head_dim, t.rotary_dim, t.is_mla, t.moe_router) == (192, 64, True, "deepseek")
    k = t.first_k_dense_replace
    assert t.layer_is_moe(k) and not t.layer_is_moe(k - 1)


@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v3"])
def test_yarn_rope_tables_and_softmax_scale_match_jax(name):
    """The yarn tables at rotary_dim 64 (the published factor 40, beta 32 /
    1, mscale == mscale_all_dim) and the softmax scale with its mscale^2
    correction (V2-Lite: m = 0.1 * 0.707 * ln 40 + 1, scale * m^2)."""
    cfg = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE if name == "deepseek_v2_lite"
                                     else DEEPSEEK_V3)
    tc, ts = rope_table(4096, cfg.rotary_dim, cfg.rope_theta, cfg.rope_scaling, device="cpu")
    jc, js = jax_rope_table(4096, cfg.rotary_dim, cfg.rope_theta, cfg.rope_scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6, rtol=1e-6)
    assert mla_softmax_scale(cfg) == jax_scale(JaxConfig.from_hf_config(
        DEEPSEEK_V2_LITE if name == "deepseek_v2_lite" else DEEPSEEK_V3))
    m = 0.1 * dict(cfg.rope_scaling)["mscale_all_dim"] * np.log(40) + 1
    assert mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)


# ------------------------------------------------------ asymmetric writes

LAYERS, P, PAGE, DR, R = 2, 9, 32, 16, 64
BT = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # max_seq 128
#: (tokens per write, per-slot starts): single tokens take the decode write
#: kernel, chunks <= PAGE the chunk kernel (crossing a page at 28 + 8)
WRITES = {
    "decode": [(1, [0, 9]), (1, [31, 32]), (1, [32, 63])],
    "chunk": [(8, [28, 9]), (16, [40, 90]), (5, [63, 31])],
}


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", list(WRITES))
def test_latent_page_writes_match_jax_bytes(rng, monkeypatch, case, dtype):
    """MLA latent pages (one kv head, k plane 16 wide, v plane 64): the
    port's update leaves pages (codes) and scale tiles byte-equal to the
    JAX update through its Pallas write kernels in interpret mode, and the
    gathered (dequantized) planes equal at their own widths."""
    monkeypatch.setenv("QUICK_TPU_PAGED_WRITE", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = JCache.create(LAYERS, P, PAGE, max_slots=2, max_seq=128, n_kv=1, head_dim=DR,
                       dtype=jdt, v_head_dim=R)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(BT))
    tc = PagedKVCache.create(LAYERS, P, PAGE, 2, 128, 1, DR, tdt, device="cpu", v_head_dim=R)
    tc.block_table.copy_(torch.from_numpy(BT))
    assert tuple(tc.v_pages.shape) == tuple(jc.v_pages.shape) == (LAYERS, P, 1, PAGE, R)
    for S, starts in WRITES[case]:
        k = (rng.standard_normal((2, S, 1, DR)) * 3).astype(np.float32)
        v = rng.standard_normal((2, S, 1, R)).astype(np.float32)
        jc = jc.update(1, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                       jnp.asarray(starts, jnp.int32))
        tc = tc.update(1, torch.from_numpy(k).to(torch.bfloat16),
                       torch.from_numpy(v).to(torch.bfloat16), torch.tensor(starts, dtype=torch.int32))

    def host(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def jhost(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    # page 0 is the trash page: colliding junk writes land there in both
    for t, j in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        np.testing.assert_array_equal(host(t)[:, 1:], jhost(j)[:, 1:])
    if dtype == "int8":
        np.testing.assert_array_equal(tc.kv_scales.numpy()[:, 1:].view(np.uint32),
                                      np.asarray(jc.kv_scales)[:, 1:].view(np.uint32))
        assert tc.kv_scales[:, 1:, :2].abs().sum() > 0
    for a, b in zip(tc.layer(1), jc.layer(1)):
        np.testing.assert_array_equal(f32(a), f32(b))


# ------------------------------------------------ K10 / K10q plain version

@pytest.mark.parametrize("pages", ["float32", "int8", "bfloat16"])
def test_mla_paged_plain_matches_pallas(pages):
    """The plain version against the Pallas MLA kernel (interpret mode) on
    the same pages: lengths that end mid-page, a full last page and an
    empty slot (0 tokens -> 0). f32 pages exactly as f32 (rtol 2e-3 /
    atol 2e-4); INT8 pages (codes, scales folded into scores and p, p in
    bf16) rtol 2e-2 / atol 2e-3; bf16 pages and queries within one bf16
    step and p's rounding against a running max (2e-2)."""
    B, HQ, R2, DR2, page, n_pt = 4, 4, 64, 16, 8, 4
    rng = np.random.default_rng(11)
    jdt = {"float32": jnp.float32, "int8": jnp.int8, "bfloat16": jnp.bfloat16}[pages]
    cache = JCache.create(1, 17, page, max_slots=B, max_seq=page * n_pt, n_kv=1,
                          head_dim=DR2, dtype=jdt, v_head_dim=R2)
    bt = np.arange(1, 1 + B * n_pt, dtype=np.int32).reshape(B, n_pt)[:, ::-1].copy()
    cache = dataclasses.replace(cache, block_table=jnp.asarray(bt))
    lengths = np.asarray([13, 27, 0, 32], np.int32)
    kpe = rng.standard_normal((B, 32, 1, DR2)).astype(np.float32)
    c = rng.standard_normal((B, 32, 1, R2)).astype(np.float32)
    qdt = jnp.bfloat16 if pages == "bfloat16" else jnp.float32
    cache = cache.update(0, jnp.asarray(kpe, qdt), jnp.asarray(c, qdt), jnp.zeros((B,), jnp.int32))
    q_c = rng.standard_normal((B, HQ, R2)).astype(np.float32)
    q_pe = rng.standard_normal((B, HQ, DR2)).astype(np.float32)
    scale = (R2 + DR2) ** -0.5
    quant = pages == "int8"
    want = jax_mla_paged(jnp.asarray(q_c, qdt), jnp.asarray(q_pe, qdt), cache.k_pages,
                         cache.v_pages, jnp.asarray(bt), jnp.asarray(lengths), layer=0,
                         scale=scale, kv_scales=cache.kv_scales if quant else None,
                         interpret=True)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    tq = torch.bfloat16 if pages == "bfloat16" else torch.float32
    got = mla_paged_decode_attention_plain(
        torch.from_numpy(q_c).to(tq), torch.from_numpy(q_pe).to(tq), t(cache.k_pages),
        t(cache.v_pages), torch.from_numpy(bt), torch.from_numpy(lengths), 0, scale,
        t(cache.kv_scales) if quant else None)
    assert got.shape == (B, HQ, R2) and got.dtype == tq
    tol = {"float32": dict(rtol=2e-3, atol=2e-4), "int8": dict(rtol=2e-2, atol=2e-3),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}[pages]
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    assert not f32(got)[2].any()


# ------------------------------------------------- mla_attention_forward

def _mla_pair(cfg_kw, q_lora: bool, seed: int = 5):
    """MLAParams of both packages with the same bf16 float weights."""
    rng = np.random.default_rng(seed)
    D, hq, R_ = cfg_kw["hidden_size"], cfg_kw["num_attention_heads"], cfg_kw["kv_lora_rank"]
    dn, dr, dv = cfg_kw["qk_nope_head_dim"], cfg_kw["qk_rope_head_dim"], cfg_kw["v_head_dim"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    arrays = dict(kv_a_proj=w(D, R_ + dr), kv_b_proj=w(R_, hq * (dn + dv)), o_proj=w(hq * dv, D))
    norms = dict(kv_a_norm=(1 + 0.1 * rng.standard_normal(R_)).astype(np.float32))
    if q_lora:
        arrays.update(q_proj=w(D, 64), q_b_proj=w(64, hq * (dn + dr)))
        norms["q_a_norm"] = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    else:
        arrays["q_proj"] = w(D, hq * (dn + dr))
    jp = JaxMLA(**{k: JaxLinear(_bf16(a)[0]) for k, a in arrays.items()},
                **{k: _bf16(a)[0] for k, a in norms.items()})
    tp = MLAParams(**{k: Linear(_bf16(a)[1]) for k, a in arrays.items()},
                   **{k: _bf16(a)[1] for k, a in norms.items()})
    return jp, tp


BRANCHES = ["absorbed_dense_cache", "expanded_prefill", "paged_decode_bf16", "paged_decode_int8"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_mla_attention_forward_matches_jax(monkeypatch, branch):
    """Each branch on the same bf16 inputs: the absorbed MQA einsums (an
    8-token chunk, then a decode step, over the dense latent cache), the
    expanded prefill (40 tokens, no cache: causal attention at q / k 48,
    v 32), and the paged decode through K10's / K10q's plain version
    against the Pallas kernel (interpret mode) over bf16 and INT8 latent
    pages."""
    jcfg, tcfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jp, tp = _mla_pair(TINY, q_lora=branch == "paged_decode_int8")
    jcos, jsin = jax_rope_table(128, 16, 10000.0, jcfg.rope_scaling)
    tcos, tsin = rope_table(128, 16, 10000.0, tcfg.rope_scaling, device="cpu")
    rng = np.random.default_rng(9)
    B = 2

    def step(jc, tc, S, start):
        x = rng.standard_normal((B, S, 128)).astype(np.float32)
        xj, xt = _bf16(x)
        pos = np.broadcast_to(np.arange(start, start + S)[None], (B, S)).astype(np.int32)
        jo, jc = jax_mla_forward(jp, jcfg, xj, jcos, jsin, jc, 0, jnp.asarray(pos))
        to, tc = mla_attention_forward(tp, tcfg, xt, tcos, tsin, tc, 0,
                                       torch.from_numpy(pos).long())
        assert to.dtype == torch.bfloat16 and to.shape == (B, S, 128)
        np.testing.assert_allclose(f32(to), f32(jo), **TOL_BF16)
        return jc, tc

    if branch == "expanded_prefill":
        step(None, None, 40, 0)
        return
    if branch == "absorbed_dense_cache":
        jc = JaxKVCache(k=jnp.zeros((2, B, 1, 32, 16), jnp.bfloat16),
                        v=jnp.zeros((2, B, 1, 32, 64), jnp.bfloat16),
                        length=jnp.zeros((), jnp.int32))
        tc = make_mla_cache(tcfg, B, 32, device="cpu")
        assert isinstance(tc, KVCache) and tc.k.shape == (2, B, 1, 32, 16)
        jc, tc = step(jc, tc, 8, 0)
        jc, tc = jc.with_length(8), tc.with_length(8)
        step(jc, tc, 1, 8)
        return
    # paged decode: 11 tokens already cached per slot, then one step; the
    # port takes its kernel route (the plain version on the CPU)
    monkeypatch.setenv("QUICK_TPU_PAGED", "1")
    monkeypatch.setattr(tblocks, "_use_paged_kernel", lambda cache: True)
    quant = branch == "paged_decode_int8"
    jc = JCache.create(2, 9, 8, max_slots=B, max_seq=32, n_kv=1, head_dim=16,
                       dtype=jnp.int8 if quant else jnp.bfloat16, v_head_dim=64)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jc = dataclasses.replace(jc, block_table=jnp.asarray(bt))
    tc = PagedKVCache.create(2, 9, 8, B, 32, 1, 16, torch.int8 if quant else torch.bfloat16,
                             device="cpu", v_head_dim=64)
    tc.block_table.copy_(torch.from_numpy(bt))
    kpe = rng.standard_normal((B, 11, 1, 16)).astype(np.float32)
    c = rng.standard_normal((B, 11, 1, 64)).astype(np.float32)
    jc = jc.update(0, _bf16(kpe)[0], _bf16(c)[0], jnp.zeros((B,), jnp.int32))
    tc = tc.update(0, _bf16(kpe)[1], _bf16(c)[1], torch.zeros((B,), dtype=torch.int32))
    jc = jc.with_length(jnp.full((B,), 11, jnp.int32))
    tc = tc.with_length(torch.full((B,), 11, dtype=torch.int32))
    step(jc, tc, 1, 11)


# --------------------------------------------------------- deepseek router

ROUTERS = {  # config switches over a 16-expert MoE layer, top-4
    "v2_softmax": dict(model_type="deepseek_v2"),
    "v2_group_limited": dict(model_type="deepseek_v2", n_group=4, topk_group=2,
                             norm_topk_prob=True, routed_scaling_factor=16.0),
    "v3_sigmoid_bias": dict(model_type="deepseek_v3", scoring_func="sigmoid",
                            norm_topk_prob=True, routed_scaling_factor=2.5),
    "v3_sigmoid_bias_grouped": dict(model_type="deepseek_v3", scoring_func="sigmoid",
                                    n_group=4, topk_group=2, norm_topk_prob=True,
                                    routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("case", list(ROUTERS))
def test_deepseek_router_matches_jax(case):
    """moe_forward with the deepseek router (bf16 float experts, two
    ungated shared experts): the same selected experts as the JAX router,
    every routed token's least routing margin above GAP (a near-tie could
    pick other experts on the two packages' ulp-apart scores; the input
    seed is one without such a tie), and outputs within one bf16 step."""
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=4, num_local_experts=16,
              num_experts_per_tok=4, moe_intermediate_size=32, n_shared_experts=2,
              moe_router="deepseek", **dict(dict(norm_topk_prob=False), **ROUTERS[case]))
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(7)
    D, E, F, Fs = 64, 16, 32, 64

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    arrays = dict(router=w(D, E), gate_up_proj=w(E, D, 2 * F), down_proj=w(E, F, D),
                  shared_gate_up=w(D, 2 * Fs), shared_down=w(Fs, D))
    bias = None
    if tcfg.scoring_func == "sigmoid":
        bias = (0.3 * rng.standard_normal(E)).astype(np.float32)
    jp = JaxMoE(**{k: JaxLinear(_bf16(a)[0]) for k, a in arrays.items()},
                score_bias=None if bias is None else jnp.asarray(bias))
    tp = MoEParams(**{k: Linear(_bf16(a)[1]) for k, a in arrays.items()},
                   score_bias=None if bias is None else torch.from_numpy(bias))
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    xj, xt = _bf16(x)
    weights, sel = tblocks._deepseek_route(tp, tcfg, tp.router(xt.to(torch.float32)))
    assert least_route_gap(tp, tcfg, xt) > GAP
    # JAX's selection, rebuilt from its combine weights
    logits = jnp.asarray(tp.router(xt.to(torch.float32)).numpy())
    jsel = _jax_selection(jp, jcfg, logits)
    np.testing.assert_array_equal(np.sort(sel.numpy(), -1), np.sort(jsel, -1))
    want = jax_moe_forward(jp, jcfg, xj)
    got = tblocks.moe_forward(tp, tcfg, xt)
    np.testing.assert_allclose(f32(got), f32(want), **TOL_BF16)
    assert float(weights.min()) > 0


def _jax_selection(jp, jcfg, logits):
    """The JAX router's selected experts (moe_forward :606-629), computed
    with its own ops on the port's router logits."""
    scores = (jax.nn.sigmoid(logits) if jcfg.scoring_func == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    choice = scores if jp.score_bias is None else scores + jp.score_bias
    B, S, E = logits.shape
    ng, tg = jcfg.n_group, jcfg.topk_group
    if ng and tg and tg < ng:
        gsc = choice.reshape(B, S, ng, E // ng)
        gscore = (jax.lax.top_k(gsc, 2)[0].sum(-1) if jp.score_bias is not None
                  else gsc.max(-1))
        _, gsel = jax.lax.top_k(gscore, tg)
        gmask = jnp.sum(jax.nn.one_hot(gsel, ng, dtype=jnp.bool_), axis=2)
        choice = jnp.where(gmask[..., None], gsc, -jnp.inf).reshape(B, S, E)
    return np.asarray(jax.lax.top_k(choice, jcfg.num_experts_per_tok)[1])
