"""Port parity for gemma, gemma2 and gemma3 (``quick_tpu_torch``): tiny
checkpoints in each family's HF layout, written here with numpy as
tests/test_hf_importers.py writes them (gemma3 also in its multimodal
layout, with a vision tower that must be dropped), imported by both
packages: the same config, every tensor byte-equal (the +1 fold of the
zero-centered norms in the file's own dtype), the same rope tables and
gemma3's local ones; prefill and decode logits over the dense cache and
bf16 pages with the sliding window binding (window 8, 32-token caches);
greedy generate(); the QTPU checkpoint both ways keeping the post-norms
and rebuilding the local tables; one gemma2 block's AWQ search and a whole
gemma3 model's quantize(calib) against the eager JAX search; and the port's
gelu bit for bit against ``jax.nn.gelu``.

The JAX package runs eagerly (``jax.disable_jit``), as in
tests/test_torch_qk_norm.py."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _awq_parity import assert_close, assert_params_equal, check_searches, recorded, to_torch
from _torch_port import f32
from safetensors.numpy import save_file

import quick_tpu.quantize.awq as jawq
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.quantize.awq as tawq
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_quant_params as jax_init_quant, model_forward as jax_forward
from quick_tpu.models.auto import AutoQuickModel as JaxAuto
from quick_tpu.modules.paged_cache import PagedKVCache as JPaged
from quick_tpu.runtime import generate as jax_generate, make_cache as jax_cache
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.blocks import gelu
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.runtime import generate, make_cache
from quick_tpu_torch.utils.checkpoint import load_hf_float, load_quantized, save_quantized

D, H, HD, L, V, F = 64, 4, 16, 2, 128, 128
WINDOW = 8
#: logits of the bf16 models, as tests/test_torch_model.py
TOL = dict(atol=3e-2, rtol=3e-2)
B, PROMPT, STEPS, MAX_SEQ = 2, 10, 3, 32
TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # 8-token pages


def _rng(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return lambda *shape: (r.standard_normal(shape) * 0.05).astype(dtype)


def _gemma_layers(w, prefix="", hkv=2, sandwich=False, qk_norm=False):
    """The gemma layer tensors, norms zero-centered (stored w - 1: 0.1 N(0,
    1) around 0), under ``prefix``."""
    t = {}
    for i in range(L):
        p = f"{prefix}model.layers.{i}"
        norms = ["input_layernorm", "post_attention_layernorm"]
        if sandwich:
            norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
        for n in norms:
            t[f"{p}.{n}.weight"] = 2 * w(D)
        for n, o in (("q_proj", H * HD), ("k_proj", hkv * HD), ("v_proj", hkv * HD)):
            t[f"{p}.self_attn.{n}.weight"] = w(o, D)
        t[f"{p}.self_attn.o_proj.weight"] = w(D, H * HD)
        if qk_norm:
            t[f"{p}.self_attn.q_norm.weight"] = 4 * w(HD)
            t[f"{p}.self_attn.k_norm.weight"] = 4 * w(HD)
        t[f"{p}.mlp.gate_proj.weight"] = w(F, D)
        t[f"{p}.mlp.up_proj.weight"] = w(F, D)
        t[f"{p}.mlp.down_proj.weight"] = w(D, F)
    t[f"{prefix}model.embed_tokens.weight"] = 10 * w(V, D)
    t[f"{prefix}model.norm.weight"] = 2 * w(D)
    return t


def _base(model_type, **kw):
    return {**dict(model_type=model_type, hidden_size=D, num_attention_heads=H,
                   num_hidden_layers=L, vocab_size=V, intermediate_size=F, head_dim=HD,
                   max_position_embeddings=64, rms_norm_eps=1e-6), **kw}


def _gemma(seed):
    return _base("gemma", num_key_value_heads=1), _gemma_layers(_rng(seed), hkv=1)


def _gemma2(seed):
    """float16 tensors: the +1 fold runs in the file's dtype, then the cast."""
    cfg = _base("gemma2", num_key_value_heads=2, query_pre_attn_scalar=24,
                attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                sliding_window=WINDOW)
    return cfg, _gemma_layers(_rng(seed, np.float16), sandwich=True)


def _gemma3_text(seed):
    return (_base("gemma3_text", num_key_value_heads=2, query_pre_attn_scalar=HD,
                  sliding_window=WINDOW, sliding_window_pattern=2, rope_theta=1e6,
                  rope_local_base_freq=1e4, rope_scaling={"rope_type": "linear", "factor": 8.0}),
            _gemma_layers(_rng(seed), sandwich=True, qk_norm=True))


def _gemma3(seed):
    """The multimodal layout: the language tower under language_model., a
    vision tower and projector the importers drop."""
    text, _ = _gemma3_text(seed)
    w = _rng(seed)
    t = _gemma_layers(w, prefix="language_model.", sandwich=True, qk_norm=True)
    t["vision_tower.vision_model.embeddings.patch_embedding.weight"] = w(8, 3, 4, 4)
    t["multi_modal_projector.mm_input_projection_weight"] = w(8, D)
    return {"model_type": "gemma3", "text_config": text, "vision_config": {"hidden_size": 8}}, t


FAMILIES = {"gemma": _gemma, "gemma2": _gemma2, "gemma3_text": _gemma3_text, "gemma3": _gemma3}


def _write(d, cfg, tensors) -> str:
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Each family's checkpoint imported by both packages (float, bf16):
    {family: (jax params, jax config, port params, port config)}."""
    out = {}
    for name, make in FAMILIES.items():
        cfg, tensors = make(sum(map(ord, name)))
        path = _write(tmp_path_factory.mktemp(name), cfg, tensors)
        jp, jc = jck.load_hf_float(path)
        tp, tc = load_hf_float(path, device="cpu")
        out[name] = (jp, jc, tp, tc)
    return out


def _bytes(a) -> bytes:
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_matches_jax(imported, family):
    """load_hf_float in both packages: equal configs, the same flat keys in
    the same order, every tensor byte-equal (the folded norms included),
    equal rope tables and local tables; a norm weight stored w - 1 imports
    as w."""
    jp, jc, tp, tc = imported[family]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jflat, tflat = jck.params_to_flat(jp), params_to_flat(tp)
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.asarray(a).shape == b.shape and _bytes(a) == b.tobytes(), k
    for name in ("rope_cos", "rope_sin", "rope_cos_local", "rope_sin_local"):
        j, t = getattr(jp, name), getattr(tp, name)
        assert (j is None) == (t is None), name
        if t is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    # the fold: 1 + (w - 1) with |w - 1| ~ 0.1
    assert abs(float(f32(tp.final_norm).mean()) - 1.0) < 0.05
    if family.startswith("gemma3"):
        assert tc.model_type == "gemma3" and tc.rope_local_theta == 1e4
        assert abs(float(f32(tp.blocks[0].attn.q_norm).mean()) - 1.0) < 0.1
        assert float((tp.rope_cos_local - tp.rope_cos).abs().max()) > 1e-3
    if family != "gemma":
        assert tp.blocks[1].mlp_post_norm is not None and tc.use_post_norms


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _caches(jcfg, tcfg, paged: bool):
    hkv = tcfg.num_key_value_heads
    if paged:
        jc = JPaged.create(L, 9, 8, max_slots=B, max_seq=MAX_SEQ, n_kv=hkv, head_dim=HD,
                           dtype=jnp.bfloat16)
        jc = dataclasses.replace(jc, block_table=jnp.asarray(TABLE))
        tc = PagedKVCache.create(L, 9, 8, B, MAX_SEQ, hkv, HD, torch.bfloat16, device="cpu")
        tc.block_table.copy_(torch.from_numpy(TABLE))
        return jc, tc
    return jax_cache(jcfg, B, MAX_SEQ), make_cache(tcfg, B, MAX_SEQ, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", ["gemma", "gemma2", "gemma3"])
def test_logits_match_eager_jax(imported, family, paged):
    """A 10-token prefill and 3 decode steps over a 32-token cache, where
    the window of 8 binds on the sliding layer 0 (gemma2 and gemma3; layer
    1 is global): the port's logits within the model tolerance of
    quick_tpu's at every step."""
    jp, jcfg, tp, tcfg = imported[family]
    if family != "gemma":
        assert tcfg.layer_is_sliding(0) and not tcfg.layer_is_sliding(1)
    toks = _tokens(PROMPT + STEPS, 2)
    jc, tc = _caches(jcfg, tcfg, paged)
    for lo, hi in [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT, PROMPT + STEPS)]:
        with jax.disable_jit():
            jl, jc = jax_forward(jp, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tp, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    if family == "gemma2":
        assert float(tl.abs().max()) <= 30.0  # the final softcap
    if family != "gemma" and not paged:
        # the window is live, and gemma3's local tables
        full, _ = model_forward(tp, tcfg, torch.from_numpy(toks).long())
        others = [(tp, dataclasses.replace(tcfg, sliding_window=None))]
        if family == "gemma3":
            others.append((dataclasses.replace(tp, rope_cos_local=None, rope_sin_local=None), tcfg))
        for p2, c2 in others:
            off, _ = model_forward(p2, c2, torch.from_numpy(toks).long())
            assert float((off[:, -1] - full[:, -1]).abs().max()) > 3 * TOL["atol"]


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_greedy_generate_matches_eager_jax(imported, family):
    """generate(): the same greedy tokens as quick_tpu's, in a 16-token
    cache past the window."""
    jp, jcfg, tp, tcfg = imported[family]
    toks = _tokens(8, 3)
    with jax.disable_jit():
        ref = np.asarray(jax_generate(jp, jcfg, jnp.asarray(toks), 5, max_seq=16))
    out = generate(tp, tcfg, torch.from_numpy(toks), 5, max_seq=16)
    np.testing.assert_array_equal(out.numpy(), ref)


def _random_norms(flat: dict, cfg, seed: int) -> dict:
    """Every norm of a flat dict at 1 + 0.1 N(0, 1) (bf16)."""
    rng = np.random.default_rng(seed)
    for k in list(flat):
        if k.endswith(("norm", "q_norm", "k_norm")):
            v = 1.0 + 0.1 * rng.standard_normal(np.asarray(flat[k]).shape)
            flat[k] = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return flat


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_qtpu_checkpoint_keeps_post_norms(imported, family, tmp_path):
    """A quantized QTPU checkpoint with post-norms loads in either package
    with every tensor byte-equal, the post-norms kept and gemma3's local
    tables rebuilt from the config."""
    _, _, _, tcfg = imported[family]
    jcfg = JaxConfig(**dataclasses.asdict(tcfg))
    flat = _random_norms(jck.params_to_flat(jax_init_quant(jcfg, jax.random.PRNGKey(0))), tcfg, 1)
    jparams = jck.flat_to_params(flat, jcfg)
    tparams = params_from_flat(flat, tcfg, device="cpu")
    save_quantized(tparams, tcfg, QuantConfig(), str(tmp_path / "port"))
    jp, jc, _ = jck.load_quantized(str(tmp_path / "port"))
    assert jp.blocks[1].mlp_post_norm is not None
    assert_params_equal(tparams, jp)
    jck.save_quantized(jparams, jcfg, JaxQuantConfig(), str(tmp_path / "jax"))
    tp, tc, _ = load_quantized(str(tmp_path / "jax"), device="cpu")
    assert tc == tcfg
    assert_params_equal(tp, jparams)
    assert "blocks.1.attn_post_norm" in params_to_flat(tp)
    if family == "gemma3":
        np.testing.assert_allclose(f32(tp.rope_cos_local), f32(jparams.rope_cos_local), atol=1e-6)
    else:
        assert tp.rope_cos_local is None


AWQ_G = 32
CALIB = (2, 16)  # 16 tokens: the window of 8 binds in the loss forwards


def _awq_pair(family, seed):
    """A 2-layer float model of the family from quick_tpu (random norms),
    carried to the port: (jax params, jax config, port params, port config)."""
    from quick_tpu.models import init_float_params as jax_init_float

    kw = dict(vocab_size=V, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=32,
              max_position_embeddings=64, rms_norm_eps=1e-6, sliding_window=WINDOW)
    if family == "gemma2":
        kw.update(model_type="gemma2", act_fn="gelu", embed_scale=True, use_post_norms=True,
                  tie_word_embeddings=True, query_pre_attn_scalar=48.0, attn_logit_softcap=50.0,
                  final_logit_softcap=30.0, sliding_window_pattern=2)
    else:
        kw.update(model_type="gemma3", act_fn="gelu", embed_scale=True, use_post_norms=True,
                  use_qk_norm=True, tie_word_embeddings=True, query_pre_attn_scalar=32.0,
                  sliding_window_pattern=2, rope_theta=1e6, rope_local_theta=1e4)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    flat = _random_norms(jck.params_to_flat(jax_init_float(jcfg, jax.random.PRNGKey(seed))),
                         tcfg, seed + 1)
    return jck.flat_to_params(flat, jcfg), jcfg, params_from_flat(flat, tcfg, device="cpu"), tcfg


def test_awq_gemma2_block_matches_eager_jax(monkeypatch):
    """One gemma2 block (a sliding layer with the window binding, softcap,
    query_pre_attn_scalar, GeGLU, post-norms) from the same input: every
    search by ``_awq_parity.check_searches``' rule; with the JAX grid
    choices imposed, every packed code, scale and norm byte-equal, the
    post-norms carried, and x_next within one bf16 step."""
    jparams, jcfg, tparams, tcfg = _awq_pair("gemma2", 4)
    calib = np.random.default_rng(6).integers(0, V, CALIB).astype(np.int32)
    x = jparams.embed[jnp.asarray(calib)].astype(jnp.bfloat16) * jnp.asarray(
        128 ** 0.5).astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(CALIB[1])[None], CALIB)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            ref = jawq.awq_quantize_block(jparams.blocks[0], jcfg, x, pos, jparams.rope_cos,
                                          jparams.rope_sin, JaxQuantConfig(q_group_size=AWQ_G),
                                          sliding=True)
        out = tawq.awq_quantize_block(tparams.blocks[0], tcfg, to_torch(x),
                                      torch.from_numpy(np.array(pos)), tparams.rope_cos,
                                      tparams.rope_sin, QuantConfig(q_group_size=AWQ_G),
                                      sliding=True)
    assert [r[0] for r in prec] == ["scale", "clip", "clip", "scale", "scale", "clip", "clip"]
    check_searches(jrec, prec)
    assert_close(out.x_next, ref.x_next, 2.0 ** -7, "x_next")
    assert torch.equal(out.block.mlp_post_norm, tparams.blocks[0].mlp_post_norm)
    assert_params_equal(out.block, ref.block)


def test_awq_gemma3_model_matches_eager_jax(monkeypatch):
    """quantize(calib) on a 2-layer gemma3 (the sqrt(D) embedding scale on
    the calibration input, the local tables on the sliding layer 0, the
    global ones on layer 1) against the eager JAX package: every search by
    the rule; with its grid choices imposed, equal flat dicts."""
    jparams, jcfg, tparams, tcfg = _awq_pair("gemma3", 8)
    jm, tm = JaxAuto(jparams, jcfg), AutoQuickModel(tparams, tcfg)
    calib = np.random.default_rng(9).integers(0, V, CALIB).astype(np.int32)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            jm.quantize(jnp.asarray(calib), JaxQuantConfig(q_group_size=AWQ_G), verbose=False)
        tm.quantize(calib, QuantConfig(q_group_size=AWQ_G), verbose=False)
    assert len(prec) == 14
    check_searches(jrec, prec)
    jflat, tflat = jck.params_to_flat(jm.params), params_to_flat(tm.params)
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        assert torch.equal(tflat[k], to_torch(a)), k


def test_gelu_matches_jax_bit_for_bit():
    """The port's gelu against ``jax.nn.gelu`` (eager, bf16) on every bf16
    value with 2^-100 <= |x| < 64, and 0: equal bits. (Below that range
    XLA on the CPU flushes subnormal intermediates to zero, which PyTorch
    does not.) ``F.gelu(approximate="tanh")``, which rounds once, differs
    on some of them."""
    u = np.arange(2 ** 16, dtype=np.uint32).astype(np.uint16).view(np.int16)
    t = torch.from_numpy(u).view(torch.bfloat16)
    a = t.to(torch.float32).abs()
    t = t[torch.isfinite(t) & (a < 64) & ((a >= 2.0 ** -100) | (a == 0))]
    with jax.disable_jit():
        ref = jax.nn.gelu(jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16)))
    ref = np.asarray(ref).view(np.int16)
    out = gelu(t).view(torch.int16).numpy()
    assert len(out) > 20000 and np.array_equal(out, ref)
    once = torch.nn.functional.gelu(t, approximate="tanh").view(torch.int16).numpy()
    assert not np.array_equal(once, ref)
