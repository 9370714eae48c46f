"""Port parity for olmo2, granite and minicpm (``quick_tpu_torch``), the
RMSNorm families that run on gemma's switches: olmo2's post-norms without
pre-norms and its full-width q / k RMSNorm, granite's four multipliers
(embedding, residual, attention through ``query_pre_attn_scalar``, logits)
and minicpm's mup ones. Tiny checkpoints in each family's HF layout,
written with numpy as tests/test_hf_importers.py writes them, imported by
both packages: equal configs, every tensor byte-equal, and the logits of a
prefill and decode steps over the dense cache and bf16 pages against the
eager JAX forward; the config translations at the published models'
values; one olmo2 block's AWQ search (unit qkv and gate_up scales) and one
granite block's against the eager JAX search."""
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
from quick_tpu.models import init_float_params as jax_init_float, model_forward as jax_forward
from quick_tpu.modules.paged_cache import PagedKVCache as JPaged
from quick_tpu.runtime import make_cache as jax_cache
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import MODEL_TYPE_MAP, apply_model_type
from quick_tpu_torch.models.convert import params_from_flat, params_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.runtime import make_cache
from quick_tpu_torch.utils.checkpoint import load_hf_float

D, H, HD, L, V, F = 64, 4, 16, 2, 128, 128
#: logits of the bf16 models, as tests/test_torch_model.py
TOL = dict(atol=3e-2, rtol=3e-2)
B, PROMPT, STEPS, MAX_SEQ = 2, 10, 3, 32
TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # 8-token pages


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *shape: (r.standard_normal(shape) * 0.05).astype(np.float32)


def _layers(w, olmo2=False):
    """The llama tree's layer tensors, or olmo2's: post-norms only and
    full-width q / k norms."""
    t = {}
    for i in range(L):
        p = f"model.layers.{i}"
        if olmo2:
            t[f"{p}.post_attention_layernorm.weight"] = 1 + 2 * w(D)
            t[f"{p}.post_feedforward_layernorm.weight"] = 1 + 2 * w(D)
            t[f"{p}.self_attn.q_norm.weight"] = 1 + 2 * w(H * HD)
            t[f"{p}.self_attn.k_norm.weight"] = 1 + 2 * w(2 * HD)
        else:
            t[f"{p}.input_layernorm.weight"] = 1 + 2 * w(D)
            t[f"{p}.post_attention_layernorm.weight"] = 1 + 2 * w(D)
        for n, o in (("q_proj", H * HD), ("k_proj", 2 * HD), ("v_proj", 2 * HD)):
            t[f"{p}.self_attn.{n}.weight"] = w(o, D)
        t[f"{p}.self_attn.o_proj.weight"] = w(D, H * HD)
        t[f"{p}.mlp.gate_proj.weight"] = w(F, D)
        t[f"{p}.mlp.up_proj.weight"] = w(F, D)
        t[f"{p}.mlp.down_proj.weight"] = w(D, F)
    t["model.embed_tokens.weight"] = 4 * w(V, D)
    t["model.norm.weight"] = 1 + 2 * w(D)
    return t


def _base(model_type, **kw):
    return {**dict(model_type=model_type, hidden_size=D, num_attention_heads=H,
                   num_key_value_heads=2, num_hidden_layers=L, vocab_size=V,
                   intermediate_size=F, max_position_embeddings=64, rms_norm_eps=1e-5), **kw}


def _olmo2(w):
    t = _layers(w, olmo2=True)
    t["lm_head.weight"] = w(V, D)
    return _base("olmo2", rope_theta=5e5, tie_word_embeddings=False), t


def _granite(w):
    # Granite-3.1's embedding and residual multipliers; logits_scaling 1
    # (a tied head's logits stay small) and an attention multiplier of 4
    # (16 times the default 16^-0.5: the small random q and k would
    # otherwise attend almost uniformly under either scale)
    return _base("granite", embedding_multiplier=12.0, residual_multiplier=0.22,
                 attention_multiplier=4.0, logits_scaling=1.0, rope_theta=1e7), _layers(w)


def _minicpm(w):
    # scale_depth 0.5: a residual multiplier of 0.35 at 2 layers (MiniCPM-2B's
    # 1.4 would give 0.99)
    return _base("minicpm", scale_emb=12.0, scale_depth=0.5, dim_model_base=32), _layers(w)


FAMILIES = {"olmo2": _olmo2, "granite": _granite, "minicpm": _minicpm}


def _write(d, cfg, tensors) -> str:
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    out = {}
    for name, make in FAMILIES.items():
        cfg, tensors = make(_rng(sum(map(ord, name))))
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
    the same order, every tensor byte-equal; olmo2 with no pre-norms and
    full-width q / k norms."""
    jp, jc, tp, tc = imported[family]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert apply_model_type(tc) == tc and family in MODEL_TYPE_MAP
    jflat, tflat = jck.params_to_flat(jp), params_to_flat(tp)
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.asarray(a).shape == b.shape and _bytes(a) == b.tobytes(), k
    if family == "olmo2":
        blk = tp.blocks[0]
        assert blk.attn_norm is None and blk.mlp_norm is None
        assert blk.attn.q_norm.shape == (H * HD,) and blk.attn.k_norm.shape == (2 * HD,)
        assert "blocks.0.attn_norm" not in tflat and not tc.pre_norms


def _caches(jcfg, tcfg, paged: bool):
    if paged:
        jc = JPaged.create(L, 9, 8, max_slots=B, max_seq=MAX_SEQ, n_kv=2, head_dim=HD,
                           dtype=jnp.bfloat16)
        jc = dataclasses.replace(jc, block_table=jnp.asarray(TABLE))
        tc = PagedKVCache.create(L, 9, 8, B, MAX_SEQ, 2, HD, torch.bfloat16, device="cpu")
        tc.block_table.copy_(torch.from_numpy(TABLE))
        return jc, tc
    return jax_cache(jcfg, B, MAX_SEQ), make_cache(tcfg, B, MAX_SEQ, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_eager_jax(imported, family, paged):
    """A 10-token prefill and 3 decode steps: the port's logits within the
    model tolerance of quick_tpu's at every step; each family's switches
    move the logits (they are live)."""
    jp, jcfg, tp, tcfg = imported[family]
    toks = np.random.default_rng(2).integers(0, V, (B, PROMPT + STEPS)).astype(np.int32)
    jc, tc = _caches(jcfg, tcfg, paged)
    for lo, hi in [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT, PROMPT + STEPS)]:
        with jax.disable_jit():
            jl, jc = jax_forward(jp, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tl, tc = model_forward(tp, tcfg, torch.from_numpy(toks[:, lo:hi]).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    if paged:
        return
    full, _ = model_forward(tp, tcfg, torch.from_numpy(toks).long())
    switches = {"olmo2": dict(use_qk_norm=False),
                "granite": dict(embed_multiplier=None, residual_multiplier=None,
                                query_pre_attn_scalar=None),
                "minicpm": dict(residual_multiplier=None, logit_scale=None)}[family]
    for k, v in switches.items():
        off, _ = model_forward(tp, dataclasses.replace(tcfg, **{k: v}),
                               torch.from_numpy(toks).long())
        assert float((off - full).abs().max()) > 3 * TOL["atol"], k


#: the published configs' multipliers (Granite-3.1-8B-base, MiniCPM-2B-sft)
TRANSLATIONS = {
    "granite": (dict(model_type="granite", vocab_size=49155, hidden_size=4096,
                     intermediate_size=12800, num_hidden_layers=40, num_attention_heads=32,
                     num_key_value_heads=8, embedding_multiplier=12.0, residual_multiplier=0.22,
                     attention_multiplier=0.0078125, logits_scaling=16.0, rope_theta=1e7),
                dict(embed_multiplier=12.0, residual_multiplier=0.22, logit_scale=1 / 16.0,
                     query_pre_attn_scalar=0.0078125 ** -2, tie_word_embeddings=True)),
    "minicpm": (dict(model_type="minicpm", vocab_size=122753, hidden_size=2304,
                     intermediate_size=5760, num_hidden_layers=40, num_attention_heads=36,
                     num_key_value_heads=36, scale_emb=12, scale_depth=1.4, dim_model_base=256,
                     rms_norm_eps=1e-5),
                dict(embed_multiplier=12, residual_multiplier=1.4 / 40 ** 0.5,
                     logit_scale=256 / 2304, tie_word_embeddings=True, head_dim=64)),
}


@pytest.mark.parametrize("family", list(TRANSLATIONS))
def test_config_translation_matches_jax(family):
    """from_hf_config at the published models' values: the port's config is
    the JAX package's, with granite's attention_multiplier as
    query_pre_attn_scalar = am^-2, logits_scaling as 1 / logit_scale and
    minicpm's scale_depth / sqrt(L) and dim_model_base / D."""
    hf, want = TRANSLATIONS[family]
    tc, jc = ModelConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for k, v in want.items():
        assert getattr(tc, k) == pytest.approx(v, rel=1e-12), k


AWQ_G = 32
CALIB = (2, 16)


def _awq_block_pair(family, seed):
    kw = dict(vocab_size=V, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=4, head_dim=32,
              max_position_embeddings=64, rms_norm_eps=1e-6, model_type=family,
              **MODEL_TYPE_MAP[family])
    if family == "granite":
        kw.update(num_key_value_heads=2, embed_multiplier=12.0, residual_multiplier=0.22,
                  query_pre_attn_scalar=0.125 ** -2, logit_scale=1 / 16.0)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    flat = jck.params_to_flat(jax_init_float(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in list(flat):
        if k.endswith("norm"):
            v = 1.0 + 0.2 * rng.standard_normal(np.asarray(flat[k]).shape)
            flat[k] = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return jck.flat_to_params(flat, jcfg), jcfg, params_from_flat(flat, tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("family,searches", [
    # olmo2, MHA: no norm before qkv or gate_up, so no scale search for
    # them (unit scales); the o and down groups and every clip search run
    ("olmo2", ["scale", "clip", "clip", "scale", "clip", "clip"]),
    # granite, GQA: the residual multiplier on both sub-layer outputs and
    # the attention multiplier in the qkv loss forward
    ("granite", ["scale", "clip", "clip", "scale", "scale", "clip", "clip"]),
])
def test_awq_block_matches_eager_jax(monkeypatch, family, searches):
    """One block from the same input: the searches the family makes, each
    by ``_awq_parity.check_searches``' rule; with the JAX grid choices
    imposed, every packed code, scale and norm byte-equal (olmo2's post and
    full-width q / k norms carried), x_next within one bf16 step."""
    jparams, jcfg, tparams, tcfg = _awq_block_pair(family, 11)
    calib = np.random.default_rng(12).integers(0, V, CALIB).astype(np.int32)
    x = jparams.embed[jnp.asarray(calib)].astype(jnp.bfloat16) * 4
    pos = jnp.broadcast_to(jnp.arange(CALIB[1])[None], CALIB)
    with recorded(monkeypatch, impose=True) as (jrec, prec):
        with jax.disable_jit():
            ref = jawq.awq_quantize_block(jparams.blocks[0], jcfg, x, pos, jparams.rope_cos,
                                          jparams.rope_sin, JaxQuantConfig(q_group_size=AWQ_G))
        out = tawq.awq_quantize_block(tparams.blocks[0], tcfg, to_torch(x),
                                      torch.from_numpy(np.array(pos)), tparams.rope_cos,
                                      tparams.rope_sin, QuantConfig(q_group_size=AWQ_G))
    assert [r[0] for r in prec] == searches
    check_searches(jrec, prec)
    assert_close(out.x_next, ref.x_next, 2.0 ** -7, "x_next")
    if family == "olmo2":
        assert out.block.attn_norm is None and out.block.mlp_norm is None
        assert torch.equal(out.block.attn.q_norm, tparams.blocks[0].attn.q_norm)
    assert_params_equal(out.block, ref.block)
