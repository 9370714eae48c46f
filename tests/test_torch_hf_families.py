"""Port parity for the HF schema importers of the llama-path families
(``quick_tpu_torch/utils/checkpoint.py``): qwen2 with biases, qwen v1,
baichuan 7B, Baichuan2's NormHead, phi3 with longrope, internlm2's grouped
wqkv, llava's language tower, qwen3 and qwen3_moe, and the generic llama
fallback for an unmapped type. Each test writes a tiny checkpoint in the
family's HF layout with numpy (as tests/test_hf_importers.py writes them)
and imports it in both packages: the same config, every tensor byte-equal,
the same rope tables, and the same logits (the JAX forward eager). Then the
refusals: AutoAWQ files of exactly the types the JAX package refuses, and
the families the port does not run yet (ROADMAP A12)."""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import f32
from safetensors.numpy import save_file

import quick_tpu.utils.checkpoint as jck
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.models.auto import AutoQuickModel as JaxAuto
from quick_tpu_torch import QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel, apply_model_type
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.utils.checkpoint import load_autoawq, load_hf_float

D, H, HD, L, V, F = 64, 4, 16, 2, 128, 128
#: logits of the bf16 float models, as tests/test_torch_model.py
TOL = dict(atol=3e-2, rtol=3e-2)


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *shape: (r.standard_normal(shape) * 0.05).astype(np.float32)


def _ones(n):
    return np.ones(n, np.float32)


def _llama_layers(w, prefix="", hkv=2, bias=False, qk_norm=False, moe=None):
    """The llama schema's layer tensors (q / k / v / o, gate / up / down or
    qwen3_moe's experts), under ``prefix``."""
    t = {}
    for i in range(L):
        p = f"{prefix}model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = 1 + w(D)
        t[f"{p}.post_attention_layernorm.weight"] = 1 + w(D)
        for n, o in (("q_proj", H * HD), ("k_proj", hkv * HD), ("v_proj", hkv * HD)):
            t[f"{p}.self_attn.{n}.weight"] = w(o, D)
            if bias:
                t[f"{p}.self_attn.{n}.bias"] = w(o)
        t[f"{p}.self_attn.o_proj.weight"] = w(D, H * HD)
        if qk_norm:
            t[f"{p}.self_attn.q_norm.weight"] = 1 + 3 * w(HD)
            t[f"{p}.self_attn.k_norm.weight"] = 1 + 3 * w(HD)
        if moe:
            E, Fe = moe
            t[f"{p}.mlp.gate.weight"] = w(E, D)
            for e in range(E):
                t[f"{p}.mlp.experts.{e}.gate_proj.weight"] = w(Fe, D)
                t[f"{p}.mlp.experts.{e}.up_proj.weight"] = w(Fe, D)
                t[f"{p}.mlp.experts.{e}.down_proj.weight"] = w(D, Fe)
        else:
            t[f"{p}.mlp.gate_proj.weight"] = w(F, D)
            t[f"{p}.mlp.up_proj.weight"] = w(F, D)
            t[f"{p}.mlp.down_proj.weight"] = w(D, F)
    return t


def _base_cfg(model_type, **kw):
    return {**dict(model_type=model_type, hidden_size=D, num_attention_heads=H,
                   num_hidden_layers=L, vocab_size=V, intermediate_size=F,
                   max_position_embeddings=64, rms_norm_eps=1e-6), **kw}


def _qwen2(w):
    t = _llama_layers(w, bias=True)
    t.update({"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
              "lm_head.weight": w(V, D)})
    return _base_cfg("qwen2", num_key_value_heads=2), t


def _qwen(w):
    t = {"transformer.wte.weight": w(V, D), "transformer.ln_f.weight": 1 + w(D),
         "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"transformer.h.{i}"
        t.update({f"{p}.ln_1.weight": 1 + w(D), f"{p}.ln_2.weight": 1 + w(D),
                  f"{p}.attn.c_attn.weight": w(3 * D, D), f"{p}.attn.c_attn.bias": w(3 * D),
                  f"{p}.attn.c_proj.weight": w(D, D), f"{p}.mlp.w1.weight": w(F, D),
                  f"{p}.mlp.w2.weight": w(F, D), f"{p}.mlp.c_proj.weight": w(D, F)})
    # HF Qwen-1 halves intermediate_size in code; kv_channels is its head_dim
    return _base_cfg("qwen", intermediate_size=2 * F, kv_channels=HD), t


def _baichuan_tensors(w, vocab, d, layers=L, ffn=F):
    t = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": 1 + w(d),
         "lm_head.weight": w(vocab, d) * 3.0}
    for i in range(layers):
        p = f"model.layers.{i}"
        t.update({f"{p}.input_layernorm.weight": 1 + w(d),
                  f"{p}.post_attention_layernorm.weight": 1 + w(d),
                  f"{p}.self_attn.W_pack.weight": w(3 * d, d),
                  f"{p}.self_attn.o_proj.weight": w(d, d),
                  f"{p}.mlp.gate_proj.weight": w(ffn, d), f"{p}.mlp.up_proj.weight": w(ffn, d),
                  f"{p}.mlp.down_proj.weight": w(d, ffn)})
    return t


def _baichuan(w):
    # no num_key_value_heads: MHA
    return _base_cfg("baichuan"), _baichuan_tensors(w, V, D)


def _baichuan2_normhead(w):
    """Baichuan2's vocabulary (125696): the head's rows L2-normalized at
    import; one narrow layer."""
    cfg = dict(model_type="baichuan", hidden_size=32, num_attention_heads=2, num_hidden_layers=1,
               vocab_size=125696, intermediate_size=64, max_position_embeddings=32)
    return cfg, _baichuan_tensors(w, 125696, 32, layers=1, ffn=64)


def _phi3(w):
    t = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
         "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}"
        t.update({f"{p}.input_layernorm.weight": 1 + w(D),
                  f"{p}.post_attention_layernorm.weight": 1 + w(D),
                  f"{p}.self_attn.qkv_proj.weight": w((H + 4) * HD, D),
                  f"{p}.self_attn.o_proj.weight": w(D, H * HD),
                  f"{p}.mlp.gate_up_proj.weight": w(2 * F, D),
                  f"{p}.mlp.down_proj.weight": w(D, F)})
    # half the head rotary (rotary_dim 8): the factors cover its 4 frequencies
    rs = {"rope_type": "longrope", "short_factor": [1.0 + 0.1 * j for j in range(HD // 4)],
          "long_factor": [2.0 + 0.2 * j for j in range(HD // 4)]}
    return _base_cfg("phi3", num_key_value_heads=2, original_max_position_embeddings=32,
                     partial_rotary_factor=0.5, rope_scaling=rs), t


def _internlm2(w):
    t = {"model.tok_embeddings.weight": w(V, D), "model.norm.weight": 1 + w(D),
         "output.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}"
        # rows [hkv, g + 2, hd]: per kv group, g q heads, then k, then v
        t.update({f"{p}.attention_norm.weight": 1 + w(D), f"{p}.ffn_norm.weight": 1 + w(D),
                  f"{p}.attention.wqkv.weight": w((H + 4) * HD, D),
                  f"{p}.attention.wqkv.bias": w((H + 4) * HD),
                  f"{p}.attention.wo.weight": w(D, H * HD), f"{p}.attention.wo.bias": w(D),
                  f"{p}.feed_forward.w1.weight": w(F, D), f"{p}.feed_forward.w3.weight": w(F, D),
                  f"{p}.feed_forward.w2.weight": w(D, F)})
    return _base_cfg("internlm2", num_key_value_heads=2, bias=True), t


def _llava(w):
    text = _base_cfg("llama", num_key_value_heads=2)
    text.pop("model_type")
    t = _llama_layers(w, prefix="language_model.")
    t.update({"language_model.model.embed_tokens.weight": w(V, D),
              "language_model.model.norm.weight": 1 + w(D),
              "language_model.lm_head.weight": w(V, D),
              # the vision tower and projector stay unread (ROADMAP A16)
              "vision_tower.vision_model.embeddings.patch_embedding.weight": w(8, 3, 4, 4),
              "multi_modal_projector.linear_1.weight": w(D, 8)})
    return {"model_type": "llava", "text_config": text, "vision_config": {"hidden_size": 8}}, t


def _qwen3(w):
    t = _llama_layers(w, qk_norm=True)
    t.update({"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
              "lm_head.weight": w(V, D)})
    return _base_cfg("qwen3", num_key_value_heads=2, head_dim=HD), t


def _qwen3_moe(w):
    t = _llama_layers(w, qk_norm=True, moe=(4, 32))
    t.update({"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
              "lm_head.weight": w(V, D)})
    return _base_cfg("qwen3_moe", num_key_value_heads=2, head_dim=HD, moe_intermediate_size=32,
                     num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
                     decoder_sparse_step=1), t


def _clone(w):
    """An unmapped llama-schema clone (the generic fallback)."""
    t = _llama_layers(w)
    t.update({"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
              "lm_head.weight": w(V, D)})
    return _base_cfg("frontierlm_v9", num_key_value_heads=2), t


FAMILIES = {"qwen2": _qwen2, "qwen": _qwen, "baichuan": _baichuan,
            "baichuan2_normhead": _baichuan2_normhead, "phi3": _phi3, "internlm2": _internlm2,
            "llava": _llava, "qwen3": _qwen3, "qwen3_moe": _qwen3_moe, "unmapped": _clone}


def _write(d, cfg, tensors):
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


def _bytes(a) -> bytes:
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_matches_jax(tmp_path, family):
    """load_hf_float in both packages: equal configs, the same flat keys in
    the same order, every tensor byte-equal, equal rope tables; the logits
    of 10 tokens within the model tolerance of the eager JAX forward."""
    cfg, tensors = FAMILIES[family](_rng(sum(map(ord, family))))
    path = _write(tmp_path / family, cfg, tensors)
    jp, jc = jck.load_hf_float(path)
    tp, tc = load_hf_float(path, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jflat, tflat = jck.params_to_flat(jp), params_to_flat(tp)
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.asarray(a).shape == b.shape and _bytes(a) == b.tobytes(), k
    np.testing.assert_allclose(tp.rope_cos.numpy(), np.asarray(jp.rope_cos), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp.rope_sin.numpy(), np.asarray(jp.rope_sin), rtol=1e-6, atol=1e-7)
    toks = np.random.default_rng(1).integers(0, min(tc.vocab_size, 1000), (1, 10)).astype(np.int32)
    with jax.disable_jit():
        jl, _ = jax_forward(jp, jc, jnp.asarray(toks))
    tl, _ = model_forward(tp, tc, torch.from_numpy(toks).long())
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    if family == "baichuan2_normhead":
        norms = np.linalg.norm(f32(tp.lm_head.weight), axis=0)
        np.testing.assert_allclose(norms, np.ones_like(norms), atol=1e-2)
    if family in ("qwen3", "qwen3_moe"):
        assert tp.blocks[1].attn.k_norm is not None and tc.use_qk_norm
    if family == "phi3":
        assert tc.rotary_dim == HD // 2 and tp.rope_cos.shape[-1] == HD // 4


def test_unmapped_type_falls_back_with_the_warning(tmp_path):
    """from_pretrained of an unmapped llama clone: both packages warn with
    the fallback's text and keep the type; apply_model_type gives it no
    overrides."""
    cfg, tensors = _clone(_rng(3))
    path = _write(tmp_path / "clone", cfg, tensors)
    with pytest.warns(UserWarning, match="frontierlm_v9.*generic llama-family fallback"):
        m = AutoQuickModel.from_pretrained(path, device="cpu")
    with pytest.warns(UserWarning, match="frontierlm_v9.*generic llama-family fallback"):
        jm = JaxAuto.from_pretrained(path)
    assert m.cfg.model_type == jm.cfg.model_type == "frontierlm_v9"
    assert apply_model_type(m.cfg) == m.cfg


def test_unmapped_non_llama_schema_fails_clearly(tmp_path):
    """An unmapped type whose tensors are not the llama schema raises naming
    the type, in both packages."""
    cfg = _base_cfg("alienformer")
    path = _write(tmp_path / "alien", cfg, {"transformer.wte.weight": _rng(4)(V, D)})
    with pytest.raises(NotImplementedError, match="alienformer"):
        load_hf_float(path, device="cpu")
    with pytest.raises(NotImplementedError, match="alienformer"):
        jck.load_hf_float(path)


@pytest.mark.parametrize("model_type", ["bloom", "falcon", "cohere", "gpt_neox"])
def test_other_families_are_refused(tmp_path, model_type):
    """The JAX package's families the port does not run yet raise naming
    ROADMAP A12, at import and in apply_model_type, instead of falling back
    to the llama path."""
    cfg, tensors = _qwen2(_rng(5))
    path = _write(tmp_path / model_type, dict(cfg, model_type=model_type), tensors)
    with pytest.raises(NotImplementedError, match="A12"):
        load_hf_float(path, device="cpu")
    from quick_tpu_torch import ModelConfig

    with pytest.raises(NotImplementedError, match="A12"):
        apply_model_type(ModelConfig(model_type=model_type))


AWQ_TYPES = ["llama", "mistral", "qwen2", "mixtral", "yi", "qwen", "baichuan", "phi3",
             "internlm2", "llava", "qwen3", "qwen3_moe", "gemma", "frontierlm_v9",
             "gemma2", "gemma3", "olmo2", "granite", "minicpm"]


def _awq_refused(load, path) -> bool:
    try:
        load(path)
    except NotImplementedError as e:
        if "AutoAWQ import supports" in str(e):
            return True
    except Exception:  # noqa: BLE001 - an accepted type fails later on the empty file
        pass
    return False


@pytest.mark.parametrize("model_type", AWQ_TYPES)
def test_autoawq_refuses_what_jax_refuses(tmp_path, model_type):
    """load_autoawq refuses a model type exactly when the JAX package's
    does (its ``_AUTOAWQ_OK``), on a checkpoint with no tensors."""
    d = tmp_path / model_type
    cfg, _ = _qwen2(_rng(6))
    if model_type == "llava":
        cfg = {"model_type": "llava", "text_config": dict(cfg, model_type="llama")}
    _write(d, dict(cfg, model_type=model_type) if model_type != "llava" else cfg, {})
    QuantConfig(version="gemm").save_pretrained(str(d))
    port = _awq_refused(lambda p: load_autoawq(p, device="cpu"), str(d))
    assert port == _awq_refused(jck.load_autoawq, str(d))
    assert port == (model_type not in ("llama", "mistral", "qwen2", "mixtral", "yi"))


def test_refused_qk_norm_keys_without_the_switch(tmp_path):
    """q_norm / k_norm tensors in a checkpoint whose config turns no qk-norm
    on (a family whose norm is not mapped) raise rather than go unused."""
    cfg, tensors = _qwen2(_rng(7))
    tensors["model.layers.0.self_attn.q_norm.weight"] = _ones(HD)
    path = _write(tmp_path / "q", cfg, tensors)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="A12"):
            load_hf_float(path, device="cpu")
