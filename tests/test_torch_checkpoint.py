"""Port parity for checkpoints: the safetensors reader / writer, the
AutoAWQ and exllama packers, the native save / load, the AutoAWQ import /
export and the HF float import, each against ``quick_tpu`` on the same
files; and greedy generation from a checkpoint both packages load."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_port import f32

import quick_tpu.quantize.packing as jpack
import quick_tpu.utils.checkpoint as jck
import quick_tpu_torch.quantize.packing as tpack
import quick_tpu_torch.utils.checkpoint as tck
from quick_tpu import ModelConfig as JaxConfig, QuantConfig as JaxQuantConfig
from quick_tpu.models import init_quant_params, model_forward as jax_forward
from quick_tpu.models.model import quantize_params as jax_quantize_params
from quick_tpu.runtime import generate as jax_generate
from quick_tpu_torch import ModelConfig, QuantConfig
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import model_forward, quantize_params
from quick_tpu_torch.modules.linear import QuantLinear
from quick_tpu_torch.runtime import generate
from quick_tpu_torch.utils import safetensors_io as sio

TINY = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=64,
)
TOL = dict(atol=3e-2, rtol=3e-2)  # logits, as tests/test_torch_model.py
SMALL_SHARDS = 300_000  # bytes: the tiny model's 1.7 MB go into 6 shards


def _bytes(a) -> bytes:
    """The raw bytes of a numpy array (ml_dtypes bf16 included) or tensor."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def assert_flat_equal(tflat, jflat):
    """Same keys, dtypes, shapes and bytes."""
    assert list(tflat) == list(jflat)
    for k, a in jflat.items():
        t = tflat[k]
        assert (_dtype_name(t), tuple(t.shape)) == (_dtype_name(a), tuple(a.shape)), k
        assert _bytes(t) == _bytes(a), k


@pytest.fixture(scope="module")
def jax_model():
    cfg = JaxConfig(**TINY)
    return cfg, init_quant_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_saved(jax_model, tmp_path_factory):
    cfg, params = jax_model
    d = str(tmp_path_factory.mktemp("jax_native"))
    jck.save_quantized(params, cfg, JaxQuantConfig(), d)
    return d


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


# ---------------------------------------------------------------- (f) files

def test_safetensors_files_read_both_ways(tmp_path):
    from safetensors.numpy import load_file as st_load, save_file as st_save

    rng = np.random.default_rng(0)
    arrays = {
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 2)).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31, (7,), dtype=np.int32),
        "i64": rng.integers(-2**40, 2**40, (2,), dtype=np.int64),
        "i8": rng.integers(-128, 128, (6,), dtype=np.int8),
        "u8": rng.integers(0, 256, (1, 6), dtype=np.uint8),
        "bool": rng.integers(0, 2, (5,)).astype(bool),
        "empty": np.zeros((0, 4), np.float32),
    }
    ours = tmp_path / "ours.safetensors"
    sio.save_file({k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) if k == "bf16"
                   else v for k, v in arrays.items()}, str(ours), {"format": "pt"})
    back = st_load(str(ours))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and _bytes(back[k]) == _bytes(v), k
    theirs = tmp_path / "theirs.safetensors"
    st_save(arrays, str(theirs), metadata={"format": "np"})
    f = sio.SafeOpen(str(theirs))
    assert f.metadata() == {"format": "np"}
    for k, v in arrays.items():
        t = f.get_tensor(k)
        assert (_dtype_name(t), tuple(t.shape)) == (v.dtype.name, v.shape) and _bytes(t) == _bytes(v), k


# -------------------------------------------------------------- (b) packers

def _codes(rng, K, N):
    return rng.integers(0, 16, (K, N), dtype=np.uint8)


@pytest.mark.parametrize("name", [
    "pack_awq_gemm", "unpack_awq_gemm", "import_awq_gemm", "export_awq_gemm",
    "calculate_zeros_width", "_unpack_words_lastdim", "import_awq_gemv",
    "pack_exllama", "unpack_exllama", "gemm_to_exllama", "import_exllama",
])
def test_interop_packers_are_byte_identical(name):
    rng = np.random.default_rng(3)
    K, N, G = 256, 64, 128
    q, z = _codes(rng, K, N), _codes(rng, K // G, N)
    s = (rng.uniform(size=(K // G, N)) * 0.01 + 1e-3).astype(np.float16)
    gw, gz = jpack.pack_awq_gemm(q), jpack.pack_awq_gemm(z)
    ew, ez = jpack.pack_exllama(q, z)
    args = {
        "pack_awq_gemm": [(q,)],
        "unpack_awq_gemm": [(gw,), (gz,)],
        "import_awq_gemm": [(gw, gz, s, G)],
        "export_awq_gemm": [(jpack.pack_qtpu(q, G), s.astype(np.float32),
                             z.astype(np.float32) * s.astype(np.float32), G)],
        "calculate_zeros_width": [(K, 128), (4096, 64), (11008, 32), (4096, 256)],
        "_unpack_words_lastdim": [(gw,), (ew.T.copy(),)],
        "import_awq_gemv": [(ew.T.copy(), _gemv_zeros(z, K, G), _gemv_scales(s, K, G), G)],
        "pack_exllama": [(q, z)],
        "unpack_exllama": [(ew, ez)],
        "gemm_to_exllama": [(gw, gz)],
        "import_exllama": [(ew, ez, s, G)],
    }[name]
    for a in args:
        ref, out = getattr(jpack, name)(*a), getattr(tpack, name)(*a)
        refs, outs = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
        for r, o in zip(refs, outs):
            r, o = np.asarray(r), np.asarray(o)
            assert (r.dtype, r.shape) == (o.dtype, o.shape) and r.tobytes() == o.tobytes()


def _gemv_zeros(z, K, G):
    """GEMV qzeros [N, zw]: integer zeros packed 8 groups a word, natural
    order, padded to the GEMV zeros width (JAX's exllama row packer)."""
    zw = jpack.calculate_zeros_width(K, G)
    pad = np.zeros((zw * 8, z.shape[1]), np.uint8)
    pad[: z.shape[0]] = z
    return jpack.pack_exllama(pad, np.ones((1, z.shape[1]), np.uint8))[0].T.copy()


def _gemv_scales(s, K, G):
    zw = jpack.calculate_zeros_width(K, G)
    out = np.zeros((s.shape[1], zw * 8), np.float16)
    out[:, : s.shape[0]] = s.T
    return out


# --------------------------------------------------------- (c) native files

def test_flat_dict_matches_jax_params_to_flat(jax_model):
    cfg, params = jax_model
    jflat = jck.params_to_flat(params)
    tparams = tck.params_from_flat(jflat, ModelConfig(**TINY), device="cpu")
    assert_flat_equal(params_to_flat(tparams), jflat)  # tied bf16 lm_head included


@pytest.mark.parametrize("shard_bytes", [None, SMALL_SHARDS])
def test_jax_checkpoint_loads_in_the_port(jax_model, tmp_path, monkeypatch, shard_bytes):
    """quick_tpu.save_quantized -> the port's from_quantized(device="cpu"):
    the same flat dict and the same logits as the JAX model_forward."""
    cfg, params = jax_model
    if shard_bytes:
        monkeypatch.setattr(jck, "SHARD_BYTES", shard_bytes)
    jck.save_quantized(params, cfg, JaxQuantConfig(), str(tmp_path))
    assert (tmp_path / tck.INDEX_FILE).exists() == bool(shard_bytes)
    m = AutoQuickModel.from_quantized(str(tmp_path), device="cpu")
    assert m.device.type == "cpu" and m.qcfg.version == "qtpu"
    assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(params))
    toks = _tokens(2, 10)
    jl, _ = jax_forward(params, cfg, jnp.asarray(toks))
    tl, _ = model_forward(m.params, m.cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


@pytest.mark.parametrize("shard_bytes", [None, SMALL_SHARDS])
def test_port_checkpoint_loads_in_jax(jax_saved, tmp_path, monkeypatch, shard_bytes):
    """The port's save_quantized -> quick_tpu.load_quantized: equal flat
    dicts, configs, and the same shard index as the JAX package writes."""
    m = AutoQuickModel.from_quantized(jax_saved, device="cpu")
    ref_dir = tmp_path / "jax"
    if shard_bytes:
        monkeypatch.setattr(tck, "SHARD_BYTES", shard_bytes)
        monkeypatch.setattr(jck, "SHARD_BYTES", shard_bytes)
    m.save_quantized(str(tmp_path / "port"))
    jparams, jcfg, jqcfg = jck.load_quantized(str(tmp_path / "port"))
    assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    assert jcfg == JaxConfig(**TINY) and jqcfg.to_dict() == m.qcfg.to_dict()
    jck.save_quantized(jparams, jcfg, jqcfg, str(ref_dir))
    for name in ("config.json", "quant_config.json") + ((tck.INDEX_FILE,) if shard_bytes else ()):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((ref_dir / name).read_text()), name


# ------------------------------------------------------------- (d) AutoAWQ

def _jax_awq_export(jax_model, d, version="gemm"):
    """quick_tpu.export_autoawq, then each linear's GEMM triple repacked to
    the GEMV or exllama layout with the JAX packers."""
    from safetensors.numpy import load_file, save_file

    cfg, params = jax_model
    jck.export_autoawq(params, cfg, JaxQuantConfig(), str(d))
    if version == "gemm":
        return
    st = load_file(str(d / "model.safetensors"))
    out = {}
    for k, v in st.items():
        if not k.endswith(".qweight"):
            if not k.endswith((".qzeros", ".scales")):
                out[k] = v
            continue
        base = k[: -len(".qweight")]
        qz, s = st[base + ".qzeros"], st[base + ".scales"]
        K = v.shape[0]
        if version == "exllama":
            out[base + ".qweight"], out[base + ".qzeros"] = jpack.gemm_to_exllama(v, qz)
            out[base + ".scales"] = s
        else:
            ew = jpack.pack_exllama(jpack.unpack_awq_gemm(v), np.ones((1, s.shape[1]), np.uint8))[0]
            out[base + ".qweight"] = ew.T.copy()
            out[base + ".qzeros"] = _gemv_zeros(jpack.unpack_awq_gemm(qz), K, 128)
            out[base + ".scales"] = _gemv_scales(s, K, 128)
    save_file(out, str(d / "model.safetensors"))
    for name in ("config.json", "quant_config.json"):
        p = d / name
        c = json.loads(p.read_text())
        (c["quantization_config"] if name == "config.json" else c)["version"] = version
        p.write_text(json.dumps(c))


@pytest.mark.parametrize("version", ["gemm", "gemv", "exllama"])
def test_autoawq_checkpoint_loads_like_jax(jax_model, tmp_path, version):
    _jax_awq_export(jax_model, tmp_path, version)
    jparams, jcfg, jqcfg = jck.load_autoawq(str(tmp_path))
    tparams, tcfg, tqcfg = tck.load_autoawq(str(tmp_path), device="cpu")
    assert tqcfg.version == version and tcfg.model_type == jcfg.model_type
    assert_flat_equal(params_to_flat(tparams), jck.params_to_flat(jparams))
    m = AutoQuickModel.from_quantized(str(tmp_path), device="cpu")
    assert m.qcfg.version == "qtpu"
    assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))


def test_port_autoawq_export_reads_in_jax(jax_model, jax_saved, tmp_path):
    """The port's export_autoawq writes the JAX export's tensors and
    configs; the JAX package loads it back to the same params."""
    from safetensors.numpy import load_file

    m = AutoQuickModel.from_quantized(jax_saved, device="cpu")
    m.save_quantized(str(tmp_path / "port"), awq_format=True)
    cfg, params = jax_model
    jck.export_autoawq(params, cfg, JaxQuantConfig(), str(tmp_path / "jax"))
    ours, ref = (load_file(str(tmp_path / d / "model.safetensors")) for d in ("port", "jax"))
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and _bytes(ours[k]) == _bytes(ref[k]), k
    for name in ("config.json", "quant_config.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())
    jparams, _, jqcfg = jck.load_autoawq(str(tmp_path / "port"))
    assert jqcfg.version == "gemm"
    tparams, _, _ = tck.load_autoawq(str(tmp_path / "port"), device="cpu")
    assert_flat_equal(params_to_flat(tparams), jck.params_to_flat(jparams))


# ------------------------------------------------------- (e) HF float import

def _write_hf_llama(d, seed=0, tie=False, extra=None, model_type="llama"):
    """A tiny llama in HF layout ([out, in] float32 linears), written with
    numpy and the safetensors package."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    D, F, V = TINY["hidden_size"], TINY["intermediate_size"], TINY["vocab_size"]
    hq, hkv = TINY["num_attention_heads"], TINY["num_key_value_heads"]
    hd = D // hq

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    t = {"model.embed_tokens.weight": (rng.standard_normal((V, D)) * 0.02).astype(np.float32),
         "model.norm.weight": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)}
    if not tie:
        t["lm_head.weight"] = w(V, D)
    for i in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{i}"
        t.update({
            f"{p}.self_attn.q_proj.weight": w(hq * hd, D),
            f"{p}.self_attn.k_proj.weight": w(hkv * hd, D),
            f"{p}.self_attn.v_proj.weight": w(hkv * hd, D),
            f"{p}.self_attn.o_proj.weight": w(D, hq * hd),
            f"{p}.mlp.gate_proj.weight": w(F, D),
            f"{p}.mlp.up_proj.weight": w(F, D),
            f"{p}.mlp.down_proj.weight": w(D, F),
            f"{p}.input_layernorm.weight": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            f"{p}.post_attention_layernorm.weight": np.ones(D, np.float32),
        })
    t.update(extra or {})
    d.mkdir(parents=True, exist_ok=True)
    save_file(t, str(d / "model.safetensors"))
    hf = dict(model_type=model_type, vocab_size=V, hidden_size=D, intermediate_size=F,
              num_hidden_layers=TINY["num_hidden_layers"], num_attention_heads=hq,
              num_key_value_heads=hkv, max_position_embeddings=64, rms_norm_eps=1e-5,
              tie_word_embeddings=tie)
    (d / "config.json").write_text(json.dumps(hf))
    return d


@pytest.mark.parametrize("tie", [False, True])
def test_hf_float_import_and_rtn_match(tmp_path, tie):
    d = _write_hf_llama(tmp_path / "hf", tie=tie)
    jparams, jcfg = jck.load_hf_float(str(d))
    m = AutoQuickModel.from_pretrained(str(d), device="cpu")
    assert m.cfg.tie_word_embeddings == jcfg.tie_word_embeddings == tie
    assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jparams))
    jq = jax_quantize_params(jparams, jcfg, 128, True)
    m.quantize(quant_config=QuantConfig(), use_awq_search=False)
    assert_flat_equal(params_to_flat(m.params), jck.params_to_flat(jq))
    skip = quantize_params(m.params, m.cfg, modules_to_not_convert=["mlp.down_proj"])
    assert skip.blocks[0].mlp.down_proj is m.params.blocks[0].mlp.down_proj


@pytest.mark.parametrize("case", ["qk_norm", "final_norm_bias", "norm_bias", "moe_keys", "stray",
                                  "gpt_neox"])
def test_hf_import_refuses_unported_branches(tmp_path, case):
    """Branches of the JAX importer the port has not taken over raise,
    naming their ROADMAP item, instead of dropping tensors (gemma2's
    sandwich norms import: tests/test_torch_gemma.py)."""
    D = TINY["hidden_size"]
    extra = {
        "qk_norm": {"model.layers.0.self_attn.q_norm.weight": np.ones(64, np.float32)},
        "final_norm_bias": {"model.norm.bias": np.zeros(D, np.float32)},
        "norm_bias": {"model.layers.1.input_layernorm.bias": np.zeros(D, np.float32)},
        "moe_keys": {"model.layers.0.block_sparse_moe.gate.weight": np.ones((4, D), np.float32)},
        "stray": {"model.layers.0.self_attn.extra.weight": np.ones(4, np.float32)},
    }.get(case, {})
    d = _write_hf_llama(tmp_path / "hf", extra=extra,
                        model_type="gpt_neox" if case == "gpt_neox" else "llama")
    with pytest.raises(NotImplementedError, match="ROADMAP A1[02]"):
        AutoQuickModel.from_pretrained(str(d), device="cpu")


def test_awq_search_is_refused():
    """The AWQ search is ported: quantize(calib) runs it and packs every
    block linear; the other families' switches (ROADMAP A12) still raise."""
    m = AutoQuickModel.from_random(ModelConfig(**TINY), device="cpu")
    m.quantize(np.zeros((1, 8), np.int32), QuantConfig(), verbose=False)
    blk = m.params.blocks[0]
    assert all(isinstance(lin, QuantLinear) for lin in (
        blk.attn.qkv_proj, blk.attn.o_proj, blk.mlp.gate_up_proj, blk.mlp.down_proj))
    m = AutoQuickModel.from_random(ModelConfig(**TINY), device="cpu")
    # cohere's LayerNorm qk-norm
    m.cfg = dataclasses.replace(m.cfg, use_qk_norm=True, layernorm="layernorm")
    with pytest.raises(NotImplementedError, match="A12"):
        m.quantize(np.zeros((1, 8), np.int32), QuantConfig())


# ------------------------------------------------------------ (g) generate

def test_greedy_generate_b16_from_checkpoint(jax_model, jax_saved):
    """One checkpoint, both packages: greedy generate at B=16 gives the
    same tokens (the port on the CPU)."""
    cfg, params = jax_model
    m = AutoQuickModel.from_quantized(jax_saved, device="cpu")
    toks = _tokens(16, 8, seed=4)
    ref = np.asarray(jax_generate(params, cfg, jnp.asarray(toks), 6, max_seq=16))
    out = m.generate(torch.from_numpy(toks), 6, max_seq=16)
    np.testing.assert_array_equal(out.numpy(), ref)
