"""Port parity for the GGUF import: files written by the test writer
(tests/_torch_port.py) from a numpy seed are read by the port's
``utils/gguf.py`` and by ``quick_tpu.utils.gguf``; the decoded tensors,
the exact int4 imports and a tiny llama's params must be equal byte for
byte, and ``AutoQuickModel.from_gguf(device="cpu")`` must generate the
JAX model's greedy tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import (GGUF_F16, GGUF_F32, GGUF_Q4_0, GGUF_Q4_1, GGUF_Q4_K, GGUF_Q6_K,
                         GGUF_Q8_0, assert_greedy_match, f32, permute_rows, random_gguf_tensor,
                         write_gguf, write_llama_gguf)

import quick_tpu.utils.gguf as jgguf
from quick_tpu.models import model_forward as jax_forward
from quick_tpu.models.auto import AutoQuickModel as JaxAutoModel
from quick_tpu.runtime import generate as jax_generate
from quick_tpu.utils.checkpoint import params_to_flat as jax_to_flat
from quick_tpu_torch.models.auto import AutoQuickModel
from quick_tpu_torch.models.convert import params_to_flat
from quick_tpu_torch.models.model import model_forward
from quick_tpu_torch.runtime import generate
from quick_tpu_torch.utils import gguf as tgguf

TYPES = {"Q4_0": GGUF_Q4_0, "Q4_1": GGUF_Q4_1, "Q4_K": GGUF_Q4_K, "Q8_0": GGUF_Q8_0,
         "Q6_K": GGUF_Q6_K, "F16": GGUF_F16, "F32": GGUF_F32}
TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            rope_theta=500000.0)
#: every linear type the loader takes, exact (Q4_*) and re-quantized (Q8_0, Q6_K)
MIXED = {"attn_q": GGUF_Q4_K, "attn_k": GGUF_Q4_0, "attn_v": GGUF_Q6_K,
         "attn_output": GGUF_Q4_1, "ffn_gate": GGUF_Q4_K, "ffn_up": GGUF_Q8_0,
         "ffn_down": GGUF_Q4_K}


def _bytes(a) -> bytes:
    """Raw bytes of a tensor or a numpy array (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("name", list(TYPES))
def test_decoders_equal_jax(tmp_path, name):
    """One tensor of each type (three rows of 512 plus a 1-D one): the
    metadata and infos parse alike, the float decode and the exact int4
    view (Q4 types) are byte-equal to the JAX package's."""
    t = TYPES[name]
    rng = np.random.default_rng(7)
    shape = (3, 512)
    raw = random_gguf_tensor(rng, t, shape, std=0.05)
    vec = random_gguf_tensor(rng, GGUF_F32, (256,))
    path = str(tmp_path / f"{name}.gguf")
    write_gguf(path, {"general.architecture": "llama", "llama.block_count": 1,
                      "general.name": "unit", "tokenizer.ggml.tokens": ["a", "b"],
                      "llama.rope.freq_base": 1e4},
               [("w", shape, t, lambda: raw), ("v", (256,), GGUF_F32, lambda: vec)])
    jmeta, jt, jstart, jmm = jgguf.read_gguf(path)
    tmeta, tt, tstart, tmm = tgguf.read_gguf(path)
    assert tstart == jstart and list(tt) == list(jt)
    assert {k: str(v) for k, v in tmeta.items()} == {k: str(v) for k, v in jmeta.items()}
    for k in jt:
        assert (tt[k].shape, tt[k].ggml_type, tt[k].offset) == (jt[k].shape, jt[k].ggml_type,
                                                                jt[k].offset)
        got = tgguf.load_tensor_float(tt[k], tmm, tstart)
        want = jgguf.load_tensor_float(jt[k], jmm, jstart)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert np.isfinite(want).all() and _bytes(got) == _bytes(want.astype(np.float32))
    got, want = tgguf.load_tensor_q4(tt["w"], tmm, tstart), jgguf.load_tensor_q4(jt["w"], jmm, jstart)
    assert (got is None) == (want is None) == (name not in ("Q4_0", "Q4_1", "Q4_K"))
    if want is not None:
        for g, w, dt in zip(got, want, (np.uint8, np.float32, np.float32)):
            assert _bytes(g) == _bytes(w.astype(dt))


def test_unpermute_inverts_the_writers_permutation():
    rows = np.arange(4 * 16 * 3, dtype=np.uint8).reshape(64, 3)
    ggml = permute_rows(rows, 4)
    assert not np.array_equal(ggml, rows)
    back = tgguf._unpermute_rows(torch.from_numpy(ggml), 4).numpy()
    np.testing.assert_array_equal(back, rows)
    np.testing.assert_array_equal(jgguf._unpermute_rows(ggml, 4), rows)


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "tiny.gguf")
    write_llama_gguf(path, TINY, seed=1, types=MIXED, output_type=None, rope_freqs=True)
    return path


@pytest.mark.parametrize("head_float", [True, False])
def test_load_gguf_params_byte_equal_to_jax(tiny_file, head_float):
    """A tiny llama with a tied head (float, or re-quantized at g=32), mixed
    quant types, permuted q / k and per-dim rope factors: every flat tensor
    and the rope tables equal the JAX package's byte for byte."""
    jparams, jcfg, jq = jgguf.load_gguf(tiny_file, lm_head_float=head_float)
    tparams, tcfg, tq = tgguf.load_gguf(tiny_file, lm_head_float=head_float, device="cpu")
    assert (tq.q_group_size, tq.version) == (jq.q_group_size, jq.version) == (32, "qtpu")
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rms_norm_eps", "rope_theta", "model_type"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    jflat, tflat = jax_to_flat(jparams), params_to_flat(tparams)
    assert list(tflat) == list(jflat)
    for k, v in jflat.items():
        assert _bytes(tflat[k]) == _bytes(v), k
    for f in ("rope_cos", "rope_sin"):
        assert _bytes(getattr(tparams, f)) == _bytes(np.asarray(getattr(jparams, f))), f


def test_from_gguf_generates_jax_tokens(tiny_file):
    """from_gguf on the CPU: logits over a prompt within the model tests'
    tolerance of the JAX model's, and greedy generate() gives its tokens
    (a row may part only at a bf16 tie of the reference's logits)."""
    tm = AutoQuickModel.from_gguf(tiny_file, device="cpu")
    jm = JaxAutoModel.from_gguf(tiny_file)
    assert tm.device.type == "cpu" and tm.gguf_path == tiny_file
    assert tm.params.blocks[0].attn.qkv_proj.group_size == 32
    toks = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 8)).astype(np.int32)
    tl, _ = model_forward(tm.params, tm.cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(f32(tl), f32(jax_forward(jm.params, jm.cfg, jnp.asarray(toks))[0]),
                               atol=3e-2, rtol=3e-2)  # as tests/test_torch_model.py
    ref = np.asarray(jax_generate(jm.params, jm.cfg, jnp.asarray(toks), 6, max_seq=16))
    out = generate(tm.params, tm.cfg, torch.from_numpy(toks), 6, max_seq=16)
    ref_logits = jax_forward(jm.params, jm.cfg, jnp.asarray(ref[:, :-1]))[0]
    assert assert_greedy_match(out.numpy(), ref, ref_logits, 8) >= 6
