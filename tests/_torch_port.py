"""Helpers for the port's tests (tests/test_torch_*.py). Imports no JAX, so
the card-only tests can run where JAX is not installed.

Tests that need an NVIDIA card carry ``@pytest.mark.cuda`` and take the
``cuda_device`` fixture, which skips them when there is no card. The
decision is made when the fixture runs, never at import, so every test
worker collects the same tests. On a machine with a card (``--noconftest``
because tests/conftest.py sets up JAX):
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import struct

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel test)")
    return torch.device("cuda")


def f32(x) -> np.ndarray:
    """JAX array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def assert_greedy_match(out, ref, ref_logits, prompt_len: int) -> int:
    """Greedy streams [B, S + n] of the port (``out``) and of the JAX
    package (``ref``) must be equal, except that a row may part at a step
    where the reference's logits of the two tokens lie within one bf16 step
    of each other: both heads write bf16 logits from hidden states summed
    in other orders, so such a tie can round either way. From there on the
    row is not compared. ``ref_logits`` [B, S + n - 1, V] are the
    reference's logits over ``ref[:, :-1]``. Returns the tokens compared
    equal."""
    out, ref, lg = np.asarray(out), np.asarray(ref), f32(ref_logits)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out[:, :prompt_len], ref[:, :prompt_len])
    equal = 0
    for b in range(ref.shape[0]):
        diff = np.nonzero(out[b, prompt_len:] != ref[b, prompt_len:])[0]
        n = diff[0] if diff.size else ref.shape[1] - prompt_len
        equal += n
        if diff.size:
            t = prompt_len + n
            a, c = lg[b, t - 1, ref[b, t]], lg[b, t - 1, out[b, t]]
            assert abs(a - c) <= 2.0 ** -7 * max(abs(a), abs(c), 1.0), (
                f"row {b} parts at token {t} with a reference logit gap of {a - c}")
    return equal


def least_route_gap(p, cfg, x, token_mask=None) -> float:
    """The least margin of a discrete choice of an MoE router over the
    routed tokens of ``x`` [B, S, D] (``token_mask`` [B, S] drops padding):
    between the k-th and (k+1)-th score it ranks (the logits; for the
    deepseek router its softmax or sigmoid scores plus the selection bias,
    among the kept groups) and, with group-limited selection, between the
    last kept group's score and the best dropped one. Both packages route on
    router inputs a few f32 ulps apart, so a margin far above that makes
    their expert choice the same."""
    from quick_tpu_torch.modules.blocks import top_k

    logits = p.router(x.to(torch.float32))
    k = cfg.num_experts_per_tok
    gaps = []
    choice = logits
    if cfg.moe_router == "deepseek":
        s = torch.sigmoid(logits) if cfg.scoring_func == "sigmoid" else torch.softmax(logits, -1)
        choice = s if p.score_bias is None else s + p.score_bias
        B, S, E = choice.shape
        ng, tg = cfg.n_group, cfg.topk_group
        if ng and tg and tg < ng:
            gsc = choice.reshape(B, S, ng, E // ng)
            gscore = top_k(gsc, 2)[0].sum(-1) if p.score_bias is not None else gsc.amax(-1)
            gv = torch.sort(gscore, dim=-1, descending=True).values
            gaps.append(gv[..., tg - 1] - gv[..., tg])
            keep = torch.zeros((B, S, ng), dtype=torch.bool).scatter_(-1, top_k(gscore, tg)[1], True)
            choice = torch.where(keep[..., None], gsc, torch.full_like(gsc, -1e9)).reshape(B, S, E)
    v = torch.sort(choice, dim=-1, descending=True).values
    gaps.append(v[..., k - 1] - v[..., k])
    if token_mask is not None:
        gaps = [g[token_mask] for g in gaps]
    gaps = [g for g in gaps if g.numel()]
    return min(float(g.min()) for g in gaps) if gaps else float("inf")


# ---------------------------------------------------------------------------
# A minimal GGUF v3 writer (test and chip_smoke.py use only; not a package
# feature): random but valid llama.cpp blocks from a numpy seed.
# ---------------------------------------------------------------------------

#: ggml type ids and (block elements, block bytes)
GGUF_F32, GGUF_F16, GGUF_Q4_0, GGUF_Q4_1, GGUF_Q8_0, GGUF_Q4_K, GGUF_Q6_K = 0, 1, 2, 3, 8, 12, 14
GGUF_BLOCK = {GGUF_F32: (1, 4), GGUF_F16: (1, 2), GGUF_Q4_0: (32, 18), GGUF_Q4_1: (32, 20),
              GGUF_Q8_0: (32, 34), GGUF_Q4_K: (256, 144), GGUF_Q6_K: (256, 210)}


def _f16_bytes(v: np.ndarray) -> np.ndarray:
    """Values -> little-endian f16 bytes [n, 2] (finite, as given)."""
    return np.ascontiguousarray(np.asarray(v, "<f2")).view(np.uint8).reshape(-1, 2)


def encode_q4_k_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """The 12 bytes of 8 six-bit scales and 8 six-bit mins per Q4_K block
    (llama.cpp's get_scale_min_k4 layout): [nb, 8] x 2 -> [nb, 12]."""
    sc, mn = sc.astype(np.uint8), mn.astype(np.uint8)
    out = np.empty((sc.shape[0], 12), np.uint8)
    out[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4)
    return out


def random_gguf_tensor(rng: np.random.Generator, ggml_type: int, shape, std: float = 0.02) -> np.ndarray:
    """Bytes of a tensor of ``shape`` (numpy order; blocks run along the
    last dim) whose values are roughly centred with spread ``std``: random
    codes, with finite positive f16 block scales and 6-bit sub-scales in
    [16, 48) (random bytes there would give NaN or inf scales)."""
    n = int(np.prod(shape))
    if ggml_type in (GGUF_F32, GGUF_F16):
        v = rng.standard_normal(n, dtype=np.float32) * std
        return np.ascontiguousarray(v.astype("<f4" if ggml_type == GGUF_F32 else "<f2")).view(np.uint8)
    be, bb = GGUF_BLOCK[ggml_type]
    nb = n // be
    raw = np.frombuffer(rng.bytes(nb * bb), np.uint8).reshape(nb, bb).copy()

    def jitter(scale):
        return scale * rng.uniform(0.75, 1.25, nb)

    if ggml_type == GGUF_Q4_0:  # v = (q - 8) d; |q - 8| has rms 4.6
        raw[:, 0:2] = _f16_bytes(jitter(std / 4.6))
    elif ggml_type == GGUF_Q4_1:  # v = q d + m
        d = jitter(std / 4.6)
        raw[:, 0:2] = _f16_bytes(d)
        raw[:, 2:4] = _f16_bytes(-7.5 * d)
    elif ggml_type == GGUF_Q8_0:  # v = q d, q int8
        raw[:, 0:2] = _f16_bytes(jitter(std / 74.0))
    elif ggml_type == GGUF_Q4_K:  # v = q (d sc) - dmin mn
        d = jitter(std / (4.6 * 32))
        raw[:, 0:2] = _f16_bytes(d)
        raw[:, 2:4] = _f16_bytes(7.5 * d)
        raw[:, 4:16] = encode_q4_k_scales(rng.integers(16, 48, (nb, 8)), rng.integers(16, 48, (nb, 8)))
    elif ggml_type == GGUF_Q6_K:  # v = d sc (q - 32), sc int8
        raw[:, 192:208] = rng.integers(8, 24, (nb, 16)).astype(np.int8).view(np.uint8)
        raw[:, 208:210] = _f16_bytes(jitter(std / (18.5 * 16)))
    else:
        raise ValueError(f"ggml type {ggml_type}")
    return raw.reshape(-1)


def permute_rows(raw_rows: np.ndarray, n_head: int) -> np.ndarray:
    """llama.cpp's q / k row permutation (convert_hf_to_gguf.py ``permute``),
    HF rotate-half rows -> ggml's interleaved-RoPE rows:
    ggml_row[2j + i] = hf_row[i*hd/2 + j], per head. ``raw_rows`` is
    [out, bytes per row]: a quantized row carries its own blocks."""
    out = raw_rows.shape[0]
    hd = out // n_head
    return (raw_rows.reshape(n_head, 2, hd // 2, -1).swapaxes(1, 2).reshape(out, -1))


def _gguf_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_value(v) -> bytes:
    if isinstance(v, bool):
        return struct.pack("<IB", 7, int(v))
    if isinstance(v, int):
        return struct.pack("<II", 4, v)  # uint32, as llama.cpp writes counts
    if isinstance(v, float):
        return struct.pack("<If", 6, v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + _gguf_str(v)
    if isinstance(v, (list, tuple)):  # an array of strings
        return struct.pack("<IIQ", 9, 8, len(v)) + b"".join(_gguf_str(s) for s in v)
    raise TypeError(f"GGUF metadata value {v!r}")


def write_gguf(path, meta: dict, tensors, alignment: int = 32) -> int:
    """Write a GGUF v3 file: ``meta`` {key: value}; ``tensors`` a list of
    (name, shape in numpy order, ggml type, make) where ``make()`` returns
    the tensor's bytes when its turn comes (one tensor in memory at a
    time). Returns the file's size in bytes."""
    meta = {"general.alignment": alignment, **meta}
    head = [b"GGUF", struct.pack("<IQQ", 3, len(tensors), len(meta))]
    for k, v in meta.items():
        head.append(_gguf_str(k) + _gguf_value(v))
    off, offsets = 0, []
    for name, shape, t, _ in tensors:
        be, bb = GGUF_BLOCK[t]
        ne = tuple(reversed(shape))
        head.append(_gguf_str(name) + struct.pack(f"<I{len(ne)}QIQ", len(ne), *ne, t, off))
        offsets.append(off)
        nbytes = int(np.prod(shape)) // be * bb
        off += -(-nbytes // alignment) * alignment  # each tensor starts aligned
    header = b"".join(head)
    with open(path, "wb") as f:
        f.write(header + b"\0" * (-len(header) % alignment))
        start = f.tell()
        for (name, shape, t, make), o in zip(tensors, offsets):
            f.seek(start + o)
            data = make()
            be, bb = GGUF_BLOCK[t]
            if data.nbytes != int(np.prod(shape)) // be * bb:
                raise ValueError(f"{name}: {data.nbytes} bytes for {shape} of type {t}")
            f.write(data.tobytes())
        f.write(b"\0" * (-f.tell() % alignment))
        return f.tell()


#: the per-layer llama linears of a GGUF file: (name, out, in) from
#: (hidden, ffn, q width, kv width)
def _llama_linears(D, F, Q, KV):
    return [("attn_q", Q, D), ("attn_k", KV, D), ("attn_v", KV, D), ("attn_output", D, Q),
            ("ffn_gate", F, D), ("ffn_up", F, D), ("ffn_down", D, F)]


def write_llama_gguf(path, cfg: dict, seed: int = 0, types=None, output_type=GGUF_F16,
                     rope_freqs: bool = False, spread: float = 1.0) -> int:
    """A llama-architecture GGUF file of random valid blocks (numpy seed
    ``seed``): ``cfg`` holds the HF names (vocab_size, hidden_size,
    intermediate_size, num_hidden_layers, num_attention_heads,
    num_key_value_heads, and optionally max_position_embeddings,
    rms_norm_eps, rope_theta); ``types`` maps a linear's name (attn_q ...
    ffn_down) to its ggml type (default Q4_K); the embedding is F16;
    ``output_type`` None ties the head to the embedding. A linear's values spread ``spread`` /
    sqrt(in) (1: unit-variance outputs; 0.02: the spread of
    ``init_quant_params``' random models). q / k rows carry llama.cpp's
    permutation. Returns the file's size in bytes."""
    rng = np.random.default_rng(seed)
    V, D, F = cfg["vocab_size"], cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // hq
    types = types or {}
    meta = {
        "general.architecture": "llama", "llama.vocab_size": V,
        "llama.embedding_length": D, "llama.feed_forward_length": F,
        "llama.block_count": cfg["num_hidden_layers"], "llama.attention.head_count": hq,
        "llama.attention.head_count_kv": hkv,
        "llama.context_length": cfg.get("max_position_embeddings", 4096),
        "llama.attention.layer_norm_rms_epsilon": float(cfg.get("rms_norm_eps", 1e-5)),
        "llama.rope.freq_base": float(cfg.get("rope_theta", 10000.0)),
    }

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(D, dtype=np.float32)).astype("<f4").view(np.uint8)

    def lin(t, out, k, heads):
        def make():
            raw = random_gguf_tensor(rng, t, (out, k), std=spread / np.sqrt(k))
            return permute_rows(raw.reshape(out, -1), heads).reshape(-1) if heads else raw
        return make

    tensors = [("token_embd.weight", (V, D), GGUF_F16,
                lambda: random_gguf_tensor(rng, GGUF_F16, (V, D), std=0.02)),
               ("output_norm.weight", (D,), GGUF_F32, norm)]
    if output_type is not None:
        tensors.append(("output.weight", (V, D), output_type,
                        lambda: random_gguf_tensor(rng, output_type, (V, D), std=1.0 / np.sqrt(D))))
    if rope_freqs:
        tensors.append(("rope_freqs.weight", (hd // 2,), GGUF_F32,
                        lambda: (1.0 + rng.uniform(0, 3, hd // 2)).astype("<f4").view(np.uint8)))
    for i in range(cfg["num_hidden_layers"]):
        tensors += [(f"blk.{i}.attn_norm.weight", (D,), GGUF_F32, norm),
                    (f"blk.{i}.ffn_norm.weight", (D,), GGUF_F32, norm)]
        for name, out, k in _llama_linears(D, F, hq * hd, hkv * hd):
            t = types.get(name, GGUF_Q4_K)
            heads = hq if name == "attn_q" else hkv if name == "attn_k" else 0
            tensors.append((f"blk.{i}.{name}.weight", (out, k), t, lin(t, out, k, heads)))
    return write_gguf(path, meta, tensors)
