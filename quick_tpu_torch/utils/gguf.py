"""GGUF (llama.cpp) checkpoint import (port of ``quick_tpu/utils/gguf.py``).

The llama.cpp 4-bit formats map exactly onto the W4A16 contract, which
computes ``code * s - zs`` per group of 32 input channels:

- Q4_0:  v = (q - 8)*d          -> s = d,       zs = 8*d
- Q4_1:  v = q*d + m            -> s = d,       zs = -m
- Q4_K:  v = q*(d*sc) - dmin*m  -> s = d*sc,    zs = dmin*m   (g = 32)

so Q4_0 / Q4_1 / Q4_K linears import bit-exactly at group size 32 and run
on the card's small-group kernel (K9). Q8_0 and Q6_K tensors (llama.cpp
mixes them into "Q4_K_M" files) are dequantized and, for linear weights,
re-quantized to int4 g=32 with the port's ``quantize_tensor``. Embeddings
and norms load as bf16; the lm_head loads as a bf16 float weight unless
asked otherwise.

The header is parsed with numpy over a memory map; each tensor's blocks are
decoded with torch ops on the device the model is loaded to, one tensor at
a time, so host memory holds one tensor's bytes and the card does the
unpacking. The float operations are the JAX package's numpy ones, each
rounded in f32 (f16 -> f32 conversions, one product or one difference
each), so the imported bytes are the JAX package's. Re-quantization runs
on the CPU, where the port's ``quantize_tensor`` equals the JAX one.

Format spec: github.com/ggml-org/ggml/blob/master/docs/gguf.md (v2/v3).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

GGUF_MAGIC = b"GGUF"

# ggml tensor type ids
F32, F16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 = 0, 1, 2, 3, 6, 7, 8
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K = 10, 11, 12, 13, 14
BF16 = 30

#: type -> (block_elems, block_bytes); float types use (1, itemsize)
BLOCK = {
    F32: (1, 4), F16: (1, 2), BF16: (1, 2),
    Q4_0: (32, 18), Q4_1: (32, 20), Q8_0: (32, 34),
    Q4_K: (256, 144), Q6_K: (256, 210),
}
#: the llama.cpp 4-bit sub-group size: the group of every imported linear
GROUP = 32

_VT_SCALAR = {
    0: ("<u1", 1), 1: ("<i1", 1), 2: ("<u2", 2), 3: ("<i2", 2),
    4: ("<u4", 4), 5: ("<i4", 4), 6: ("<f4", 4), 7: ("<u1", 1),
    10: ("<u8", 8), 11: ("<i8", 8), 12: ("<f8", 8),
}


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]  # numpy order (outer-first; ne reversed)
    ggml_type: int
    offset: int             # relative to the data section


def _read_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<Q", buf, off)
    off += 8
    return bytes(buf[off: off + n]).decode("utf-8"), off + n


def _read_value(buf: memoryview, off: int, vt: int):
    if vt == 8:  # string
        return _read_str(buf, off)
    if vt == 9:  # array
        et, n = struct.unpack_from("<IQ", buf, off)
        off += 12
        if et == 8:
            vals = []
            for _ in range(n):
                v, off = _read_str(buf, off)
                vals.append(v)
            return vals, off
        dt, sz = _VT_SCALAR[et]
        arr = np.frombuffer(buf, dtype=dt, count=n, offset=off)
        if et == 7:
            arr = arr.astype(bool)
        return arr, off + n * sz
    dt, sz = _VT_SCALAR[vt]
    v = np.frombuffer(buf, dtype=dt, count=1, offset=off)[0]
    if vt == 7:
        v = bool(v)
    return v, off + sz


def read_gguf(path: str):
    """Parse a GGUF file. Returns (metadata dict, {name: TensorInfo},
    data_section_start, memory-mapped bytes)."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    buf = memoryview(data)
    if bytes(buf[:4]) != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file")
    (version,) = struct.unpack_from("<I", buf, 4)
    if version < 2:
        raise ValueError(f"GGUF v{version} unsupported (need >= 2)")
    n_tensors, n_kv = struct.unpack_from("<QQ", buf, 8)
    off = 24
    meta: Dict[str, object] = {}
    for _ in range(n_kv):
        key, off = _read_str(buf, off)
        (vt,) = struct.unpack_from("<I", buf, off)
        off += 4
        meta[key], off = _read_value(buf, off, vt)
    tensors: Dict[str, TensorInfo] = {}
    for _ in range(n_tensors):
        name, off = _read_str(buf, off)
        (nd,) = struct.unpack_from("<I", buf, off)
        off += 4
        ne = struct.unpack_from(f"<{nd}Q", buf, off)
        off += 8 * nd
        (ttype,) = struct.unpack_from("<I", buf, off)
        (toff,) = struct.unpack_from("<Q", buf, off + 4)
        off += 12
        # ne is innermost-first; the numpy shape is the reverse
        tensors[name] = TensorInfo(name, tuple(reversed(ne)), ttype, toff)
    align = int(meta.get("general.alignment", 32))
    data_start = (off + align - 1) // align * align
    return meta, tensors, data_start, data


# -- block decoders (torch, on the raw bytes' device) ---------------------------

def _f16(raw: torch.Tensor) -> torch.Tensor:
    """[..., 2k] bytes -> [..., k] f32 (exact)."""
    return raw.contiguous().view(torch.float16).to(torch.float32)


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[nb, 16] bytes -> [nb, 32] codes: low nibbles, then high nibbles."""
    return torch.cat([qs & 0xF, qs >> 4], dim=1)


def _q4_0(raw: torch.Tensor, nb: int):
    """[nb * 18] bytes -> (codes u8 [nb, 32], scales [nb], zs [nb])."""
    raw = raw.reshape(nb, 18)
    d = _f16(raw[:, :2]).reshape(nb)
    return _nibbles(raw[:, 2:18]), d, 8.0 * d


def _q4_1(raw: torch.Tensor, nb: int):
    raw = raw.reshape(nb, 20)
    d = _f16(raw[:, :2]).reshape(nb)
    m = _f16(raw[:, 2:4]).reshape(nb)
    return _nibbles(raw[:, 4:20]), d, -m


def _q8_0_float(raw: torch.Tensor, nb: int) -> torch.Tensor:
    raw = raw.reshape(nb, 34)
    d = _f16(raw[:, :2]).reshape(nb, 1)
    q = raw[:, 2:34].contiguous().view(torch.int8).to(torch.float32)
    return q * d


def _q4_k(raw: torch.Tensor, nsb: int):
    """[nsb * 144] -> (codes u8 [nsb, 256], scales [nsb, 8], zs [nsb, 8]):
    one (scale, min) per 32-element sub-group; v = q*scale - zs."""
    raw = raw.reshape(nsb, 144)
    d = _f16(raw[:, :2]).reshape(nsb, 1)
    dmin = _f16(raw[:, 2:4]).reshape(nsb, 1)
    s_ = raw[:, 4:16]  # 12 bytes: 8x 6-bit scales + 8x 6-bit mins
    lo, hi, mid = s_[:, 0:4], s_[:, 4:8], s_[:, 8:12]
    sc = torch.cat([lo & 63, (mid & 0xF) | ((lo >> 6) << 4)], dim=1).to(torch.float32)
    mn = torch.cat([hi & 63, (mid >> 4) | ((hi >> 6) << 4)], dim=1).to(torch.float32)
    # 32-byte chunk n covers elements 64n .. 64n+63: low nibbles, then high
    qs = raw[:, 16:144].reshape(nsb, 4, 1, 32)
    codes = torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(nsb, 256)
    return codes, d * sc, dmin * mn


def _q6_k_float(raw: torch.Tensor, nsb: int) -> torch.Tensor:
    """[nsb * 210] -> float [nsb, 256] (dequant only; re-quantized to int4 by
    the loader when it lands in a linear)."""
    raw = raw.reshape(nsb, 210)
    ql = raw[:, :128].reshape(nsb, 2, 64)
    qh = raw[:, 128:192].reshape(nsb, 2, 1, 32)
    sc = raw[:, 192:208].contiguous().view(torch.int8).to(torch.float32)
    d = _f16(raw[:, 208:210]).reshape(nsb, 1)
    low = torch.stack([ql[:, :, :32] & 0xF, ql[:, :, 32:] & 0xF,
                       ql[:, :, :32] >> 4, ql[:, :, 32:] >> 4], dim=2)  # [nsb, 2, 4, 32]
    shifts = torch.arange(0, 8, 2, device=raw.device, dtype=torch.uint8).reshape(1, 1, 4, 1)
    q = (low | (((qh >> shifts) & 3) << 4)).to(torch.float32) - 32
    # element 16i .. 16i+15 of the 256 takes scale i
    y = sc.repeat_interleave(16, dim=1) * q.reshape(nsb, 256)
    return y * d


def _tensor_bytes(info: TensorInfo) -> int:
    n = int(np.prod(info.shape))
    if info.ggml_type not in BLOCK:
        raise NotImplementedError(
            f"{info.name}: ggml type {info.ggml_type} not supported "
            f"(supported: F32/F16/BF16/Q4_0/Q4_1/Q8_0/Q4_K/Q6_K — Q5_K/"
            f"Q5_0/Q5_1/Q3_K/Q2_K files need a different llama.cpp "
            f"quantization, e.g. Q4_K_M)"
        )
    be, bb = BLOCK[info.ggml_type]
    if n % be:
        raise ValueError(f"{info.name}: {info.shape} is not whole blocks of {be}")
    return n // be * bb


def _raw(info: TensorInfo, mm, data_start: int, device) -> torch.Tensor:
    """The tensor's bytes as a uint8 tensor on ``device`` (one host copy)."""
    lo = data_start + info.offset
    raw = torch.from_numpy(np.array(mm[lo: lo + _tensor_bytes(info)]))
    return raw.to(device)


def load_tensor_float(info: TensorInfo, mm, data_start: int,
                      device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Any supported tensor -> float32 tensor of info.shape on ``device``."""
    raw = _raw(info, mm, data_start, device)
    n = int(np.prod(info.shape))
    t = info.ggml_type
    if t == F32:
        out = raw.view(torch.float32)
    elif t == F16:
        out = _f16(raw)
    elif t == BF16:
        out = raw.view(torch.bfloat16).to(torch.float32)
    elif t in (Q4_0, Q4_1):
        c, s, zs = (_q4_0 if t == Q4_0 else _q4_1)(raw, n // 32)
        out = c.to(torch.float32) * s[:, None] - zs[:, None]
    elif t == Q8_0:
        out = _q8_0_float(raw, n // 32)
    elif t == Q4_K:
        c, s, zs = _q4_k(raw, n // 256)
        out = c.reshape(-1, 8, 32).to(torch.float32) * s[:, :, None] - zs[:, :, None]
    elif t == Q6_K:
        out = _q6_k_float(raw, n // 256)
    else:
        raise NotImplementedError(
            f"{info.name}: ggml type {t} not supported "
            f"(supported: F32/F16/BF16/Q4_0/Q4_1/Q8_0/Q4_K/Q6_K)"
        )
    return out.reshape(info.shape)


def load_tensor_q4(
    info: TensorInfo, mm, data_start: int, device: torch.device = torch.device("cpu"),
) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Exact int4 view of a 2D Q4_0/Q4_1/Q4_K tensor: (codes u8 [out, in],
    scales f32 [out, in // 32], zs f32 [out, in // 32]) with
    v = codes * scales - zs, on ``device``; None if the type has no exact
    int4 form (the caller dequantizes and re-quantizes)."""
    t = info.ggml_type
    if t not in (Q4_0, Q4_1, Q4_K) or len(info.shape) != 2:
        return None
    raw = _raw(info, mm, data_start, device)
    out, k = info.shape
    n = out * k
    if t == Q4_K:
        c, s, zs = _q4_k(raw, n // 256)
    else:
        c, s, zs = (_q4_0 if t == Q4_0 else _q4_1)(raw, n // 32)
    return c.reshape(out, k), s.reshape(out, k // 32), zs.reshape(out, k // 32)


def _unpermute_rows(arr: torch.Tensor, n_head: int) -> torch.Tensor:
    """Invert llama.cpp's per-head q/k row permutation.

    convert_hf_to_gguf.py permutes q_proj / k_proj OUT rows per head from
    the HF rotate-half layout to ggml's interleaved-RoPE layout:
    ggml_row[2j + i] = hf_row[i*hd/2 + j]. The port's rope is the HF
    rotate-half one, so the rows are permuted back on import (quantized
    tensors permute exactly: blocks run along the IN dim)."""
    hd = arr.shape[0] // n_head
    idx = torch.cat([2 * torch.arange(hd // 2), 2 * torch.arange(hd // 2) + 1])
    full = (torch.arange(n_head)[:, None] * hd + idx[None, :]).reshape(-1)
    return arr[full.to(arr.device)]


# -- model-level loader ---------------------------------------------------------

def _rope_scaling_meta(meta, a: str) -> Optional[dict]:
    st = str(meta.get(f"{a}.rope.scaling.type", "") or "")
    if not st or st == "none":
        return None
    d = {"rope_type": st, "factor": float(meta.get(f"{a}.rope.scaling.factor", 1.0))}
    oc = meta.get(f"{a}.rope.scaling.original_context_length")
    if oc is not None:
        d["original_max_position_embeddings"] = int(oc)
    af = meta.get(f"{a}.rope.scaling.attn_factor")
    if af is not None:
        d["attention_factor"] = float(af)
    return d


def gguf_config(meta, tensors):
    """The ModelConfig of a llama-architecture GGUF file's metadata."""
    from quick_tpu_torch.config import ModelConfig

    arch = str(meta.get("general.architecture", "llama"))
    if arch not in ("llama", "mistral"):
        raise NotImplementedError(f"GGUF architecture '{arch}' (llama/mistral supported)")
    a = arch

    def mi(key):
        v = meta.get(f"{a}.{key}")
        if v is None:
            raise KeyError(f"{a}.{key} missing from GGUF metadata")
        return v

    vocab = tensors["token_embd.weight"].shape[0]
    return ModelConfig(
        vocab_size=int(meta.get(f"{a}.vocab_size", vocab)),
        hidden_size=int(mi("embedding_length")),
        intermediate_size=int(mi("feed_forward_length")),
        num_hidden_layers=int(mi("block_count")),
        num_attention_heads=int(mi("attention.head_count")),
        num_key_value_heads=int(meta.get(f"{a}.attention.head_count_kv",
                                         mi("attention.head_count"))),
        max_position_embeddings=int(meta.get(f"{a}.context_length", 4096)),
        rms_norm_eps=float(meta.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(meta.get(f"{a}.rope.freq_base", 10000.0)),
        rope_scaling=_rope_scaling_meta(meta, a),
        model_type="llama",  # llama.cpp writes mistral as arch 'llama' too
    )


def load_linear(gg, names, unpermute: int = 0,
                device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """GGUF linears [out, in] concatenated along OUT, as the QTPU tensors
    ``qweight`` int32 [in // 8, N], ``scales`` and ``zeros_x_scales`` f32
    [in // 32, N] on ``device``. ``gg`` is :func:`read_gguf`'s result;
    ``unpermute`` the head count of a q / k projection (0: none). Q4 types
    import exactly (on ``device``); others are dequantized and re-quantized
    at g=32 on the CPU."""
    from quick_tpu_torch.quantize.numerics import quantize_tensor
    from quick_tpu_torch.quantize.packing import pack_qtpu_tensor

    _, tensors, data_start, mm = gg
    cs, ss, zss = [], [], []
    for nm in names:
        info = tensors[nm]
        q4 = load_tensor_q4(info, mm, data_start, device)
        if q4 is None:
            w = load_tensor_float(info, mm, data_start)  # [out, in], CPU
            if unpermute:
                w = _unpermute_rows(w, unpermute)
            qt = quantize_tensor(w.t().contiguous(), group_size=GROUP)  # [in, out]
            codes, s, zs = qt.q, qt.scales, qt.zeros * qt.scales
        else:
            codes, s, zs = q4  # [out, K] / [out, K // G]
            if unpermute:
                codes, s, zs = (_unpermute_rows(t, unpermute) for t in (codes, s, zs))
            codes, s, zs = (t.t() for t in (codes, s, zs))  # [K, N] / [K // G, N]
        cs.append(codes.to(device))
        ss.append(s.to(device))
        zss.append(zs.to(device))
    return {
        "qweight": pack_qtpu_tensor(torch.cat(cs, dim=1).contiguous(), GROUP),
        "scales": torch.cat(ss, dim=1).to(torch.float32).contiguous(),
        "zeros_x_scales": torch.cat(zss, dim=1).to(torch.float32).contiguous(),
    }


def load_gguf(path: str, lm_head_float: bool = True, device=None):
    """Load a llama-architecture GGUF file into (ModelParams, ModelConfig,
    QuantConfig) on ``device`` (the card unless given "cpu"). Q4_0 / Q4_1 /
    Q4_K linears import bit-exactly at group size 32; other quant types are
    dequantized and re-quantized to int4 g=32, so every projection rides
    the small-group kernel."""
    from quick_tpu_torch.config import QuantConfig
    from quick_tpu_torch.device import resolve_device
    from quick_tpu_torch.models.convert import params_from_flat
    from quick_tpu_torch.quantize.numerics import quantize_tensor
    from quick_tpu_torch.quantize.packing import pack_qtpu_tensor

    dev = resolve_device(device)
    gg = read_gguf(path)
    meta, tensors, data_start, mm = gg
    cfg = gguf_config(meta, tensors)

    def bf16(name):
        # float tensors load as bf16, as the HF importer loads them
        return load_tensor_float(tensors[name], mm, data_start, dev).to(torch.bfloat16)

    flat: Dict[str, torch.Tensor] = {"embed": bf16("token_embd.weight"),
                                     "final_norm": bf16("output_norm.weight")}
    if "output.weight" in tensors:
        head = load_tensor_float(tensors["output.weight"], mm, data_start, dev)  # [vocab, D]
    else:
        head = flat["embed"]  # tied embeddings
    if lm_head_float:
        flat["lm_head.weight"] = head.t().to(torch.bfloat16).contiguous()
    else:
        qt = quantize_tensor(head.t().cpu(), group_size=GROUP)
        flat["lm_head.qweight"] = pack_qtpu_tensor(qt.q, GROUP).to(dev)
        flat["lm_head.scales"] = qt.scales.to(dev)
        flat["lm_head.zeros_x_scales"] = (qt.zeros * qt.scales).to(dev)
    del head
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    for i in range(cfg.num_hidden_layers):
        b, p = f"blk.{i}", f"blocks.{i}"
        flat[f"{p}.attn_norm"] = bf16(f"{b}.attn_norm.weight")
        flat[f"{p}.mlp_norm"] = bf16(f"{b}.ffn_norm.weight")
        parts = [load_linear(gg, [f"{b}.attn_q.weight"], hq, dev),
                 load_linear(gg, [f"{b}.attn_k.weight"], hkv, dev),
                 load_linear(gg, [f"{b}.attn_v.weight"], 0, dev)]
        # the fused qkv: the packed planes of q, k and v concatenated on N
        for suf in ("qweight", "scales", "zeros_x_scales"):
            flat[f"{p}.attn.qkv.{suf}"] = torch.cat([q[suf] for q in parts], dim=1)
        del parts
        for name, srcs in (("attn.o", ["attn_output"]), ("mlp.gate_up", ["ffn_gate", "ffn_up"]),
                           ("mlp.down", ["ffn_down"])):
            lin = load_linear(gg, [f"{b}.{s}.weight" for s in srcs], 0, dev)
            for suf, t in lin.items():
                flat[f"{p}.{name}.{suf}"] = t
    params = params_from_flat(flat, cfg, device=dev, group_size=GROUP)
    if "rope_freqs.weight" in tensors:
        # Llama-3.1-style files bake the rope scaling into per-dim frequency
        # factors (inv_freq /= factor) instead of metadata: rebuild the
        # cos / sin tables from them, in float64 as the JAX package does
        ff = load_tensor_float(tensors["rope_freqs.weight"], mm, data_start).reshape(-1)
        hd = cfg.rotary_dim or cfg.head_dim
        half = np.arange(0, hd, 2, dtype=np.float64) / hd
        inv = (1.0 / cfg.rope_theta ** half) / ff.numpy().astype(np.float64)
        ang = np.arange(cfg.max_position_embeddings, dtype=np.float64)[:, None] * inv[None, :]
        params.rope_cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev)
        params.rope_sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev)
    return params, cfg, QuantConfig(w_bit=4, q_group_size=GROUP, version="qtpu")
