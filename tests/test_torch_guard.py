"""Guards for the port: it never imports JAX or quick_tpu, nor the
safetensors, ml_dtypes or transformers packages (the machine with the card
has none of them); its entry points refuse to run without a card unless
asked for the CPU; and chip_smoke.py fails where there is no card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_port import GGUF_Q4_0, write_llama_gguf

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import quick_tpu_torch
names = [m.name for m in pkgutil.walk_packages(quick_tpu_torch.__path__, "quick_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # the chip script imports as a module without running
banned = ("jax", "quick_tpu", "safetensors", "ml_dtypes", "transformers")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
print(len(names))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_neither_jax_nor_quick_tpu():
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=ROOT, env=_clean_env(), timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 35  # every module


def test_entry_points_need_a_card_or_explicit_cpu(monkeypatch, tmp_path):
    from quick_tpu_torch import ModelConfig
    from quick_tpu_torch.models.auto import AutoQuickModel
    from quick_tpu_torch.models.model import init_quant_params
    from quick_tpu_torch.ops.rope import rope_table
    from quick_tpu_torch.runtime import Engine, PagedKVCache, make_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(vocab_size=64, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=16)
    m = AutoQuickModel.from_random(cfg, device="cpu")
    ck = tmp_path / "ck"
    m.quantize(use_awq_search=False)
    m.save_quantized(str(ck))
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text('{"model_type": "llama"}')
    gguf = str(tmp_path / "m.gguf")
    write_llama_gguf(gguf, dict(vars(cfg)), types={n: GGUF_Q4_0 for n in (
        "attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")})
    for call in (lambda: AutoQuickModel.from_quantized(str(ck)),
                 lambda: AutoQuickModel.from_gguf(gguf),
                 lambda: AutoQuickModel.from_pretrained(str(hf)),
                 lambda: init_quant_params(cfg),
                 lambda: AutoQuickModel.from_random(cfg),
                 lambda: init_quant_params(cfg, device="cuda"),
                 lambda: make_cache(cfg, 1, 8),
                 lambda: rope_table(16, 64),
                 lambda: Engine(m.params, cfg, max_slots=2, max_seq=16, page_size=16),
                 lambda: Engine(m.params, cfg, max_slots=2, max_seq=16, page_size=16,
                                dtype=torch.int8),
                 lambda: PagedKVCache.create(1, 3, 16, 2, 16, 1, 64),
                 lambda: PagedKVCache.create(1, 3, 32, 2, 32, 1, 64, torch.int8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert m.device.type == "cpu"
    assert AutoQuickModel.from_quantized(str(ck), device="cpu").device.type == "cpu"
    assert AutoQuickModel.from_gguf(gguf, device="cpu").device.type == "cpu"
    out = m.generate(torch.zeros((1, 3), dtype=torch.long), 2)
    assert tuple(out.shape) == (1, 5)
    assert make_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"
    assert PagedKVCache.create(1, 3, 16, 2, 16, 1, 64, device="cpu").k_pages.device.type == "cpu"
    eng = Engine(m.params, cfg, max_slots=2, max_seq=16, page_size=16, chunk=4, device="cpu")
    uid = eng.submit([1, 2, 3], 2)
    assert len(eng.run()[uid]) == 2 and eng.cache.k_pages.device.type == "cpu"
    eng = Engine(m.params, cfg, max_slots=2, max_seq=16, page_size=16, chunk=4,
                 dtype=torch.int8, device="cpu")
    uid = eng.submit([1, 2, 3], 2)
    assert len(eng.run()[uid]) == 2 and eng.cache.kv_scales.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, cwd=ROOT, env=_clean_env(), timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
