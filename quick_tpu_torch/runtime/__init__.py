from quick_tpu_torch.modules.paged_cache import PagedKVCache
from quick_tpu_torch.runtime.generate import (
    SamplingParams,
    beam_generate,
    decode_loop,
    decode_step,
    filter_logits,
    generate,
    make_cache,
    prefill,
    sample_token,
    sample_token_rows,
)
from quick_tpu_torch.runtime.serving import Engine, Request

__all__ = [
    "Engine",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "beam_generate",
    "decode_loop",
    "decode_step",
    "filter_logits",
    "generate",
    "make_cache",
    "prefill",
    "sample_token",
    "sample_token_rows",
]
