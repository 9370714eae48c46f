"""Dense KV cache (port of ``quick_tpu/modules/cache.py::KVCache``).

Storage is head-major [L, B, H_kv, S_max, D], as in the JAX package, so an
attention call reads one layer's [B, H_kv, S, D] view without a transpose.
The JAX cache is immutable and returns updated copies; this one is written
IN PLACE (``update``, and the fused decode kernel), and the methods return
the cache object itself or a view sharing its storage. ``length`` is a
host integer: every row of the batch has the same number of cached tokens.
The v slot may be wider than the k slot (``v_head_dim``): DeepSeek's MLA
latent cache holds the rope'd k_pe [L, B, 1, S_max, dr] in k and the latent
[L, B, 1, S_max, R] in v (``modules/mla.py::make_mla_cache``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from quick_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, H_kv, S_max, D]
    v: torch.Tensor
    length: int = 0

    @classmethod
    def create(
        cls, n_layers: int, batch: int, max_seq: int, n_kv: int, head_dim: int,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
        v_head_dim: Optional[int] = None,
    ) -> "KVCache":
        """A zeroed cache on ``device`` (the card unless given "cpu"); the v
        slot is ``v_head_dim`` wide when given, else ``head_dim``."""
        device = resolve_device(device)
        shape = (n_layers, batch, n_kv, max_seq, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape[:-1] + (v_head_dim or head_dim,), dtype=dtype, device=device),
            length=0,
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def update(
        self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, start: int
    ) -> "KVCache":
        """Write k_new / v_new [B, S, H_kv, D] at ``start`` of ``layer``, in
        place. Only the incoming tokens transpose to head-major."""
        S = k_new.shape[1]
        if start + S > self.max_seq:
            raise ValueError(
                f"writing {S} tokens at {start} overruns max_seq {self.max_seq}"
            )
        self.k[layer, :, :, start:start + S] = k_new.transpose(1, 2).to(self.k.dtype)
        self.v[layer, :, :, start:start + S] = v_new.transpose(1, 2).to(self.v.dtype)
        return self

    def layer(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s K/V as [B, H_kv, S_max, D] views."""
        return self.k[i], self.v[i]

    def with_length(self, length: int) -> "KVCache":
        return dataclasses.replace(self, length=int(length))