"""Dense KV cache (port of ``quick_tpu/modules/cache.py::KVCache``).

Storage is head-major [L, B, H_kv, S_max, D], as in the JAX package, so an
attention call reads one layer's [B, H_kv, S, D] view without a transpose.
The JAX cache is immutable and returns updated copies; this one is written
IN PLACE (``update``, and the fused decode kernel), and the methods return
the cache object itself or a view sharing its storage. Every row of the
batch has the same number of cached tokens: ``length`` holds it as a host
integer (shapes, routing, the overrun check) and ``length_dev`` as an int32
[1] on the cache's device, which a one-token step reads (positions, the
decode kernels' lengths, the write index: ``write_start``), so a captured
step moves on replay. Like ``length``, ``length_dev`` belongs to the cache
object: ``advance``, the only way a forward moves the length, returns a new
one, so an older cache object keeps its length. A decode loop that replays
a captured step keeps its own ``length_dev`` and copies each step's into it
(``runtime/generate.py``).
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
    length_dev: Optional[torch.Tensor] = None  # int32 [1]: ``length`` on the
    # device (made from ``length`` when not given)

    def __post_init__(self):
        if self.length_dev is None:
            self.length_dev = torch.full(
                (1,), int(self.length), dtype=torch.int32, device=self.k.device)

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
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def check_room(self, S: int, start: Optional[int] = None) -> None:
        """Raise unless ``S`` tokens fit at ``start`` (default: the host
        length, which mirrors ``length_dev``: the kernels that read the
        device length cannot raise)."""
        start = self.length if start is None else start
        if start + S > self.max_seq:
            raise ValueError(f"writing {S} tokens at {start} overruns max_seq {self.max_seq}")

    def update(
        self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
        start: "int | torch.Tensor",
    ) -> "KVCache":
        """Write k_new / v_new [B, S, H_kv, D] at ``start`` of ``layer``, in
        place: ``length`` or ``length_dev`` (``write_start``). Only the
        incoming tokens transpose to head-major."""
        S = k_new.shape[1]
        self.check_room(S, None if isinstance(start, torch.Tensor) else start)
        k_new = k_new.transpose(1, 2).to(self.k.dtype)
        v_new = v_new.transpose(1, 2).to(self.v.dtype)
        if isinstance(start, torch.Tensor):
            idx = start.to(torch.int64) + torch.arange(S, device=start.device)
            self.k[layer].index_copy_(2, idx, k_new)
            self.v[layer].index_copy_(2, idx, v_new)
        else:
            self.k[layer, :, :, start:start + S] = k_new
            self.v[layer, :, :, start:start + S] = v_new
        return self

    def layer(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s K/V as [B, H_kv, S_max, D] views."""
        return self.k[i], self.v[i]

    def take_rows(self, src: torch.Tensor) -> "KVCache":
        """Reorder the batch rows in place: row r becomes old row
        ``src[r]`` in every layer of k and v (beam search's reorder, the
        JAX package's ``take(src, axis=1)`` over the cache pytree,
        runtime/generate.py:296-300). The lengths stay: every row has the
        same one. A torch gather, capturable in a graph."""
        self.k.copy_(self.k.index_select(1, src))
        self.v.copy_(self.v.index_select(1, src))
        return self

    def with_length(self, length: int) -> "KVCache":
        """Both lengths set to ``length`` (a forward moves them with
        ``advance``)."""
        return dataclasses.replace(self, length=int(length), length_dev=None)

    def advance(self, n: int) -> "KVCache":
        """The cache ``n`` tokens longer, both lengths (the device one
        computed on the device, no host sync)."""
        return dataclasses.replace(self, length=self.length + n, length_dev=self.length_dev + n)


def write_start(cache, S: int):
    """Where a forward of ``S`` tokens writes its k/v: a one-token step over
    the dense cache at ``length_dev`` (a captured step writes at the length
    of its replay), otherwise at ``cache.length`` (the dense cache's host
    int, or the paged cache's [B] device tensor)."""
    if S == 1 and isinstance(cache, KVCache):
        return cache.length_dev
    return cache.length
