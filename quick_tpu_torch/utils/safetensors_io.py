"""A reader and a writer of the safetensors format, in numpy and torch.

The port reads and writes the same checkpoint files as the JAX package
without the ``safetensors``, ``ml_dtypes`` or ``transformers`` packages.
A file is an 8-byte little-endian header length, a JSON header mapping
each tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end) into the data section (plus an optional ``__metadata__`` dict of
strings), then the raw little-endian data.

The reader maps the file and loads one tensor at a time (``np.memmap`` at
the tensor's offset), the streaming contract of the JAX package's
``_LazyRaw`` (``quick_tpu/utils/checkpoint.py:588``): converting a large
checkpoint never holds all of it in host memory at once. Tensors come back
as CPU ``torch.Tensor``s; bf16 goes through its int16 bit pattern (numpy
has no bf16 without ``ml_dtypes``), as ``models/convert.py::to_tensor``
does. The writer takes tensors (bf16 included) or numpy arrays.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

#: safetensors dtype -> (torch dtype, numpy dtype of the stored bytes)
DTYPES: Dict[str, Tuple[torch.dtype, np.dtype]] = {
    "BF16": (torch.bfloat16, np.dtype("<i2")),
    "F16": (torch.float16, np.dtype("<f2")),
    "F32": (torch.float32, np.dtype("<f4")),
    "I64": (torch.int64, np.dtype("<i8")),
    "I32": (torch.int32, np.dtype("<i4")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("?")),
}
_BY_TORCH = {t: name for name, (t, _) in DTYPES.items()}
_BY_NUMPY = {n: name for name, (_, n) in DTYPES.items() if name != "BF16"}

ArrayLike = Union[np.ndarray, torch.Tensor]


def _describe(a: ArrayLike) -> Tuple[str, Tuple[int, ...], int]:
    """(safetensors dtype, shape, bytes) of a tensor or numpy array, read
    from its metadata (a tensor on the card is not copied)."""
    if isinstance(a, torch.Tensor):
        if a.dtype not in _BY_TORCH:
            raise TypeError(f"dtype {a.dtype} has no safetensors name here")
        return _BY_TORCH[a.dtype], tuple(a.shape), a.numel() * a.element_size()
    arr = np.asarray(a)
    key = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
    if key not in _BY_NUMPY:
        raise TypeError(f"dtype {arr.dtype} has no safetensors name here")
    return _BY_NUMPY[key], arr.shape, arr.nbytes


def _host_bytes(a: ArrayLike, name: str) -> np.ndarray:
    """The data of ``a`` as a flat, contiguous little-endian numpy array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        return arr.reshape(-1)
    return np.ascontiguousarray(a, dtype=DTYPES[name][1]).reshape(-1)


def save_file(
    tensors: Mapping[str, ArrayLike], path: str,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write ``tensors`` to ``path`` in the safetensors format, in name
    order, copying one tensor at a time to the host."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        dt, shape, n = _describe(tensors[name])
        header[name] = {"dtype": dt, "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)  # the data section starts 8-aligned
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for name in names:
            flat = _host_bytes(tensors[name], header[name]["dtype"])
            if flat.nbytes:
                flat.tofile(f)
    os.replace(tmp, path)


class SafeOpen:
    """One safetensors file, mapped: ``keys()``, ``metadata()`` and
    ``get_tensor(name)`` (a CPU tensor copied out of the map)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None) or {}
        self._info = header
        self._data_start = 8 + n

    def keys(self):
        return list(self._info)

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def get_numpy(self, name: str) -> np.ndarray:
        """The stored bytes as a numpy array (bf16 as its int16 pattern)."""
        info = self._info[name]
        if info["dtype"] not in DTYPES:
            raise TypeError(f"{self.path}: {name} has unsupported dtype {info['dtype']}")
        np_dt = DTYPES[info["dtype"]][1]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dt.itemsize:
            raise ValueError(f"{self.path}: {name} spans {end - begin} bytes for shape {shape}")
        if count == 0:
            return np.zeros(shape, np_dt)
        mm = np.memmap(self.path, dtype=np_dt, mode="r", offset=self._data_start + begin,
                       shape=(count,))
        out = np.array(mm).reshape(shape)  # a copy: the map closes with it
        del mm
        return out

    def get_tensor(self, name: str) -> torch.Tensor:
        t = torch.from_numpy(self.get_numpy(name))
        return t.view(torch.bfloat16) if self._info[name]["dtype"] == "BF16" else t

