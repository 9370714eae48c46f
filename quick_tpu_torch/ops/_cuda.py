"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` functions
taking pointers, ints, floats and the stream, returning ``cudaError_t``)
and is compiled by ``nvcc`` into its own shared library, loaded with
``ctypes``. Nothing includes PyTorch's headers, which keeps a build to
seconds. Libraries go to ``build/quick_tpu_torch/`` beside the package,
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads. ``build_all`` starts one ``nvcc`` per source at
once.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "quick_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "quick_tpu_torch are built from source at first use"
    )


class CudaKernel:
    """One ``csrc/<name>.cu`` source, its library and its launch counts.

    Each wrapper calls :meth:`launch` once per launch of its kernel, which
    adds one to ``launches`` and to ``launches_by_key[key]`` (the key names
    the variant and shape), so a run can show that it went through the
    kernel and with which shapes. :meth:`reset_counts` sets both to zero.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = source
        self.functions = dict(functions)
        self.launches = 0
        self.launches_by_key = collections.Counter()
        self.build_log = ""
        self._lib = None

    @property
    def name(self) -> str:
        return Path(self.source).stem

    def library_path(self) -> Path:
        h = hashlib.sha256()
        h.update(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in self.functions.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.qtt_error_string.argtypes = [ctypes.c_int]
        lib.qtt_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def lib(self):
        if self._lib is None:
            build_all([self])
        return self._lib

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_key.clear()

    def launch(self, fn: str, key: str, *args) -> None:
        """Call C function ``fn`` (which launches on the stream it is given
        and returns ``cudaGetLastError()``); raise on error, else count one
        launch under ``key``."""
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.qtt_error_string(err).decode()
            raise RuntimeError(f"{self.source}:{fn} failed: {msg} ({err})")
        self.launches += 1
        self.launches_by_key[key] += 1


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build (in parallel) and load every kernel not loaded yet."""
    todo: List[CudaKernel] = [k for k in kernels if k._lib is None]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in todo:
        path = k.library_path()
        if path.exists():
            log = path.with_suffix(".log")
            k.build_log = log.read_text() if log.exists() else ""
            procs.append((k, path, None, None))
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / k.source)]
        p = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((k, path, tmp, p))
    failed = []
    for k, path, tmp, p in procs:
        if p is not None:
            out, _ = p.communicate()
            k.build_log = out
            if p.returncode != 0:
                failed.append(f"--- {k.source} ---\n{out}")
                continue
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for k, path, _, _ in procs:
        k._load(path)


class ZeroedWords:
    """Per-device int32 words that a kernel leaves at zero after every
    launch (K14's grid barriers and tile counters, K3's merge counters):
    zeroed once when made, and made or grown only outside a graph capture
    (the decode graphs capture after an eager step has made them)."""

    def __init__(self, owner: str):
        self.owner = owner
        self._bufs: Dict[int, torch.Tensor] = {}

    def get(self, dev: torch.device, n: int) -> torch.Tensor:
        buf = self._bufs.get(dev.index)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.owner}'s counters are allocated by an eager launch before capture")
            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
            self._bufs[dev.index] = buf
        return buf


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle (the fast
    accessor Triton uses; ``torch.cuda.current_stream`` costs ~10 us)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Wrapper-side validation of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
