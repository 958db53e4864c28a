"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``repro_torch/csrc/<name>.cu`` becomes ``lib<name>.so``: a shared
library with a plain C interface, compiled for Hopper (``sm_90a``).  The
libraries go to ``repro_torch/_build/<hash>/`` (ignored by git), where
``<hash>`` covers every source file and the compiler flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built or
loaded at import time: the first launch of a kernel builds its library.
"""
from __future__ import annotations

import contextlib

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch are built on first use")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / source_hash() / f"lib{name}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all of them by default), one ``nvcc``
    per source, all started together.  Returns seconds per library
    built; raises with the compiler's output if any build fails.  The
    ``-Xptxas=-v`` report (registers, shared memory, spills) is kept
    beside each library as ``lib<name>.log``."""
    names = kernel_names() if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t, name: str, dtype, shape: tuple, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (on ``device`` when given) — what a kernel's pointer
    arithmetic assumes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device) -> ctypes.c_void_p:
    """The current stream's raw handle on ``device`` (a CUDA device with an
    index, as a tensor's is), read without building a ``torch.cuda.Stream``:
    every launch pays for this on the host."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


_CURRENT = contextlib.nullcontext()


def on_device(device):
    """A context in which ``device`` is the current CUDA device, the one
    a kernel's launch code reads (``cudaGetDevice``: its shared-memory
    opt-in, its SM count, the launch itself).  A tensor on another card
    than the current one would otherwise launch there.  Free when
    ``device`` is already current (one host call), as it is inside a
    sharded program's stage."""
    if torch._C._cuda_getDevice() == device.index:
        return _CURRENT
    return torch.cuda.device(device)
