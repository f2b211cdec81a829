"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source is compiled on its own with nvcc for sm_90a into
``libra_tpu_torch/build/`` (gitignored), named by a hash of the source,
so an unchanged source is not rebuilt. nvcc's output, with ptxas'
register, shared-memory and spill report, is kept in a ``.log`` file
beside the library. The hash covers the source and the ``csrc`` headers
it includes (``#include "name.cuh"``, followed recursively), so an edit
to a shared header rebuilds every source that includes it. Each library exports plain C functions that return
the CUDA error of their launch; they are bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def tag(source: Path) -> str:
    """A hash of `source` and of every header it includes with quotes,
    resolved beside the file that includes it, recursively."""
    h = hashlib.sha256()
    seen, todo = set(), [source.resolve()]
    while todo:
        path = todo.pop()
        if path in seen or not path.is_file():   # a system header
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def build(source: Path) -> Path:
    """Compile `source` for sm_90a into BUILD_DIR unless a library of the
    same tag (source and included headers) is there. Returns the library's
    path."""
    lib = BUILD_DIR / f"{source.stem}-{tag(source)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_all(sources: Iterable[Path]) -> List[Path]:
    """Build every source at once, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = [pool.submit(build, s) for s in sources]
        return [f.result() for f in futures]


@functools.lru_cache(maxsize=None)
def function(source: Path, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `name` of `source`'s library (built at first use),
    with its argument types set and an int return (the CUDA error)."""
    fn = getattr(ctypes.CDLL(str(build(source))), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw current CUDA stream of `t`'s device, which must be the
    current device: the kernels launch there, on that stream."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{t.device} is not the current CUDA device "
                         f"(torch.cuda.set_device)")
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_launch(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
