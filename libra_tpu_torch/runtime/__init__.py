"""Native runtime: the C++ shard reader with background readahead.

The PyTorch port's counterpart of ``libra_tpu/runtime``, with its own
copy of ``shard_reader.cpp`` and the same C ABI, bound with ctypes. The
library builds with g++ at first use into ``libra_tpu_torch/build/``
(gitignored), named by a hash of the source, so an edited source
rebuilds. ``NativeShardStream`` yields the same sample dicts as
``data.webdata.ShardStream`` (which stays the pure Python fallback): the
C++ thread parses tars, groups samples and keeps the shuffle reservoir;
Python only decodes images and parses the json.
"""

from __future__ import annotations

import ctypes
import io
import json
import logging
import os
import shlex
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterator

from libra_tpu_torch.data.webdata import (expand_shards, fold_process_seed,
                                          resolve_process)
from libra_tpu_torch.ops._build import BUILD_DIR, tag

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "shard_reader.cpp"


class _LsrSample(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_char_p),
        ("jpg", ctypes.POINTER(ctypes.c_uint8)),
        ("jpg_len", ctypes.c_uint64),
        ("json", ctypes.POINTER(ctypes.c_uint8)),
        ("json_len", ctypes.c_uint64),
        ("owner", ctypes.c_void_p),
    ]


def build_library(force: bool = False) -> Path:
    """Compile shard_reader.cpp with g++ into BUILD_DIR unless a library of
    the source's hash is there (force: rebuild). Returns its path."""
    lib = BUILD_DIR / f"{SOURCE.stem}-{tag(SOURCE)}.so"
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(SOURCE), "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


_lib_handle = None


def _load():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.lsr_open.restype = ctypes.c_void_p
        lib.lsr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_ulong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.lsr_next.restype = ctypes.c_int
        lib.lsr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_LsrSample)]
        lib.lsr_free_sample.argtypes = [ctypes.POINTER(_LsrSample)]
        lib.lsr_close.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
    return _lib_handle


def native_available() -> bool:
    """Whether the library builds and loads; logs a warning when not."""
    try:
        _load()
        return True
    except Exception as e:  # noqa: BLE001
        logger.warning("native shard reader unavailable: %r", e)
        return False


class NativeShardStream:
    """Drop-in for webdata.ShardStream backed by the C++ reader. The
    order of the samples is fixed by the seed (one reader thread, one
    mt19937_64); shuffle_initial is ShardStream's and unused here."""

    def __init__(self, location, *, shuffle_bufsize: int = 5000,
                 queue_depth: int = 256, seed: int = 0,
                 resample: bool = True, map_fn=None,
                 deterministic: bool = True, shuffle_initial: int = 0,
                 process_index=None, process_count=None):
        self.shards = expand_shards(location)
        if not self.shards:
            raise FileNotFoundError(f"no shards match {location}")
        # http(s) sources stream through a curl pipe (the C++ reader opens
        # a "pipe:" shard with popen). shlex.quote: the URL reaches a
        # shell, and an untrusted shard list must not inject commands
        self.shards = [f"pipe:curl -fsSL {shlex.quote(s)}"
                       if s.startswith(("http://", "https://")) else s
                       for s in self.shards]
        pi, pc = resolve_process(process_index, process_count)
        if not resample and pc > 1:
            split = self.shards[pi::pc]
            if split:
                self.shards = split
        self.shuffle_bufsize = shuffle_bufsize
        self.queue_depth = queue_depth
        self.seed = fold_process_seed(seed, pi) if deterministic else 0
        self.resample = resample
        self.map_fn = map_fn

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        from PIL import Image
        lib = _load()
        arr = (ctypes.c_char_p * len(self.shards))(
            *[s.encode() for s in self.shards])
        h = lib.lsr_open(arr, len(self.shards), self.seed,
                         self.shuffle_bufsize, self.queue_depth,
                         1 if self.resample else 0)
        if not h:
            raise RuntimeError("lsr_open failed")
        s = _LsrSample()
        try:
            while True:
                if lib.lsr_next(h, ctypes.byref(s)) != 0:
                    return
                try:
                    out: Dict[str, Any] = {
                        "__key__": s.key.decode(errors="replace")}
                    if s.jpg_len:
                        jpg = ctypes.string_at(s.jpg, s.jpg_len)
                        out["jpg"] = Image.open(io.BytesIO(jpg)).convert("RGB")
                    if s.json_len:
                        out["json"] = json.loads(
                            ctypes.string_at(s.json, s.json_len))
                    if self.map_fn is not None:
                        out = self.map_fn(out)
                    if out is not None:
                        yield out
                except Exception as e:  # noqa: BLE001
                    logger.warning("sample failed: %r -- skipping", e)
                finally:
                    lib.lsr_free_sample(ctypes.byref(s))
        finally:
            lib.lsr_close(h)
