"""Streaming tar-shard (webdataset-format) pipeline.

The PyTorch port's copy of ``libra_tpu/data/webdata.py``, in place of the
reference's `webdataset` DataPipeline (laion_dataset.py:60-67): resampled
shards -> tar -> grouped samples -> shuffle buffer -> decode -> map, with
skip-and-continue error handling at every stage (the reference's
wds.warn_and_continue). Pure Python; libra_tpu's native C++ reader is
ROADMAP A12. The per-process split reads the process index and count
from torch.distributed when it is initialized.
"""

from __future__ import annotations

import io
import json
import logging
import random
import tarfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)


def is_remote(loc: str) -> bool:
    return loc.startswith(("pipe:", "http://", "https://"))


def expand_shards(location) -> List[str]:
    """Accept a list of paths, a glob pattern, or a brace pattern
    `prefix-{000..123}.tar`. Remote sources -- `pipe:<shell command>` and
    http(s) URLs (the reference's wds.ResampledShards url/pipe semantics,
    laion_dataset.py:61) -- support brace expansion but not globbing."""
    if isinstance(location, (list, tuple)):
        out: List[str] = []
        for loc in location:
            out.extend(expand_shards(loc))
        return out
    loc = str(location)
    if "{" in loc and ".." in loc:
        head, rest = loc.split("{", 1)
        spec, tail = rest.split("}", 1)
        lo, hi = spec.split("..")
        width = len(lo)
        return [f"{head}{i:0{width}d}{tail}" for i in range(int(lo), int(hi) + 1)]
    if is_remote(loc):
        return [loc]
    if any(ch in loc for ch in "*?["):
        p = Path(loc)
        return sorted(str(x) for x in p.parent.glob(p.name))
    return [loc]


class _PipeStream:
    """Subprocess-stdout stream that reaps the child on close."""

    def __init__(self, cmd: str):
        import subprocess
        self._proc = subprocess.Popen(cmd, shell=True,
                                      stdout=subprocess.PIPE)
        self.read = self._proc.stdout.read

    def close(self):
        self._proc.stdout.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_shard(shard_path: str):
    """Open a shard as a (possibly non-seekable) binary stream: local file,
    `pipe:<shell command>` (subprocess stdout), or http(s) URL."""
    if shard_path.startswith("pipe:"):
        return _PipeStream(shard_path[len("pipe:"):])
    if shard_path.startswith(("http://", "https://")):
        import urllib.request
        return urllib.request.urlopen(shard_path)
    return open(shard_path, "rb")


def tar_samples(shard_path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key (path minus last extension) into sample
    dicts {"__key__": key, ext: bytes, ...}. Streams (mode "r|*"), so
    non-seekable pipe/http sources work."""
    with open_shard(shard_path) as fileobj, \
            tarfile.open(fileobj=fileobj, mode="r|*") as tf:
        current: Dict[str, Any] = {}
        cur_key: Optional[str] = None
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if "." not in name:
                continue
            key, ext = name.rsplit(".", 1)
            if cur_key is not None and key != cur_key and current:
                yield current
                current = {}
            cur_key = key
            f = tf.extractfile(member)
            if f is None:
                continue
            current["__key__"] = key
            current[ext.lower()] = f.read()
        if current:
            yield current


def shuffled(it: Iterator, bufsize: int, initial: int,
             rng: random.Random) -> Iterator:
    """Reservoir shuffle buffer (wds.shuffle semantics)."""
    buf: List[Any] = []
    for x in it:
        buf.append(x)
        if len(buf) < max(initial, 1):
            continue
        if len(buf) >= bufsize:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def decode_sample(sample: Dict[str, bytes]) -> Dict[str, Any]:
    """Decode jpg/png -> PIL RGB, json -> dict, txt -> str."""
    from PIL import Image
    out: Dict[str, Any] = {"__key__": sample.get("__key__")}
    for k, v in sample.items():
        if k == "__key__":
            continue
        if k in ("jpg", "jpeg", "png", "webp"):
            out["jpg"] = Image.open(io.BytesIO(v)).convert("RGB")
        elif k == "json":
            out["json"] = json.loads(v)
        elif k in ("txt", "text"):
            out["txt"] = v.decode("utf-8")
        else:
            out[k] = v
    return out


def resolve_process(process_index: Optional[int],
                    process_count: Optional[int]) -> tuple:
    """Default the per-process split to torch.distributed's rank and world
    size when it is initialized, else (0, 1); explicit values win (tests,
    custom launch)."""
    if process_index is not None and process_count is not None:
        return process_index, process_count
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def fold_process_seed(seed: int, process_index: int) -> int:
    """Distinct per-host stream seed (the reference's per-rank resampled
    webdataset pipelines; a shared seed would feed every host identical
    data on a multi-node run)."""
    return seed + 1000003 * process_index


class ShardStream:
    """Infinite resampled-shard sample stream with per-stage
    skip-and-continue error handling.

    Multi-process: with process_count > 1 (from torch.distributed's world
    size or passed explicitly), resampled streams get a
    per-process seed fold, and sequential (resample=False) streams take a
    disjoint stride split of the shard list."""

    def __init__(self, location, *, shuffle_bufsize: int = 5000,
                 shuffle_initial: int = 1000, seed: int = 0,
                 deterministic: bool = True, resample: bool = True,
                 map_fn: Optional[Callable] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.shards = expand_shards(location)
        if not self.shards:
            raise FileNotFoundError(f"no shards match {location}")
        pi, pc = resolve_process(process_index, process_count)
        if not resample and pc > 1:
            split = self.shards[pi::pc]
            if split:       # fewer shards than hosts: all hosts read all
                self.shards = split
        self.shuffle_bufsize = shuffle_bufsize
        self.shuffle_initial = shuffle_initial
        self.seed = fold_process_seed(seed, pi)
        self.deterministic = deterministic
        self.resample = resample
        self.map_fn = map_fn

    def _shard_iter(self, rng: random.Random) -> Iterator[str]:
        if self.resample:
            while True:
                yield rng.choice(self.shards)
        else:
            order = list(self.shards)
            rng.shuffle(order)
            yield from order

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = random.Random(self.seed if self.deterministic else None)

        def raw():
            for shard in self._shard_iter(rng):
                try:
                    yield from tar_samples(shard)
                except Exception as e:  # noqa: BLE001
                    logger.warning("shard %s failed: %r -- skipping", shard, e)

        for sample in shuffled(raw(), self.shuffle_bufsize,
                               self.shuffle_initial, rng):
            try:
                decoded = decode_sample(sample)
                if self.map_fn is not None:
                    decoded = self.map_fn(decoded)
                if decoded is not None:
                    yield decoded
            except Exception as e:  # noqa: BLE001
                logger.warning("sample %s failed: %r -- skipping",
                               sample.get("__key__"), e)
