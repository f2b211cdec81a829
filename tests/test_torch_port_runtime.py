"""The port's native shard reader (libra_tpu_torch.runtime) on the CPU:
tests/test_native_runtime.py's five cases on the port's reader (build,
stream, the same keys as the Python reader, a corrupt shard skipped, an
endless resampled stream), the same keys in the same order as
libra_tpu's native reader at each seed (one reader thread and one
mt19937_64 fix the order), and the port's LaionDataset on the native
reader by default, its samples equal to libra_tpu's.

libra_tpu's reader builds its library beside its source; here it is
pointed at a temporary path first (its module's _LIB), so that this file
never writes into the JAX package nor races another test's build.
"""

import numpy as np
import pytest

import libra_tpu.runtime as jruntime
from libra_tpu.data.laion import LaionDataset as JLaion
from libra_tpu.data import processors as jproc
from libra_tpu.config import CLIPVisionConfig as JClip
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu_torch import runtime
from libra_tpu_torch.config import CLIPVisionConfig
from libra_tpu_torch.data import processors as tproc
from libra_tpu_torch.data.laion import LaionDataset
from libra_tpu_torch.data.webdata import ShardStream
from libra_tpu_torch.tokenization import SimpleTextTokenizer

from tests.test_data_layer import _make_shard


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_nshards")
    _make_shard(d / "shard-000.tar", n=5, seed=0)
    _make_shard(d / "shard-001.tar", n=5, seed=1)
    (d / "corrupt.tar").write_bytes(b"this is not a tar file" * 40)
    return d


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """libra_tpu's runtime module with its library built into a temporary
    directory (unless this process loaded it already)."""
    saved = jruntime._LIB
    if jruntime._lib_handle is None:
        jruntime._LIB = tmp_path_factory.mktemp("jax_native") / "libshard_reader.so"
    try:
        assert jruntime.native_available()
        yield jruntime
    finally:
        jruntime._LIB = saved


def _keys(stream, n=None):
    it = iter(stream)
    return [s["__key__"] for s in (it if n is None else (next(it) for _ in range(n)))]


def test_native_builds():
    assert runtime.native_available()
    lib = runtime.build_library()
    assert lib.parent == runtime.BUILD_DIR and lib.suffix == ".so"
    assert runtime.build_library() == lib          # built once per source


def test_native_stream_samples(shards):
    out = list(runtime.NativeShardStream(
        str(shards / "shard-00*.tar"), shuffle_bufsize=4, seed=0, resample=False))
    assert len(out) == 10
    assert len({s["__key__"] for s in out}) == 10
    for s in out:
        assert s["jpg"].mode == "RGB"
        assert "caption" in s["json"]


def test_native_matches_python_keys(shards):
    """Both of the port's readers surface the same sample set (the orders
    differ)."""
    native = set(_keys(runtime.NativeShardStream(
        str(shards / "shard-00*.tar"), resample=False, seed=1)))
    python = set(_keys(ShardStream(str(shards / "shard-00*.tar"), shuffle_bufsize=4,
                                   shuffle_initial=1, seed=1, resample=False)))
    assert native == python and len(native) == 10


def test_native_corrupt_shard_skipped(shards):
    out = list(runtime.NativeShardStream(
        [str(shards / "corrupt.tar"), str(shards / "shard-000.tar")],
        resample=False, seed=0))
    assert len(out) == 5  # the corrupt shard contributes nothing, no crash


def test_native_resample_infinite(shards):
    it = iter(runtime.NativeShardStream(str(shards / "shard-00*.tar"),
                                        shuffle_bufsize=8, seed=0, resample=True))
    assert len([next(it) for _ in range(25)]) == 25   # more than one epoch


@pytest.mark.parametrize("kw", [
    dict(seed=0, shuffle_bufsize=4, resample=False),
    dict(seed=1, shuffle_bufsize=8, resample=False),
    dict(seed=3, shuffle_bufsize=4, resample=True, n=23),
    dict(seed=3, shuffle_bufsize=4, resample=True, process_index=1,
         process_count=2, n=23),
], ids=["seed0", "seed1", "resampled", "process1"])
def test_native_order_matches_jax(shards, jax_native, kw):
    kw = dict(kw)
    n = kw.pop("n", None)
    loc = str(shards / "shard-00*.tar")
    got = _keys(runtime.NativeShardStream(loc, **kw), n)
    want = _keys(jax_native.NativeShardStream(loc, **kw), n)
    assert got == want
    again = _keys(runtime.NativeShardStream(loc, **kw), n)
    assert again == got                           # fixed by the seed


def test_laion_takes_the_native_reader(shards, jax_native):
    loc = str(shards / "shard-00*.tar")
    procs = (tproc.LibraImageProcessor(CLIPVisionConfig.tiny()),
             tproc.LibraCaptionProcessor())
    t = LaionDataset(*procs, loc, tokenizer=SimpleTextTokenizer(vocab_size=256),
                     num_img_tokens=6, seed=2)
    assert isinstance(t.stream, runtime.NativeShardStream)
    off = LaionDataset(*procs, loc, tokenizer=SimpleTextTokenizer(vocab_size=256),
                       num_img_tokens=6, seed=2, native_reader=False)
    assert isinstance(off.stream, ShardStream)
    j = JLaion(jproc.LibraImageProcessor(JClip.tiny()), jproc.LibraCaptionProcessor(),
               loc, tokenizer=JSimpleTok(vocab_size=256), num_img_tokens=6, seed=2)
    assert isinstance(j.stream, jax_native.NativeShardStream)
    got = [s for _, s in zip(range(6), t)]
    want = [s for _, s in zip(range(6), j)]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray) or hasattr(w[k], "shape"):
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), k)
            else:
                assert g[k] == w[k], k
