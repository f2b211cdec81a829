"""The port's data layer against libra_tpu's, on the CPU: registry,
processors, caption assembly and label spans, tar-shard streams (with the
per-process split and seed), the LAION, COCO-caption and instruction
datasets, and the builders. The sample dicts are equal to libra_tpu's at
the same seed (images bit for bit: the same PIL and numpy steps).

Shards are tests/test_data_layer.py's synthetic ones (_make_shard); both
packages read them through the Python shard reader (native_reader=False
on both sides; the native readers are held to each other in
tests/test_torch_port_runtime.py).
"""

import json

import numpy as np
import pytest
from PIL import Image

import libra_tpu.data.builders  # noqa: F401  (registrations)
import libra_tpu.train_wrapper  # noqa: F401
import libra_tpu_torch.train_wrapper  # noqa: F401
from libra_tpu.config import CLIPVisionConfig as JClip
from libra_tpu.data import caption_format as jcf
from libra_tpu.data import base as jbase, processors as jproc, webdata as jwd
from libra_tpu.data.instruction import InstructionDataset as JInstruction
from libra_tpu.data.laion import LaionDataset as JLaion
from libra_tpu.registry import registry as jregistry
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu_torch.config import CLIPVisionConfig
from libra_tpu_torch.data import builders as tbuilders, caption_format as tcf
from libra_tpu_torch.data import base as tbase, processors as tproc, webdata as twd
from libra_tpu_torch.data.caption import CaptionDataset
from libra_tpu_torch.data.instruction import InstructionDataset
from libra_tpu_torch.data.laion import LaionDataset
from libra_tpu_torch.registry import registry
from libra_tpu_torch.tokenization import SimpleTextTokenizer

from tests.test_data_layer import _make_shard


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_shards")
    for i in range(4):
        _make_shard(d / f"shard-{i:03d}.tar", n=5, seed=i)
    return d


def _same(got, want, what=""):
    """Sample dicts (or lists of them) equal, arrays bit for bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}/{i}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, Image.Image):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    else:
        assert got == want, (what, got, want)


def _procs(pkg_proc, clip):
    return pkg_proc.LibraImageProcessor(clip), pkg_proc.LibraCaptionProcessor()


def test_registry_names_match():
    for table in ("model", "builder", "processor"):
        assert registry.list(table) == jregistry.list(table)
    with pytest.raises(KeyError, match="registered"):
        registry.get_builder_class("nope")


@pytest.mark.parametrize("size", [(40, 52), (52, 40), (33, 33)])
@pytest.mark.parametrize("pad", [False, True])
def test_image_processors_match(size, pad):
    img = Image.fromarray(np.random.RandomState(sum(size)).randint(
        0, 255, size + (3,), np.uint8))
    got = tproc.LibraImageProcessor(CLIPVisionConfig.tiny(), pad_to_square=pad)(img)
    want = jproc.LibraImageProcessor(JClip.tiny(), pad_to_square=pad)(img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tproc.LibraEvalImageProcessor(CLIPVisionConfig.tiny())(np.asarray(img)),
        jproc.LibraEvalImageProcessor(JClip.tiny())(np.asarray(img)))
    cfg = {"name": "libra_image", "image_size": 56, "pad_to_square": pad}
    a, b = tproc.LibraImageProcessor.from_config(cfg), jproc.LibraImageProcessor.from_config(cfg)
    assert (a.cfg.image_size, a.pad_to_square) == (b.cfg.image_size, b.pad_to_square)


def test_caption_processor_and_format_match():
    raw = "  A <b>photo</b> ## of  ~many~ CATS on a mat and more words here "
    for kw in ({}, {"max_words": 4, "lowercase": True, "prompt": "p: "}):
        assert tproc.LibraCaptionProcessor(**kw)(raw) == jproc.LibraCaptionProcessor(**kw)(raw)
    ph = tcf.image_placeholder(6).strip()
    assert ph == jcf.image_placeholder(6).strip()
    tt, jt = SimpleTextTokenizer(), JSimpleTok()
    for kind in ("background", "respond"):
        for strategy in ("prompt", "instruction", "none"):
            for ins in ("", "Describe the image concisely."):
                bg, resp = (ph, "two cats") if kind == "background" else ("two cats", ph)
                got = tcf.build_caption(bg, resp, ins, kind, add_newline_sep=True)
                assert got == jcf.build_caption(bg, resp, ins, kind, add_newline_sep=True)
                cap, ins_ = got
                assert tcf.label_mask_spans(tt, cap, bg, ins_, kind, strategy) == \
                    jcf.label_mask_spans(jt, cap, bg, ins_, kind, strategy)
    assert tt.vocab == jt.vocab


def test_shard_streams_match(shards):
    loc = str(shards / "shard-*.tar")
    assert twd.expand_shards("/x/s-{000..003}.tar") == jwd.expand_shards("/x/s-{000..003}.tar")
    for kw in (dict(resample=False), dict(resample=True)):
        t = twd.ShardStream(loc, shuffle_bufsize=4, shuffle_initial=2, seed=3,
                            process_index=0, process_count=1, **kw)
        j = jwd.ShardStream(loc, shuffle_bufsize=4, shuffle_initial=2, seed=3,
                            process_index=0, process_count=1, **kw)
        got = [s for _, s in zip(range(12), t)]
        want = [s for _, s in zip(range(12), j)]
        _same(got, want)
    assert twd.resolve_process(None, None) == (0, 1)   # no process group
    assert twd.resolve_process(3, 4) == (3, 4)


def _keys(stream, n=None):
    out = []
    for s in stream:
        out.append(s["__key__"])
        if n is not None and len(out) >= n:
            break
    return out


def test_sequential_split_disjoint(shards):
    """tests/test_multihost_data.py's split on the port, and equal to
    libra_tpu's per process."""
    loc = str(shards / "shard-*.tar")
    ks = []
    for pi in (0, 1):
        kw = dict(resample=False, seed=3, shuffle_bufsize=2, shuffle_initial=1,
                  process_index=pi, process_count=2)
        ks.append(_keys(twd.ShardStream(loc, **kw)))
        assert ks[-1] == _keys(jwd.ShardStream(loc, **kw))
    assert ks[0] and ks[1] and not set(ks[0]) & set(ks[1])
    assert len(set(ks[0]) | set(ks[1])) == 20


def test_resampled_streams_differ_per_process(shards):
    loc = str(shards / "shard-*.tar")
    ks = []
    for pi in (0, 1):
        kw = dict(resample=True, seed=3, shuffle_bufsize=4, shuffle_initial=2,
                  process_index=pi, process_count=2)
        ks.append(_keys(twd.ShardStream(loc, **kw), n=12))
        assert ks[-1] == _keys(jwd.ShardStream(loc, **kw), n=12)
    assert ks[0] != ks[1]
    assert twd.fold_process_seed(3, 1) == jwd.fold_process_seed(3, 1) != \
        twd.fold_process_seed(3, 0)


@pytest.mark.parametrize("kw", [dict(i2t_prob=0.5, seed=3),
                                dict(i2t_prob=0.5, use_instruction=True,
                                     shape_ratio_threshold=1.2, pad_to_square_i2t=True,
                                     continuous_prob_t2i=0.5, add_newline_sep=True,
                                     seed=1, process_index=1, process_count=2),
                                dict(i2t_prob=0.0, label_mask_strategy="instruction",
                                     use_instruction=True, seed=5)])
def test_laion_samples_match(shards, kw):
    loc = str(shards / "shard-*.tar")
    tt, jt = SimpleTextTokenizer(vocab_size=256), JSimpleTok(vocab_size=256)
    t = LaionDataset(*_procs(tproc, CLIPVisionConfig.tiny()), loc, tokenizer=tt,
                     num_img_tokens=6, native_reader=False, **kw)
    j = JLaion(*_procs(jproc, JClip.tiny()), loc, tokenizer=jt, num_img_tokens=6,
               native_reader=False, **kw)
    got = [s for _, s in zip(range(8), t)]
    want = [s for _, s in zip(range(8), j)]
    _same(got, want)
    _same(t.collater(got[:3]), j.collater(want[:3]))
    assert t.is_streaming


def _instruction_files(tmp_path):
    ann = [
        {"id": "1", "image": "img-1.jpg",          # loads through the "-" -> "_" repair
         "conversations": [
             {"from": "human", "value": "<image>\nwhat is this?"},
             {"from": "gpt", "value": "a cat."},
             {"from": "human", "value": "what color?"},
             {"from": "gpt", "value": "black."}]},
        {"id": "2",
         "conversations": [
             {"from": "human", "value": "just text?"},
             {"from": "gpt", "value": "yes."}]},
        {"id": "3", "image": "missing.jpg",
         "conversations": [
             {"from": "human", "value": "<image>\nq"},
             {"from": "gpt", "value": "a"}]},
    ]
    plain = [{"id": str(i), "image": "img_1.jpg",
              "conversations": [{"from": "human", "value": "<image>"},
                                {"from": "gpt", "value": f"caption {i} here"}]}
             for i in range(2)]
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    (tmp_path / "plain.json").write_text(json.dumps(plain))
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (30, 24, 3), np.uint8)
                    ).save(tmp_path / "img_1.jpg")


@pytest.mark.parametrize("version, ann, kw", [
    ("v1", "ann.json", dict(image_aspect_ratio="pad")),
    ("v1", "ann.json", dict(modeling_image=True, capitalize=True)),
    ("plain", "plain.json", dict(enable_t2i=True)),
])
def test_instruction_samples_match(tmp_path, version, ann, kw):
    _instruction_files(tmp_path)
    tt, jt = SimpleTextTokenizer(vocab_size=256), JSimpleTok(vocab_size=256)
    common = dict(num_img_tokens=6, vis_root=str(tmp_path), image_size=28, **kw)
    t = InstructionDataset(str(tmp_path / ann), tproc.LibraImageProcessor(
        CLIPVisionConfig.tiny()), version, tt, **common)
    j = JInstruction(str(tmp_path / ann), jproc.LibraImageProcessor(JClip.tiny()),
                     version, jt, **common)
    assert len(t) == len(j)
    got, want = [t[i] for i in range(len(t))], [j[i] for i in range(len(j))]
    _same(got, want)
    _same(t.collater(got), j.collater(want))


def test_caption_dataset_and_builders_match(tmp_path, shards):
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (20, 30, 3), np.uint8)
                    ).save(tmp_path / "c.jpg")
    anns = [{"image": "c.jpg", "caption": f"a <i>small</i> cat number {i}"}
            for i in range(3)]
    (tmp_path / "cap.json").write_text(json.dumps(anns))
    cfgs = {
        "coco_caption": {
            "vis_processor": {"train": {"name": "libra_image", "image_size": 28},
                              "val": {"name": "libra_image_eval"}},
            "text_processor": {"train": {"name": "libra_caption"}},
            "build_info": {"annotations": {"train": {"storage": str(tmp_path / "cap.json")},
                                           "val": {"storage": str(tmp_path / "cap.json")}},
                           "images": {"storage": str(tmp_path)}},
            "kwargs": {"i2t_prob": 0.5, "num_img_tokens": 6, "sample_n": 2}},
        "laion": {
            "vis_processor": {"train": {"name": "libra_image", "image_size": 28}},
            "text_processor": {"train": {"name": "libra_caption"}},
            "build_info": {"storage": str(shards / "shard-*.tar")},
            "kwargs": {"num_img_tokens": 6, "native_reader": False}},
        "instruction": {
            "vis_processor": {"train": {"name": "libra_image", "image_size": 28}},
            "build_info": {"annotations": str(tmp_path / "plain.json"),
                           "images": str(tmp_path)},
            "kwargs": {"version": "plain", "num_img_tokens": 6, "image_size": 28}},
    }
    _instruction_files(tmp_path)
    tt, jt = SimpleTextTokenizer(vocab_size=256), JSimpleTok(vocab_size=256)
    tsets = {n: registry.get_builder_class(n)(c, tokenizer=tt).build_datasets()
             for n, c in cfgs.items()}
    jsets = {n: jregistry.get_builder_class(n)(c, tokenizer=jt).build_datasets()
             for n, c in cfgs.items()}
    for name in cfgs:
        assert tsets[name].keys() == jsets[name].keys(), name
        for split, ds in tsets[name].items():
            jds = jsets[name][split]
            if getattr(ds, "is_streaming", False):
                _same([s for _, s in zip(range(3), ds)],
                      [s for _, s in zip(range(3), jds)], f"{name}/{split}")
            else:
                _same([ds[i] for i in range(len(ds))],
                      [jds[i] for i in range(len(jds))], f"{name}/{split}")
    assert isinstance(tsets["coco_caption"]["train"], CaptionDataset)
    assert isinstance(tbuilders.LaionBuilder(cfgs["laion"], tt).build()["train"],
                      LaionDataset)
    # split reorganisation and concatenation
    by_split = tbase.concat_datasets(tbase.reorg_datasets_by_split(tsets))
    jby_split = jbase.concat_datasets(jbase.reorg_datasets_by_split(jsets))
    assert by_split.keys() == jby_split.keys()
    mapped, streaming = by_split["train"]
    assert len(mapped) == len(jby_split["train"][0]) == 2 + 2
    _same([mapped[i] for i in range(len(mapped))],
          [jby_split["train"][0][i] for i in range(len(mapped))])
    assert isinstance(streaming, LaionDataset)
