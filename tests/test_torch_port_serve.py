"""The port's HTTP serving front end (libra_tpu_torch.serve), on the CPU at
a tiny size in fp32: tests/test_serve.py's six cases on the port (request
building, scheduler waves and the HTTP round trip give the pipeline's own
answers; 400 on a bad request; stream deltas; server-sent events), plus
the port's ServeApp against libra_tpu's on one converted checkpoint (text
and pixels requests), a spec-decode app against the standard one, a
scheduler error reaching the client as 500, and serve.main's flags.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from libra_tpu import config as jconfig
from libra_tpu.pipeline import LibraPipeline as JPipeline
from libra_tpu.serve import ServeApp as JServeApp
from libra_tpu_torch import serve
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.data.processors import LibraEvalImageProcessor
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.pipeline import LibraPipeline
from libra_tpu_torch.serve import ServeApp, make_server
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from tests import torch_port_ckpt as C
from tests.test_torch_port_fused_generation import _trees, _vq_tree

APP_KW = dict(max_batch=2, max_len=96, prompt_bucket=16, decode_chunk=4,
              max_new_default=4)


def _pipe():
    """The port's pipeline on the fused-generation tests' trees (live
    bridges), with a fresh SimpleTextTokenizer."""
    cfg, vq_cfg = LibraConfig.tiny(), VQGANConfig.tiny()
    _, tree = _trees((), 0)
    _, vq_tree = _vq_tree()
    img_tok = ImageTokenizer(vq_cfg, from_numpy_tree(vq_tree, device="cpu"),
                             token_offset=cfg.vocab_size,
                             max_vision_token_length=cfg.max_vision_token_length)
    return LibraPipeline(cfg, from_numpy_tree(tree, device="cpu"),
                         LibraTokenizer(SimpleTextTokenizer(cfg.vocab_size), img_tok),
                         LibraEvalImageProcessor(vq_cfg.clip))


@pytest.fixture(scope="module")
def pipe():
    return _pipe()


@pytest.fixture(scope="module")
def app(pipe):
    a = ServeApp(pipe, **APP_KW)
    yield a
    a.close()


@pytest.fixture
def server(app):
    srv = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(url, payload, timeout=300):
    req = urllib.request.Request(f"{url}/v1/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _image(seed=0):
    from PIL import Image
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (40, 40, 3),
                                                               np.uint8))


def test_handle_text_matches_pipeline(pipe, app):
    q = "what is the capital"
    want = pipe.chat([q], max_new_tokens=4)[0]
    out = app.handle({"prompt": q, "max_new_tokens": 4}, timeout=300)
    assert out["text"] == want and want
    assert out["finish_reason"] in ("eos", "length")
    assert out["ttft_s"] is None or out["ttft_s"] >= 0


def test_handle_image_matches_pipeline(pipe, app):
    img = _image()
    q = "describe this"
    want = pipe.chat([q], images=[img], max_new_tokens=4)[0]
    pixels = np.asarray(pipe.image_processor(img))
    out = app.handle({"prompt": q, "pixels": pixels.tolist(), "max_new_tokens": 4},
                     timeout=300)
    assert out["text"] == want and want


def test_http_roundtrip_concurrent(pipe, server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] is True and health["pending"] >= 0
    qs = ["first question", "second question", "third question"]
    want = [pipe.chat([q], max_new_tokens=4)[0] for q in qs]
    got = [None] * len(qs)

    def post(i):
        with _post(server, {"prompt": qs[i], "max_new_tokens": 4}) as r:
            got[i] = json.loads(r.read())["text"]

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(qs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert got == want


@pytest.mark.parametrize("payload", [
    {"max_new_tokens": 4},                                    # no prompt: KeyError
    {"raw_prompt": "no image here", "pixels": [[[0.0] * 3] * 28] * 28},   # ValueError
])
def test_http_bad_request(server, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, payload, timeout=60)
    assert ei.value.code == 400


def test_http_scheduler_error_is_500(app, server, monkeypatch):
    """An error raised on the scheduler thread reaches the client."""
    def fail(requests, on_token=None):
        raise RuntimeError("device lost")
    monkeypatch.setattr(app.engine, "run", fail)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {"prompt": "any question", "max_new_tokens": 2}, timeout=60)
    assert ei.value.code == 500 and "device lost" in ei.value.read().decode()
    with pytest.raises(RuntimeError):
        list(app.stream({"prompt": "any question", "max_new_tokens": 2}, timeout=60))


def test_stream_deltas_match_handle(app):
    q = "stream me an answer"
    want = app.handle({"prompt": q, "max_new_tokens": 4}, timeout=300)
    evs = list(app.stream({"prompt": q, "max_new_tokens": 4}, timeout=300))
    assert evs[-1]["finish_reason"] in ("eos", "length")
    text = "".join(e["delta"] for e in evs[:-1])
    assert text == want["text"] and evs[-1]["text"] == want["text"]


def test_http_sse_stream(pipe, server):
    q = "tell me about streams"
    want = pipe.chat([q], max_new_tokens=4)[0]
    with _post(server, {"prompt": q, "max_new_tokens": 4, "stream": True}) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        events = [json.loads(line[len(b"data: "):]) for line in r.read().split(b"\n")
                  if line.startswith(b"data: ")]
    assert events[-1]["text"] == want
    assert "".join(e.get("delta", "") for e in events[:-1]) == want


def test_spec_decode_app_matches_standard(app):
    """spec_decode = 3 (greedy, text streams) answers as the standard app,
    a text and a pixels request."""
    spec = ServeApp(app.pipe, spec_decode=3, **APP_KW)
    try:
        pixels = np.asarray(app.pipe.image_processor(_image(1)))
        for p in ({"prompt": "repeat repeat repeat repeat", "max_new_tokens": 8},
                  {"prompt": "what is shown", "pixels": pixels, "max_new_tokens": 8}):
            want = app.handle(p, timeout=300)
            got = spec.handle(p, timeout=300)
            assert got["text"] == want["text"] and got["text"]
        assert spec.engine.last_run_stats["n_spec"] > 0
    finally:
        spec.close()


@pytest.fixture(scope="module")
def ckpt_pipes(tmp_path_factory):
    """libra_tpu's and the port's pipelines from one synthetic checkpoint."""
    d = tmp_path_factory.mktemp("serve_ckpt")
    C.write_checkpoint(d, jconfig.LibraConfig.tiny())
    return JPipeline.from_pretrained(str(d)), LibraPipeline.from_pretrained(str(d),
                                                                            device="cpu")


def test_serve_app_matches_libra_tpu(ckpt_pipes):
    jpipe, pipe = ckpt_pipes
    want_app, got_app = JServeApp(jpipe, **APP_KW), ServeApp(pipe, **APP_KW)
    try:
        side = pipe.tokenizer.image_tokenizer.cfg.clip.image_size
        pixels = np.random.RandomState(3).randn(side, side, 3).astype(np.float32)
        for p in ({"prompt": "what is the cat", "max_new_tokens": 6},
                  {"prompt": "what is a dog", "pixels": pixels.tolist(),
                   "max_new_tokens": 6}):
            want, got = want_app.handle(p, timeout=600), got_app.handle(p, timeout=600)
            assert got["text"] == want["text"] and got["text"]
            assert got["finish_reason"] == want["finish_reason"]
    finally:
        want_app.close()
        got_app.close()


def test_main_help_lists_flags(capsys):
    import re

    from libra_tpu import serve as jserve
    flags = {}
    for name, mod in (("port", serve), ("jax", jserve)):
        with pytest.raises(SystemExit) as ei:
            mod.main(["--help"])
        assert ei.value.code == 0
        flags[name] = set(re.findall(r"--[a-z][a-z0-9-]*", capsys.readouterr().out))
    assert flags["port"] == flags["jax"] | {"--device"}
    assert "--ckpt" in flags["port"] and "--quantize" in flags["port"]
