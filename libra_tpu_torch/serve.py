"""HTTP serving front end over the continuous-batching engine.

    python -m libra_tpu_torch.serve --ckpt /ckpts/libra-11b-chat --port 8000 \
        [--quantize [int8|int4]] [--kv-quant] [--a8-prefill] \
        [--spec-decode 3] [--max-batch 4] [--device cuda] ...

Endpoints (JSON over HTTP/1.1):

  POST /v1/generate
      {"prompt": str,                  # user question (v1-templated), or
       "raw_prompt": str,              # verbatim prompt (no template)
       "image_b64": str?,              # base64 image file (PNG/JPEG/...)
       "pixels": [[[f,..],..],..]?,    # pre-processed (side, side, 3)
       "max_new_tokens": int?,
       "template": str? (default v1),
       "stream": bool?}                # server-sent events, one a token
   -> {"id": int, "text": str, "finish_reason": "eos"|"length"|"capacity",
       "ttft_s": float}

  GET /healthz -> {"ok": true, "pending": int}

A malformed request (ValueError or KeyError while it is built or served)
answers 400; any other error, the scheduler's included, 500.

Threading: handler threads only tokenize (numpy) and enqueue; ONE
scheduler thread owns every device interaction, draining the queue in
waves and driving ``ServingEngine.run()`` per wave (under inference mode,
on the device of the pipeline's params, whose kernels launch on that
thread's current stream). The engine supplies the batching (grouped
refills, chunked decode, per-slot recycling), so co-arriving requests
share device work. Requests landing mid-wave wait for the next wave; a
wave gathers the queue for batch_window_s seconds.

Image questions ride the engine's raw-pixels path: the prompt carries the
placeholder block, and CLIP + LFQ run inside the prompt pass on the
device. Text-to-image is not served here.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from libra_tpu_torch.generation import GenerationConfig
from libra_tpu_torch.pipeline import LibraPipeline, process_prompt
from libra_tpu_torch.serving import Request, ServingEngine


@dataclass
class _Pending:
    request: Request
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[Exception] = None
    # streaming requests: per-token (token, finish_reason) events land
    # here from the scheduler thread; a (None, None) sentinel follows an
    # error (the waiter re-raises from .error)
    stream_q: Optional["queue.Queue"] = None


class ServeApp:
    """Engine + scheduler behind the HTTP handlers. Usable directly:

        app = ServeApp(pipe, max_batch=4, max_len=2048)
        out = app.handle({"prompt": "What is in this image?",
                          "pixels": pixels.tolist()})

    It serves on the device of pipe.params.
    """

    def __init__(self, pipe: LibraPipeline, max_batch: int = 4,
                 max_len: int = 2048, prompt_bucket: int = 128,
                 decode_chunk: int = 8, max_new_default: int = 256,
                 kv_quant: bool = False, spec_decode: int = 0,
                 decode_modality: str = "auto", a8_prefill: bool = False,
                 batch_window_s: float = 0.01, warmup_prompt_len: int = 0):
        text_tok = pipe.tokenizer.text_tokenizer
        img_tok = pipe.tokenizer.image_tokenizer
        self.pipe = pipe
        self.gen = GenerationConfig(
            eos_token_id=text_tok.eos_token_id,
            pad_token_id=text_tok.pad_token_id,
            kv_quant=kv_quant, spec_decode=spec_decode,
            decode_modality=decode_modality, a8_prefill=a8_prefill)
        self.engine = ServingEngine(
            pipe.params, pipe.cfg, max_batch=max_batch, max_len=max_len,
            gen=self.gen, prompt_bucket=prompt_bucket,
            decode_chunk=decode_chunk,
            vq_params=img_tok.params, vq_cfg=img_tok.cfg)
        self.max_new_default = max_new_default
        self.batch_window_s = batch_window_s
        if warmup_prompt_len > 0:
            # run every engine pattern for this text-prompt length class
            # before the scheduler takes traffic, so that first-call costs
            # do not land on the first requests
            Mv = pipe.cfg.max_vision_token_length
            Q = pipe.cfg.vision_codebook_num
            n = max(1, warmup_prompt_len)
            self.engine.warmup(Request(
                request_id=-1,
                input_ids=np.full((Q, n), int(text_tok.bos_token_id or 1),
                                  np.int64),
                vision_indices=np.full((n,), Mv, np.int64)))
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- request construction (handler threads; numpy only) ----------------

    def _build_request(self, payload: Dict[str, Any]) -> Request:
        cfg, pipe = self.pipe.cfg, self.pipe
        Mv = cfg.max_vision_token_length
        Q = cfg.vision_codebook_num
        text_tok = pipe.tokenizer.text_tokenizer

        pixels = None
        if payload.get("image_b64") is not None:
            from PIL import Image
            raw = base64.b64decode(payload["image_b64"])
            pixels = np.asarray(
                pipe.image_processor(Image.open(io.BytesIO(raw))))
        elif payload.get("pixels") is not None:
            pixels = np.asarray(payload["pixels"], np.float32)

        if payload.get("raw_prompt") is not None:
            prompt = payload["raw_prompt"]
        else:
            prompt = process_prompt(
                payload["prompt"], Mv,
                template=payload.get("template", "v1"),
                with_image=pixels is not None)

        t = text_tok([prompt])
        ids = np.asarray(t["input_ids"], np.int64)          # (1, N)
        N = ids.shape[-1]
        vi = np.full((N,), Mv, np.int64)
        kwargs: Dict[str, Any] = {}
        if pixels is not None:
            ph = np.nonzero(ids[0] == text_tok.img_ph_token_id)[0]
            if ph.size != Mv:
                raise ValueError(
                    "prompt must carry exactly one %d-token image "
                    "placeholder block, found %d placeholder(s)"
                    % (Mv, ph.size))
            pos = int(ph[0])
            vi[pos:pos + Mv] = np.arange(Mv)
            kwargs = {"pixels": pixels, "img_start": pos}

        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        return Request(
            request_id=rid,
            input_ids=np.broadcast_to(ids, (Q, N)).copy(),
            vision_indices=vi,
            max_new_tokens=int(payload.get("max_new_tokens",
                                           self.max_new_default)),
            **kwargs)

    # -- scheduler (the ONLY thread touching the device) --------------------

    def _loop(self):
        if self.engine.device.type == "cuda":
            # the kernels launch on the current device's current stream,
            # both per thread
            torch.cuda.set_device(self.engine.device)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            wave: List[_Pending] = [first]
            deadline = time.perf_counter() + self.batch_window_s
            while time.perf_counter() < deadline:
                try:
                    wave.append(self._q.get_nowait())
                except queue.Empty:
                    time.sleep(0.001)
            streams = {p.request.request_id: p.stream_q
                       for p in wave if p.stream_q is not None}

            def on_token(rid, tok, reason):
                q = streams.get(rid)
                if q is not None:
                    q.put((tok, reason))

            try:
                results = self.engine.run([p.request for p in wave],
                                          on_token=on_token)
                by_id = {r.request_id: r for r in results}
                for p in wave:
                    p.result = by_id.get(p.request.request_id)
            except Exception as e:            # noqa: BLE001 -- deliver, don't die
                for p in wave:
                    p.error = e
                    if p.stream_q is not None:
                        p.stream_q.put((None, None))   # error sentinel
            for p in wave:
                p.event.set()

    # -- public surface ------------------------------------------------------

    def handle(self, payload: Dict[str, Any],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        p = _Pending(self._build_request(payload))
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if p.error is not None:
            raise p.error
        res = p.result
        return {"id": res.request_id, "text": self.text(res),
                "finish_reason": res.finish_reason,
                "ttft_s": res.ttft_s}

    def text(self, result) -> str:
        """An engine Result's answer: its codebook-0 ids less pads and
        EOS, decoded without special tokens."""
        ids = np.asarray(result.tokens)[0]
        ids = ids[(ids != self.gen.pad_token_id)
                  & (ids != self.gen.eos_token_id)]
        return self.pipe.tokenizer.text_tokenizer.decode(
            ids.tolist(), skip_special_tokens=True)

    def stream(self, payload: Dict[str, Any], timeout: Optional[float] = None):
        """Generator of {"delta": str} per token, then one final
        {"finish_reason": ..., "text": full_text}. Decoding is cumulative
        (decode all, emit the suffix), so merges across token boundaries
        stream correctly."""
        p = _Pending(self._build_request(payload), stream_q=queue.Queue())
        self._q.put(p)
        text_tok = self.pipe.tokenizer.text_tokenizer
        ids: List[int] = []
        emitted = ""
        while True:
            tok, reason = p.stream_q.get(timeout=timeout)
            if tok is None and reason is None and p.error is not None:
                raise p.error
            if tok is not None:
                t = int(np.asarray(tok)[0])
                if t not in (self.gen.pad_token_id, self.gen.eos_token_id):
                    ids.append(t)
                full = text_tok.decode(ids, skip_special_tokens=True)
                if len(full) > len(emitted):
                    yield {"delta": full[len(emitted):]}
                    emitted = full
            if reason is not None:
                yield {"finish_reason": reason, "text": emitted}
                return

    def pending(self) -> int:
        return self._q.qsize()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _Handler(BaseHTTPRequestHandler):
    app: ServeApp   # bound by make_server

    def _send(self, code: int, obj: Dict[str, Any]):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                      # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._send(200, {"ok": True, "pending": self.app.pending()})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):                     # noqa: N802
        if self.path != "/v1/generate":
            self._send(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if payload.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                for ev in self.app.stream(payload):
                    self.wfile.write(
                        b"data: " + json.dumps(ev).encode() + b"\n\n")
                    self.wfile.flush()
                return
            self._send(200, self.app.handle(payload))
        except (ValueError, KeyError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:             # noqa: BLE001
            self._send(500, {"error": repr(e)})

    def log_message(self, *a):             # no per-request stderr lines
        pass


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="HTTP serving for libra_tpu_torch (continuous batching)")
    ap.add_argument("--ckpt", required=True, help="HF-format checkpoint dir")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--prompt-bucket", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--max-new-default", type=int, default=256)
    ap.add_argument("--quantize", nargs="?", const=True, default=False,
                    choices=[True, False, "int8", "int4"],
                    help="weight-only quantization: bare flag or 'int8' = "
                         "per-channel int8; 'int4' = group-int4 projections "
                         "(embeddings/heads stay int8)")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--a8-prefill", action="store_true",
                    help="w8a8 prompt pass (needs --quantize)")
    ap.add_argument("--spec-decode", type=int, default=0,
                    help="n-gram speculative decode gamma (text streams)")
    ap.add_argument("--decode-modality", default="auto",
                    choices=["auto", "text", "dual"])
    ap.add_argument("--warmup-prompt-len", type=int, default=0,
                    help="run every engine pattern for this text-prompt "
                         "length class before serving (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to load onto and serve on (cuda, "
                         "cuda:N, or cpu)")
    args = ap.parse_args(argv)

    pipe = LibraPipeline.from_pretrained(args.ckpt, quantize=args.quantize,
                                         device=args.device)
    app = ServeApp(pipe, max_batch=args.max_batch, max_len=args.max_len,
                   prompt_bucket=args.prompt_bucket,
                   decode_chunk=args.decode_chunk,
                   max_new_default=args.max_new_default,
                   kv_quant=args.kv_quant, spec_decode=args.spec_decode,
                   decode_modality=args.decode_modality,
                   a8_prefill=args.a8_prefill,
                   warmup_prompt_len=args.warmup_prompt_len)
    srv = make_server(app, args.host, args.port)
    print(f"libra_tpu_torch serving on http://{args.host}:{args.port} "
          f"(device={args.device}, max_batch={args.max_batch}, "
          f"quantize={args.quantize}, kv_quant={args.kv_quant}, "
          f"spec={args.spec_decode})")
    try:
        srv.serve_forever()
    finally:
        app.close()


if __name__ == "__main__":
    main()
