"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: needs a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles the four kernels of libra_tpu_torch/csrc at once (one
   nvcc each) and prints ptxas' register, shared-memory and spill lines.
3. flash kernel vs its plain version at the prompt pass's shape (B=4,
   Nq=610, Nk=738, H=32, d=128, bf16), bridge on and off, left-padded
   rows with fully masked query rows included.
4. int8 and int4 matmul kernels vs their plain versions at M = 4 (decode)
   and M = 160 (the gate's limit) on libra-11b's projection shapes
   (4096->4096, 4096->11008, 11008->4096, 4096->32000 lm_head), the
   weight a layer view of a stacked (8, K, F) buffer; int4 in both a8
   modes.
5. int8 decode attention vs its plain version at B=4, H=32, d=128,
   S=674 (610 + 64): N=1 and N=8, bridge on and off, left-padded rows,
   a per-query causal bias for N=8.
6. full paths, libra-11b at full width and depth with random weights from
   a seeded torch.Generator (bridge B-weights filled with noise) and the
   two-tap CLIP ViT-L/14-336 tokenizer: the bf16 tree, then the tree
   quantized on the card to int8 and to int4 (quantize_params). Each runs
   LibraPipeline.chat on 4 questions and 4 synthetic 336x336 images, then
   TTFT and decode tok/s through the Generator (the quantized trees with
   kv_quant, a8_prefill and text decode, as bench.py runs them), with the
   kernel launches of each run checked against counts derived from the
   config, two greedy runs held equal, and on two layers at full width
   the logits with the kernels held against those with every kernel's
   plain version patched in; last, torch.profiler's split of one prompt
   pass and of 4 decode steps by kernel.

Each phase-6 run sets every kernel's launch count to 0 just before it and
reads them just after; the line before the last is the kernel report as
JSON, with the launches summed over those runs; the last line is
{"ok": true, "device": {...}}. Every number printed stands beside the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
B, NQ, NK, H, HD = 4, 610, 738, 32, 128      # the prompt pass's attention shape
IMG0, IMG1 = 8, 586                          # image block of the kernel checks
S_DECODE = 674                               # 610 prompt + 64 new tokens
MATMUL_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
SEED = 0
MAX_NEW = 64
PROFILE_ROWS = 8                             # kernels listed per profile
# End-to-end check on two layers: the kernels and their plain versions
# both round each result to bf16 from fp32 sums taken in different
# orders, so a few elements differ by one bf16 ulp; every later bf16 op
# re-rounds, and the logits end up about one ulp apart (relative L2 near
# 2^-8 ~ 0.004). A fault in a kernel (a wrong mask, a lost bridge term, a
# wrong scale) moves them by far more. At full depth (32 random layers)
# the same noise grows to a few percent of the logits, too loose to check.
E2E_TOL = 0.01
# In the quantized paths the same one-ulp differences flip a few int8
# roundings of the K/V cache and, in W4A8, of the activations (one step is
# 1/127 of a row's absmax, ~0.8%), so the logits end up 1-3% apart
# (measured on an H100: int8 0.0137 prompt pass / 0.0053 decode step, int4
# 0.0086 / 0.0262). The tolerance allows 5%; each kernel is held tightly
# against its plain version in phases 3-5.
E2E_TOL_QUANT = 0.05
QUESTIONS = ["What is shown in this picture?",
             "Describe the image.",
             "What color is the left object?",
             "How many people are there?"]
KERNELS = [
    dict(name="flash_bridged_attention", module="libra_tpu_torch.ops.flash_bridge",
         source="libra_tpu_torch/csrc/flash_bridge.cu",
         replaces="libra_tpu/ops/pallas/flash_bridge.py:117"),
    dict(name="int8_matmul", module="libra_tpu_torch.ops.int8_matmul",
         source="libra_tpu_torch/csrc/int8_matmul.cu",
         replaces="libra_tpu/ops/pallas/int8_matmul.py:59"),
    dict(name="int4_matmul", module="libra_tpu_torch.ops.int4_matmul",
         source="libra_tpu_torch/csrc/int4_matmul.cu",
         replaces="libra_tpu/ops/pallas/int4_matmul.py:140"),
    dict(name="int8_decode_attention", module="libra_tpu_torch.ops.decode_attention",
         source="libra_tpu_torch/csrc/decode_attention.cu",
         replaces="libra_tpu/ops/pallas/decode_attention.py:172"),
]
MATMUL_KERNEL = {"bf16": None, "int8": "int8_matmul", "int4": "int4_matmul"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    return {k["name"]: getattr(importlib.import_module(k["module"]), k["name"])
            for k in KERNELS}


def zero_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_counts() -> Counter:
    return Counter({n: w.launches for n, w in wrappers().items()})


def cuda_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of `fn` in ms: the median over `reps` of a
    run of n calls between two CUDA events, divided by n, after a warm-up.
    Each run is queued behind a sleep on the device, so the calls run back
    to back and the host's launch time does not enter the figure."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)              # ~10 ms: the host queues ahead
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bf16_tol(want: torch.Tensor) -> float:
    """A kernel rounds its fp32 result to bf16 (half an ulp: at most 2^-9
    of the largest output; 2^-8 allowed) and sums in another order than
    the fp32 reference (well under 1e-4 at these sizes)."""
    return want.abs().max().item() * 2.0 ** -8 + 1e-4


def check(label: str, got, want, card: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_tol(want.float())
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"{label}: max_abs_err {err:.6g} (tol {tol:.6g}: bf16 rounding of "
          f"the output, 2^-8 of max|ref|, + 1e-4 for fp32 summation order) "
          f"[{card}]")
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err


def build(card: str) -> None:
    from libra_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all(ROOT / k["source"] for k in KERNELS)
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc each, in parallel) [{card}]")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {lib.stem}:", line.strip())


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def attention_inputs(use_bridge: bool, dev):
    """Prompt-pass inputs: keys span the whole cache (610 prompt slots +
    128 decode slots, the tail masked); rows 2 and 3 are left-padded by 3
    and 5 tokens, so their first query rows are fully masked."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(n):
        return torch.randn((B, n, H, HD), generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(NQ), rnd(NK), rnd(NK)
    kb, vb = (rnd(NK), rnd(NK)) if use_bridge else (None, None)
    flag_q = torch.zeros((B, NQ), dtype=torch.bool, device=dev)
    flag_q[:, IMG0:IMG1] = True
    flag_kv = torch.cat([flag_q, torch.zeros((B, NK - NQ), dtype=torch.bool,
                                             device=dev)], dim=1)
    mask = torch.zeros((B, NK), dtype=torch.int64, device=dev)
    mask[:, :NQ] = 1
    mask[2, :3] = 0
    mask[3, :5] = 0
    causal = torch.arange(NK, device=dev)[None, :] <= torch.arange(NQ, device=dev)[:, None]
    keep = causal[None, None] & mask.bool()[:, None, None, :]
    bias = torch.where(keep, 0.0, -2.0 ** 30).float()
    return q, k, v, kb, vb, flag_q, flag_kv, bias


def check_flash(card: str, dev) -> dict:
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    report = {}
    for use_bridge in (True, False):
        args = attention_inputs(use_bridge, dev)
        got = flash_bridged_attention(*args)
        torch.cuda.synchronize()
        f32 = [None if t is None else (t.float() if t.is_floating_point() else t)
               for t in args]
        err = check(f"flash use_bridge={use_bridge}", got,
                    flash_bridged_attention_plain(*f32), card)
        if not bool(torch.isfinite(got[2:, :3]).all()):
            raise AssertionError("fully masked query rows must stay finite")
        ms = cuda_ms(lambda: flash_bridged_attention(*args))
        plain_ms = cuda_ms(lambda: flash_bridged_attention_plain(*args))
        print(f"flash use_bridge={use_bridge}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms [{card}]")
        report[use_bridge] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": max(r["max_abs_err"] for r in report.values()),
            "ms": report[True]["ms"], "plain_ms": report[True]["plain_ms"]}


def check_matmuls(card: str, dev) -> dict:
    """Each case against its plain version on the same inputs, from bf16 x
    in fp32; timed on layer views that rotate over the 8 layers of the
    stacked buffer, so each launch reads its weights from device memory
    (8 layers exceed the 50 MB L2 at every shape), as a decode step does."""
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    L = 8
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    report = {"int8_matmul": [], "int4_matmul": []}
    for K, F in MATMUL_SHAPES:
        q = torch.randint(-127, 128, (L, K, F), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((L, 1, F), generator=g, device=dev) * 2e-3
        packed = torch.randint(-128, 128, (L, K // 2, F), generator=g, device=dev,
                               dtype=torch.int8)
        s4 = torch.rand((L, K // 128, F), generator=g, device=dev) * 2e-2
        for M in (4, 160):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            cases = [("int8_matmul", "", I8.int8_matmul, I8.int8_matmul_plain,
                      lambda l: (q[l], s[l]))]
            for a8 in (False, True):
                cases.append((
                    "int4_matmul", f" a8={a8}",
                    functools.partial(I4.int4_matmul, group=128, a8=a8),
                    functools.partial(I4.int4_matmul_plain, group=128, a8=a8),
                    lambda l: (packed[l], s4[l])))
            for name, tag, kernel, plain, layer in cases:
                label = f"{name}{tag} M={M} {K}->{F}"
                got = kernel(x, *layer(3))
                torch.cuda.synchronize()
                err = check(label, got, plain(x.float(), *layer(3)), card)
                turn = itertools.cycle(range(L))
                ms = cuda_ms(lambda: kernel(x, *layer(next(turn))))
                plain_ms = cuda_ms(lambda: plain(x, *layer(next(turn))))
                print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                      f"[{card}]")
                report[name].append(dict(M=M, K=K, F=F, tag=tag, max_abs_err=err,
                                         ms=ms, plain_ms=plain_ms))
        del q, s, packed, s4
    return report


def check_decode_attention(card: str, dev) -> dict:
    """Decode steps over the 674-slot int8 cache of a prompt of 610: the
    query rows sit at slots 610 .. 610 + N - 1 (keys past them masked),
    rows 2 and 3 left-padded by 3 and 5; N = 8 carries a per-query causal
    bias, mixed query flags and one fully masked query row (the uniform
    average of V). Layer views of a stacked (2, ...) cache."""
    from libra_tpu_torch.ops.decode_attention import (
        int8_decode_attention, int8_decode_attention_plain)
    S, L = S_DECODE, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def buf():
        q = torch.randint(-127, 128, (L, B, H, S, HD), generator=g, device=dev,
                          dtype=torch.int8)
        return q, torch.rand((L, B, H, S), generator=g, device=dev) * 0.03 + 1e-3

    bufs = [buf() for _ in range(4)]
    flag_kv = torch.zeros((B, S), dtype=torch.bool, device=dev)
    flag_kv[:, IMG0:IMG1] = True
    report = []
    for N in (1, 8):
        for bridge in (True, False):
            q = torch.randn((B, N, H, HD), generator=g, device=dev).to(torch.bfloat16)
            flag_q = torch.zeros((B, N), dtype=torch.bool, device=dev)
            slots = torch.arange(S, device=dev)
            keep = slots[None, None, :] <= (NQ + torch.arange(N, device=dev))[None, :, None]
            keep = keep.expand(B, N, S).clone()
            keep[2, :, :3] = False
            keep[3, :, :5] = False
            if N > 1:
                flag_q[:, ::2] = True
                keep[0, N - 1] = False
            bias = torch.where(keep, 0.0, -2.0 ** 30).float()
            fq = flag_q[:, 0] if N == 1 else flag_q
            bias = bias[:, 0] if N == 1 else bias

            def layer(l, bridge=bridge):
                names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"]
                ts = [t[l] for pair in bufs[:4 if bridge else 2] for t in pair]
                return dict(zip(names, ts))

            kw = dict(flag_q=fq, kv_flag=flag_kv, bias=bias)
            got = int8_decode_attention(q, **layer(1), **kw)
            torch.cuda.synchronize()
            label = f"int8_decode_attention N={N} bridge={bridge} S={S}"
            err = check(label, got, int8_decode_attention_plain(q.float(), **layer(1), **kw),
                        card)
            turn = itertools.cycle(range(L))
            ms = cuda_ms(lambda: int8_decode_attention(q, **layer(next(turn)), **kw))
            plain_ms = cuda_ms(lambda: int8_decode_attention_plain(
                q, **layer(next(turn)), **kw))
            print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
            report.append(dict(N=N, bridge=bridge, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms))
    return report


# ---------------------------------------------------------------------------
# Full paths
# ---------------------------------------------------------------------------

def decoder_params(cfg, dev, mode: str = "bf16"):
    """Random decoder params on the card from a fresh seeded generator,
    with the bridge B-weights (zero at init) filled with N(0, 0.02) so the
    bridge terms are live; quantized on the card for "int8" / "int4"."""
    from libra_tpu_torch.models import libra as M
    from libra_tpu_torch.quantization import quantize_params
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        params = M.init_params(g, cfg, dev)
        attn = params["layers"]["attn"]
        for name in ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis"):
            wb = attn[name]["wb"]
            wb.copy_(torch.randn(wb.shape, generator=g, device=dev) * 0.02)
        if mode != "bf16":
            params = quantize_params(params, bits=8 if mode == "int8" else 4)
    return params


def expected_counts(cfg, mode: str, kv_quant: bool, prefills: int,
                    steps: int) -> Counter:
    """Kernel launches of `prefills` prompt passes and `steps` text-only
    decode steps: the flash kernel once per layer in a prompt pass; in a
    quantized tree one matmul launch per weight matmul at M <= 160 (the
    prompt pass's lm_head at the last position, and in each decode step
    the 7 projections q, k, v, o, gate, up, down of every layer and
    lm_head); with the int8 cache one decode-attention launch per layer
    and step."""
    L = cfg.num_hidden_layers
    want = Counter({k["name"]: 0 for k in KERNELS})
    want["flash_bridged_attention"] = prefills * L
    if MATMUL_KERNEL[mode]:
        want[MATMUL_KERNEL[mode]] = prefills + steps * (7 * L + 1)
    if kv_quant:
        want["int8_decode_attention"] = steps * L
    return want


def assert_counts(label: str, got: Counter, want: Counter, card: str) -> None:
    print(f"{label}: launches {dict(got)} (expected {dict(want)}) [{card}]")
    if dict(got) != dict(want):
        raise AssertionError(f"{label}: kernel launches {dict(got)}, "
                             f"expected {dict(want)}")


def text_logits(cfg, params, args, gen, tok=None):
    """Text-vocab logits of the prompt pass and, with the int8 cache, of
    the next decode step (on `tok`, or on the argmax); and that token."""
    from libra_tpu_torch.generation import _prefill, decode_micro_step
    st = _prefill(params, *args, cfg=cfg, gen=gen)
    out = {"prompt pass": st.logits[0, :, :cfg.vocab_size].float()}
    if gen.kv_quant:
        tok = torch.argmax(st.logits, dim=-1) if tok is None else tok
        st.mask_buf[:, args[0].shape[-1]] = 1
        step, *_ = decode_micro_step(params, cfg, tok, st.mask_buf, st.cache,
                                     st.vi_last, st.last_pos, lang_only=True)
        out["decode step"] = step[0, :, :cfg.vocab_size].float()
    return out, tok


def plain_kernels():
    """Every kernel's plain version patched in where the model calls it."""
    from libra_tpu_torch.models import libra as M
    from libra_tpu_torch.ops import decode_attention as DA, flash_bridge as FB
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        M, "flash_bridged_attention", FB.flash_bridged_attention_plain))
    stack.enter_context(mock.patch.object(
        M, "int8_decode_attention", DA.int8_decode_attention_plain))
    stack.enter_context(mock.patch.object(I8, "int8_matmul", I8.int8_matmul_plain))
    stack.enter_context(mock.patch.object(I4, "int4_matmul", I4.int4_matmul_plain))
    return stack


def full_path(card: str, dev, cfg, vq_cfg, vq_params, mode: str,
              main: Counter) -> int:
    """Chat, logit checks and TTFT/decode timing for one weight mode.
    Adds the main-path runs' kernel launches to `main`; returns the
    prompt length."""
    from libra_tpu_torch.generation import GenerationConfig
    from libra_tpu_torch.pipeline import LibraPipeline
    from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                              SimpleTextTokenizer)
    from libra_tpu_torch.training.fused import maybe_normalize_pixels

    quant = mode != "bf16"
    t0 = time.perf_counter()
    params = decoder_params(cfg, dev, mode)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    print(f"{mode} init{' + quantize_params' if quant else ''}: decoder tree "
          f"{n_bytes / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s [{card}]")

    text_tok = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
    img_tok = ImageTokenizer(vq_cfg, vq_params, cfg.vocab_size,
                             cfg.max_vision_token_length)
    pipe = LibraPipeline(cfg, params, LibraTokenizer(text_tok, img_tok),
                         functools.partial(maybe_normalize_pixels, vq_cfg))
    results = []
    generate = pipe.generator
    pipe.generator = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    pix_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    S = vq_cfg.clip.image_size
    images = [torch.randint(0, 256, (S, S, 3), generator=pix_gen,
                            device=dev, dtype=torch.uint8) for _ in range(B)]

    # --- the main path: chat, with every kernel count at zero ---
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    answers = pipe.chat(QUESTIONS, images=images, max_new_tokens=16)
    torch.cuda.synchronize()
    chat_s = time.perf_counter() - t0
    got = read_counts()
    main.update(got)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pipe.generator = generate
    steps = int(results[0].num_generated.max()) - 1
    print(f"{mode} chat: {len(answers)} answers in {chat_s:.3f} s (first call), "
          f"{steps} decode steps, peak memory {peak_gb:.3f} GB [{card}]")
    assert_counts(f"{mode} chat", got, expected_counts(cfg, mode, False, 1, steps),
                  card)
    if len(answers) != B or not all(isinstance(a, str) for a in answers):
        raise AssertionError("chat did not answer every question")

    # --- logits: finite at full depth; on a small input (two layers, full
    # width, the same prompts) equal to those with the plain versions ---
    inputs = pipe._tokenize(pipe_prompts(pipe), images)
    N = inputs["input_ids"].shape[-1]
    args = (inputs["input_ids"], inputs["attention_mask"],
            inputs["vision_indices"], inputs["coninous_signal"])
    qkw = dict(kv_quant=True, a8_prefill=True, decode_modality="text") if quant else {}
    gen = GenerationConfig(max_new_tokens=2, eos_token_id=-1, **qkw)
    small_cfg = cfg.replace(num_hidden_layers=2)
    with torch.inference_mode():
        full, _ = text_logits(cfg, params, args, gen)
        small = decoder_params(small_cfg, dev, mode)
        got_l, tok = text_logits(small_cfg, small, args, gen)
        with plain_kernels():
            want_l, _ = text_logits(small_cfg, small, args, gen, tok)
        del small
    tol = E2E_TOL_QUANT if quant else E2E_TOL
    rel = {k: ((got_l[k] - want_l[k]).norm() / want_l[k].norm()).item()
           for k in got_l}
    finite = all(bool(torch.isfinite(t).all()) for t in full.values())
    print(f"{mode} logits: N={N}, full depth finite {finite}; 2-layer logits "
          f"vs the plain versions, relative L2: "
          + ", ".join(f"{k} {v:.6g}" for k, v in rel.items())
          + f" (tol {tol}) [{card}]")
    if not finite:
        raise AssertionError("non-finite logits at full depth")
    if not max(rel.values()) < tol:
        raise AssertionError(f"2-layer logits differ from the plain path: {rel}")

    # --- TTFT and decode rate, the bench's two-run difference ---
    g1 = GenerationConfig(max_new_tokens=1, eos_token_id=-1, **qkw)
    g64 = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, **qkw)

    def run(gen_cfg):
        t = time.perf_counter()
        res = pipe.generator(inputs, gen_cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t, res

    run(g1)
    run(g64)                                    # warm-up
    zero_counts()
    ttft = min(run(g1)[0] for _ in range(2))
    (t64a, r1), (t64b, r2) = run(g64), run(g64)
    got = read_counts()
    main.update(got)
    assert_counts(f"{mode} generator (2 x 1 + 2 x {MAX_NEW} new tokens)", got,
                  expected_counts(cfg, mode, quant, 4, 2 * (MAX_NEW - 1)), card)
    t64 = min(t64a, t64b)
    tok_s = (MAX_NEW - 1) * B / (t64 - ttft)
    new = r1.sequences[:, :, N:]
    if not torch.equal(r1.sequences, r2.sequences):
        raise AssertionError("two greedy runs gave different tokens")
    if bool((new >= cfg.vocab_size).any()):
        raise AssertionError("text positions emitted vision ids")
    print(f"{mode} VQA B={B} N={N} {qkw}: TTFT {ttft * 1e3:.3f} ms, decode "
          f"{tok_s:.3f} tok/s ({MAX_NEW} new tokens in {t64 * 1e3:.3f} ms) "
          f"[{card}]")
    profile_paths(card, cfg, params, args, g64, mode)
    return N


def profile_paths(card: str, cfg, params, args, gen, mode: str) -> None:
    """torch.profiler over one prompt pass, then over 4 text-only decode
    steps: wall and device time, and the kernels that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from libra_tpu_torch.generation import _prefill, decode_micro_step

    def record(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the kernels' own rows (an op's row repeats its kernels' time)
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type != torch.autograd.DeviceType.CPU),
                         key=lambda e: -e.self_device_time_total)
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"profile {mode} {name}: {wall * 1e3:.3f} ms wall, {device_ms:.3f} "
              f"ms device [{card}]")
        for e in kernels[:PROFILE_ROWS]:
            print(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3:10.3f} ms "
                  f"{e.count:6d} launches")
        return res

    def steps(st):
        tok = torch.argmax(st.logits, dim=-1)
        n = args[0].shape[-1]
        cache, vi, pos = st.cache, st.vi_last, st.last_pos
        for i in range(4):
            st.mask_buf[:, n + i] = 1
            logits, cache, vi, pos = decode_micro_step(
                params, cfg, tok, st.mask_buf, cache, vi, pos, lang_only=True)
            tok = torch.argmax(logits, dim=-1)

    with torch.inference_mode():
        st = record("prefill", lambda: _prefill(params, *args, cfg=cfg, gen=gen))
        record("4 decode steps", lambda: steps(st))


def pipe_prompts(pipe):
    from libra_tpu_torch.pipeline import process_prompt
    return [process_prompt(q, pipe.cfg.max_vision_token_length) for q in QUESTIONS]


def _tensors(tree):
    """Every tensor of a parameter tree, quantized leaves' fields included."""
    from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, QuantizedArray):
        yield from (tree.q, tree.scale)
    elif isinstance(tree, Quantized4Array):
        yield from (tree.packed, tree.scale)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs "
                           "only on the card")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} [{card}]")

    build(card)
    report = {"flash_bridged_attention": check_flash(card, dev)}
    mm = check_matmuls(card, dev)
    da = check_decode_attention(card, dev)
    # the JSON line's times: the decode shapes (M = 4, 4096 -> 11008; N = 1
    # with the bridge); its error: the largest over every case
    for name, rows, pick in (
            ("int8_matmul", mm["int8_matmul"], dict(M=4, F=11008, tag="")),
            ("int4_matmul", mm["int4_matmul"], dict(M=4, F=11008, tag=" a8=True")),
            ("int8_decode_attention", da, dict(N=1, bridge=True))):
        row = next(r for r in rows if all(r[k] == v for k, v in pick.items()))
        report[name] = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                            ms=row["ms"], plain_ms=row["plain_ms"])

    from libra_tpu_torch.config import LibraConfig, VQGANConfig
    from libra_tpu_torch.models import vqgan
    cfg = LibraConfig(dtype="bfloat16", param_dtype="bfloat16")
    vq_cfg = VQGANConfig(select_layer=(-2, -1))
    if vq_cfg.clip_feature_dim != cfg.contiguous_signal_size:
        raise ValueError("the CLIP taps must give contiguous_signal_size channels")
    with torch.inference_mode():
        vq_params = vqgan.init_params(torch.Generator(device=dev).manual_seed(SEED),
                                      vq_cfg, dev, torch.bfloat16)
    L = cfg.num_hidden_layers
    print(f"launches per text decode step in a quantized tree: 7 projections x "
          f"{L} layers + lm_head = {7 * L + 1} matmul launches; with the int8 "
          f"cache, {L} decode-attention launches (1 a layer) [{card}]")
    main_counts = Counter()
    for mode in ("bf16", "int8", "int4"):
        n_prompt = full_path(card, dev, cfg, vq_cfg, vq_params, mode, main_counts)
        if n_prompt != NQ:
            raise AssertionError(f"prompt length {n_prompt}, expected {NQ}")
        torch.cuda.empty_cache()
    missing = [k["name"] for k in KERNELS if main_counts[k["name"]] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s [{card}]")

    print(json.dumps({"kernels": [dict(
        name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"],
        launches=main_counts[k["name"]], **report[k["name"]]) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
