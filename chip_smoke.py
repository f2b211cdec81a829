"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: needs a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles the flash-bridge kernel from libra_tpu_torch/csrc.
3. kernel vs plain at the prompt pass's shape (B=4, Nq=610, Nk=738,
   H=32, d=128, bf16), bridge on and off, left-padded rows with fully
   masked query rows included; prints the error and both times.
4. full path: libra-11b at full width in bf16 (random weights from a
   seeded torch.Generator, bridge B-weights filled with noise) with the
   two-tap CLIP ViT-L/14-336 tokenizer; LibraPipeline.chat on 4 questions
   and 4 synthetic 336x336 uint8 images, greedy; then TTFT and decode
   tok/s through the Generator; checks and prints the results.

The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}. Every number printed stands beside the
card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

B, NQ, NK, H, HD = 4, 610, 738, 32, 128      # the prompt pass's attention shape
IMG0, IMG1 = 8, 586                          # image block of the kernel check
SEED = 0
# End-to-end check on two layers: the kernel and its plain version both
# round each attention output to bf16 from fp32 sums taken in different
# orders, so a few elements differ by one bf16 ulp; every later bf16 op
# re-rounds, and the logits end up about one ulp apart (relative L2 near
# 2^-8 ~ 0.004). A fault in the kernel (a wrong mask, a lost bridge term)
# moves them by far more. At full depth (32 random layers) the same noise
# grows to a few percent of the logits, too loose to check against.
E2E_TOL = 0.01
QUESTIONS = ["What is shown in this picture?",
             "Describe the image.",
             "What color is the left object?",
             "How many people are there?"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 20) -> float:
    """Median device time of `fn` in ms over n runs, after a warm-up."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_kernel(card: str, dev) -> dict:
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    report = {}
    for use_bridge in (True, False):
        args = attention_inputs(use_bridge, dev)
        got = flash_bridged_attention(*args)
        torch.cuda.synchronize()
        f32 = [None if t is None else (t.float() if t.is_floating_point() else t)
               for t in args]
        want = flash_bridged_attention_plain(*f32)
        err = (got.float() - want).abs().max().item()
        # the kernel rounds its fp32 result to bf16 (half an ulp: at most
        # 2^-8 of the largest output) and sums in another order than the
        # fp32 reference (well under 1e-4 at these sizes)
        tol = want.abs().max().item() * 2.0 ** -8 + 1e-4
        masked_rows_ok = bool(torch.isfinite(got[2:, :3]).all())
        ms = cuda_ms(lambda: flash_bridged_attention(*args))
        plain_ms = cuda_ms(lambda: flash_bridged_attention_plain(*args))
        print(f"kernel use_bridge={use_bridge}: max_abs_err {err:.6g} "
              f"(tol {tol:.6g}: bf16 rounding of the output, 2^-8 of max|ref|, "
              f"+ 1e-4 for fp32 summation order), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]")
        if not err <= tol or not masked_rows_ok:
            raise AssertionError(f"flash kernel disagrees with the plain "
                                 f"version (use_bridge={use_bridge})")
        report[use_bridge] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return report


def full_path(card: str, dev, cfg, vq_cfg):
    """Chat + TTFT/decode timing at the given configs. Returns the flash
    launch count of the chat run and the prompt length."""
    from libra_tpu_torch.generation import GenerationConfig, _prefill
    from libra_tpu_torch.models import libra as M, vqgan
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    from libra_tpu_torch.pipeline import LibraPipeline
    from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                              SimpleTextTokenizer)
    from libra_tpu_torch.training.fused import maybe_normalize_pixels

    if vq_cfg.clip_feature_dim != cfg.contiguous_signal_size:
        raise ValueError("the CLIP taps must give contiguous_signal_size channels")
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = decoder_params(cfg, g, dev)
        vq_params = vqgan.init_params(g, vq_cfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"init: {n_params / 1e9:.3f}B decoder params in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")

    text_tok = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
    img_tok = ImageTokenizer(vq_cfg, vq_params, cfg.vocab_size,
                             cfg.max_vision_token_length)
    pipe = LibraPipeline(cfg, params, LibraTokenizer(text_tok, img_tok),
                         functools.partial(maybe_normalize_pixels, vq_cfg))
    pix_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    S = vq_cfg.clip.image_size
    images = [torch.randint(0, 256, (S, S, 3), generator=pix_gen,
                            device=dev, dtype=torch.uint8) for _ in range(B)]

    # --- the main path, with every kernel count at zero ---
    torch.cuda.reset_peak_memory_stats()
    flash_bridged_attention.launches = 0
    t0 = time.perf_counter()
    answers = pipe.chat(QUESTIONS, images=images, max_new_tokens=16)
    torch.cuda.synchronize()
    chat_s = time.perf_counter() - t0
    launches = flash_bridged_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"chat: {len(answers)} answers in {chat_s:.3f} s (first call), "
          f"peak memory {peak_gb:.3f} GB, flash launches {launches} [{card}]")
    if launches != cfg.num_hidden_layers:
        raise AssertionError(f"expected {cfg.num_hidden_layers} flash launches "
                             f"in one prefill, got {launches}")
    if len(answers) != B or not all(isinstance(a, str) for a in answers):
        raise AssertionError("chat did not answer every question")

    # --- prompt-pass logits: finite at full depth; on a small input (two
    # layers, full width, the same prompts) equal to the prompt pass with
    # the kernel's plain version in its place ---
    inputs = pipe._tokenize(pipe_prompts(pipe), images)
    N = inputs["input_ids"].shape[-1]
    args = (inputs["input_ids"], inputs["attention_mask"],
            inputs["vision_indices"], inputs["coninous_signal"])
    gen = GenerationConfig(max_new_tokens=1, eos_token_id=-1)
    small_cfg = cfg.replace(num_hidden_layers=2)
    with torch.inference_mode():
        logits = _prefill(params, *args, cfg=cfg, gen=gen).logits
        small = decoder_params(small_cfg, g, dev)
        got = _prefill(small, *args, cfg=small_cfg, gen=gen).logits
        with mock.patch.object(M, "flash_bridged_attention",
                               flash_bridged_attention_plain):
            want = _prefill(small, *args, cfg=small_cfg, gen=gen).logits
        del small
    text = logits[0, :, :cfg.vocab_size]
    got, want = got[0, :, :cfg.vocab_size], want[0, :, :cfg.vocab_size]
    rel = ((got - want).norm() / want.norm()).item()
    print(f"prefill: N={N}, logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(text).all())}; 2-layer logits vs the plain "
          f"version: relative L2 {rel:.6g} (tol {E2E_TOL}) [{card}]")
    if not bool(torch.isfinite(text).all()):
        raise AssertionError("non-finite prefill logits")
    if not rel < E2E_TOL:
        raise AssertionError(f"2-layer logits differ from the plain path by {rel}")

    # --- TTFT and decode rate, the bench's two-run difference ---
    g1 = GenerationConfig(max_new_tokens=1, eos_token_id=-1)
    g64 = GenerationConfig(max_new_tokens=64, eos_token_id=-1)

    def run(gen_cfg):
        t = time.perf_counter()
        res = pipe.generator(inputs, gen_cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t, res

    run(g1)
    run(g64)                                    # warm-up
    flash_bridged_attention.launches = 0
    ttft = min(run(g1)[0] for _ in range(2))
    (t64a, r1), (t64b, r2) = run(g64), run(g64)
    if flash_bridged_attention.launches != 4 * cfg.num_hidden_layers:
        raise AssertionError("each prefill must launch the flash kernel "
                             "once per layer")
    t64 = min(t64a, t64b)
    tok_s = 63 * B / (t64 - ttft)
    new = r1.sequences[:, :, N:]
    if not torch.equal(r1.sequences, r2.sequences):
        raise AssertionError("two greedy runs gave different tokens")
    if bool((new >= cfg.vocab_size).any()):
        raise AssertionError("text positions emitted vision ids")
    print(f"VQA B={B} N={N}: TTFT {ttft * 1e3:.3f} ms, decode {tok_s:.3f} tok/s "
          f"(64 new tokens in {t64 * 1e3:.3f} ms) [{card}]")
    return launches, N


def decoder_params(cfg, g: torch.Generator, dev):
    """Random decoder params on the card, with the bridge B-weights (zero at
    init) filled with N(0, 0.02) so the bridge terms are live."""
    from libra_tpu_torch.models import libra as M
    params = M.init_params(g, cfg, dev)
    attn = params["layers"]["attn"]
    for name in ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis"):
        wb = attn[name]["wb"]
        wb.copy_(torch.randn(wb.shape, generator=g, device=dev) * 0.02)
    return params


def pipe_prompts(pipe):
    from libra_tpu_torch.pipeline import process_prompt
    return [process_prompt(q, pipe.cfg.max_vision_token_length) for q in QUESTIONS]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs "
                           "only on the card")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} [{card}]")

    from libra_tpu_torch.ops import flash_bridge
    t0 = time.perf_counter()
    lib = flash_bridge.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s [{card}]")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    kernel = check_kernel(card, dev)
    from libra_tpu_torch.config import LibraConfig, VQGANConfig
    launches, n_prompt = full_path(
        card, dev, LibraConfig(dtype="bfloat16", param_dtype="bfloat16"),
        VQGANConfig(select_layer=(-2, -1)))
    if n_prompt != NQ:
        raise AssertionError(f"prompt length {n_prompt}, expected {NQ}")

    print(json.dumps({"kernels": [{
        "name": "flash_bridged_attention",
        "route": "cuda",
        "source": "libra_tpu_torch/csrc/flash_bridge.cu",
        "replaces": "libra_tpu/ops/pallas/flash_bridge.py:117",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": kernel[True]["ms"],
        "plain_ms": kernel[True]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
