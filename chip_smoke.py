"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: needs a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles the kernels' six sources of libra_tpu_torch/csrc at once
   (one nvcc each) and prints ptxas' register, shared-memory and spill
   lines, and cuobjdump's SASS instruction mix of the int8 and int4
   matmuls', the decode attention's and the int4 experiment's kernels;
   fails if a kernel of those three decode templates or of B3's wide
   template holds an I2F, or if the products of a decode, wide or rows
   kernel are not on the tensor cores of their type: HMMA (bf16, tf32) for
   B2, B3, the experiment's D and C and B5's weight-only rows, IMMA (int8)
   and no HMMA for the W4A8 modes.
3. flash kernel vs its plain version at the prompt pass's shape (B=4,
   Nq=610, Nk=738, H=32, d=128, bf16), bridge on and off, left-padded
   rows with fully masked query rows included (one row padded by 70
   tokens, more than a key tile, so that live rows start behind masked
   tiles); times beside SDPA's, with TFLOP/s and the share of the bound.
   Also at a chat turn's text delta: Nq = 64 query rows at slots 672 to
   735 of a 1024-slot cache (turn 1's 640 slots and 32 answer tokens
   before them), turn 1's bucket pad and each row's own delta pad masked
   (gaps between the turns), bridge on and off, timed beside SDPA. And at
   the t2i prompt pass: B = 1, Nq = 13 (the t2i prompt, under one query
   tile), its last row a vision query (BOI), bridge on, against Nk = 13
   keys and against the main path's 13 + 578 (the prompt pass's cache, the
   tail masked), timed beside SDPA on the unbridged part.
3b. flash backward kernel vs its plain version at the training shape (B=8,
   Nq=Nk=698, H=32, d=128, bf16), bridge on and off, right-padded rows and
   three left-padded rows (by 70, 3 and 5; fully masked query rows: dq
   exactly 0), every gradient against the plain backward on the same bf16
   inputs; also the forward's row max and denominator, and the forward's
   time at this shape.
4. int8 and int4 matmul kernels vs their plain versions on libra-11b's
   projection shapes (4096->4096, 4096->11008, 11008->4096, 4096->32000
   lm_head) and on 4096->2752 (F not a multiple of the decode templates'
   128-column tile), the weight a layer view of a stacked (8, K, F)
   buffer: int8, and int4 in both a8 modes, at M = 1, 4, 7, 8, 16 (a spec
   verify pass's B * (3 + 1) rows), 62 and 124
   (the serving engine's k = 1 and 2 pixels refills at a 128 bucket), 68
   (the merged chunk's packed rows, B + C = 4 + 64),
   128 (the split prompt pass's text rows) and 160 (the gate's limit), x with a zero
   row at M = 7 and above 8, each case with the template it ran (the
   script raises unless M <= 8 took the decode template and M > 8 the rows
   one); at M = 4, 128 and 160 each kernel's chunked template checked and
   timed beside it, with each one's share of the bound; at M = 128 on
   4096->4096 an x with an odd row pitch, which must take the chunked
   template;
   torch._weight_int8pack_mm timed at M = 4, 16, 68, 128 and 160, and
   torch._weight_int4pack_mm for int4 weight-only at M = 4, 16, 68 and 128; at
   M = 128 on the four projection shapes also _a8_dot (torch._int_mm) on
   the same rows and the route the dense prompt pass takes for the
   projection at M = 2440 (_a8_dot for int8, the dequantized bf16 matmul
   for int4), each with its share of the bound.
5. int8 decode attention vs its plain version (on the same bf16 q) at B=4,
   H=32, d=128, S = 674 (610 + 64), 673, 128, 1024 and 2048: N = 1, 2, 4,
   7, 8 (the decode template) and 16, 64 (the wide template), bridge on
   and off, left-padded rows, a per-query causal bias, a fully masked row;
   each case with the template it ran (the script raises unless N <= 8
   took the decode one and N > 8 the wide one), every template held to the
   plain version on the same bf16 q (all round the probabilities as the
   Pallas kernel does); the clusters of the decode and wide templates that
   fit on the card at each S; at S = 674 each N timed, the wide template
   also at S = 1024 and 2048, and at N = 1, 8 and 64 the rows template
   (the fallback for unaligned operands) checked and timed beside, with
   each one's share of the bound. Also at a chat turn's text delta (N = 64
   at slots 672 onward, S = 1024, the same masked gaps as phase 3's), which
   must take the wide template: checked, timed, with its share of the
   bound, the rows template checked and timed beside it.
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
   plain version patched in; then speculative decoding through the
   Generator (spec_decode = 3, text decode) on the same prompts: the
   bigram drafter (a warm-up, then the better of 2 runs) and drafts read
   from the bigram run's own stream (oracle: the greedy stream under the
   verify pass's numerics, as bench.py reads it; its tokens must equal
   the bigram run's), decode tok/s beside the
   standard run's and tokens a row a verify iteration, their tokens held
   to the standard run's under a tie rule (at a row's first difference
   the standard step's top-2 logit gap must be under 1% (bf16) or 5% of
   the row's logit range), launches derived from their iterations with
   the matmuls at M = 16 and B3 at N = 4, a verify iteration profiled;
   torch.profiler's split of one prompt pass and
   of 4 decode steps by kernel. Then each tree's text-to-image
   (chip_smoke.t2i_path: LibraPipeline.generate_image on a 13-token t2i
   prompt ending in BOI, then 577 dual-path decode steps of batch 1 and the
   VQGAN decoder; the decoder tree the package's init_params', fp32): on
   two layers at full width, a greedy call with launches derived from the
   config and the tree's leaves (B1 a layer in the prompt pass; in the
   quantized trees B2 / B5 for every body weight a kernel takes at the
   prompt's rows and at 1 row a step, lm_head at 1 row), its tokens held
   at every step to the choice of the same call with every plain version
   patched in, run along the same tokens: equal, or a near tie there (the
   emitted token's logit within 1% / 5% of the vision logits' range of
   the top one), the block's framing (BOI, vision ids on
   both codebooks, the forced newline after it), the prompt pass's and
   the first dual step's vision logits against the plain versions; in
   bf16 then one image on the 32-layer tree's first 8 layers with
   generate_image's defaults (top-k 100, temperature 1, a seeded
   torch.Generator): TTFT, image tokens/s,
   the call's wall and peak memory, launches, the (336, 336, 3) pixels
   finite and equal to decode_code's on the same ids, decode_code against
   itself with TF32 off (relative L2 under 1e-2) and its time (best of 3),
   torch.profiler over 4 dual steps. Then each tree's 2D modes
   (chip_smoke.twod_path): in bf16 one greedy image with 2D prediction and
   2D RoPE at 4 layers (its own seeded tree, 2 * D-input vision heads and
   the placeholder): TTFT, image tokens/s, launches, the block's framing,
   every token held to the plain versions' choice along the same sequence,
   a profile of 4 dual steps through the hidden ring; and the fused VQA
   with 2D RoPE on the 32-layer tree (2D RoPE adds no parameter): TTFT and
   decode tok/s, launches, two runs equal. In every tree, on two layers at
   full width: the 2D-RoPE fused VQA's 64 tokens against the plain
   versions under the tie rule; a 2D-RoPE ChatSession's turn 2 against the
   Generator re-prefilling the history (a8_prefill off on both sides, the
   int4 leaves weight-only: one function) under the tie rule; the 2D
   image's first 64 tokens (past one grid row, so the ring's
   up-neighbours are read) held to the plain versions; and the
   ServingEngine's 4 t2i requests decoded in lockstep through the per-slot
   ring, tokens equal to the Generator's on the same prompts, merged
   prefill off; each with launches derived from the config (2D changes no
   kernel shape). Then each tree's fused-pixels path
   (bench.py:523-556's shape: 32 random text ids and the 578-token image
   block at img_start = 8, the four seeded uint8 images, B = 4): the fused
   image ids against ImageTokenizer's on the same pixels; on two layers at
   full width the prompt pass's and one decode step's logits against the
   plain versions and split_prefill on against off; TTFT and decode tok/s
   with split on and off, best of 2 each in turns after a warm-up, two
   greedy runs equal, launch counts derived from the config (each split
   prompt pass of a quantized tree adds 7 matmul launches a layer, its
   B * 32 = 128 text rows being under the kernels' MAX_M); torch.profiler's
   split of one fused prompt pass by kernel, split on and off, with the
   device time of CLIP + LFQ. Then each tree's multi-turn chat
   (chat.ChatSession, B = 4, max_len 1024, delta_bucket 64, the quantized
   trees with the same options; in int8 also a spec session of two turns
   held to the standard one under the tie rule): three turns of 32 tokens, the fused
   prompt from raw pixels (610 tokens, bucketed to 640) then two text
   deltas of 8 to 29 tokens a row (bucketed to 64); each turn's TTFT (its
   first token on the host) and turn 2's decode tok/s and the peak memory,
   launch counts derived from the turns (B3 once a layer for a delta of 64
   rows in the int8 cache, else B1; a delta's lm_head one matmul launch;
   each step as in a decode), a second session with equal tokens in every
   turn, every delta's int8_decode_attention call on B3's wide template,
   torch.profiler's split of turn 2's delta pass; the Generator
   re-prefilling turn 2's whole history (its TTFT: what the session
   saves); on two layers at full width turn 2's delta-pass and first
   decode-step logits against the plain versions and against
   generation._prefill over the history at the same cache length (in
   int4 with the leaves weight-only on both sides, so that the two
   compute one function). In bf16
   also a three-turn ChatThread (LibraPipeline.start_chat): answers to
   every question, launches derived from its turns. Then each tree's serving engine
   (serving.ServingEngine, raw-pixels requests of the fused shape, the
   quantized trees with the same options): the B fused requests at once
   (one k = 4 group, max_len 674) with tokens equal to the fused
   Generator's; a recycling burst of 8 requests (budgets 8 to 64, bucket
   128, max_len 768, decode_chunk 8) run once, a chunk and the first
   k = 1 refill profiled inside the run, each
   request's prompt-pass and first-decode-step logits (the latter over
   its pool row, recycled for the k = 1 refills) equal to the fused
   Generator's on its prefill group alone at the pool's cache length,
   and so every token of the first and the last k = 1 refill, each
   finishing on its budget, launch counts derived from the run's own
   schedule (its prefill groups and decode steps) and one decode chunk
   under torch.cuda.set_sync_debug_mode("error"); in int8, a spec engine
   (spec_decode = 3) on the lockstep requests held to the standard
   engine's tokens under the tie rule, launches derived from its spec
   chunks, one chunk under set_sync_debug_mode("error"); an open-loop run of the same requests at seeded
   exponential arrivals (TTFT p50 / p95 from arrival, tokens/s,
   requests/s, wall time a chunk against its device time, peak memory);
   on the int8 tree, ServingEngine.warmup once. Then the merged burst: the
   same 8 requests pre-encoded (the image block's ids and signal rows
   from CLIP + LFQ, so 640 % 64 == 0 makes them merged-eligible), the
   engine at merged_chunk 64 with merged_prefill resolving on: a warm-up
   run until the first installed request's first token with one merged
   chunk profiled, then beside the same burst with merged_prefill=False,
   then again with the warm-up's tokens equal, installs and merged
   chunks > 0, every request on its budget, launch counts derived from
   the run's schedule (each packed iteration's matmuls at M = 68), one
   merged chunk under set_sync_debug_mode("error"); TTFT p50 / p95 of
   the installed requests and tokens/s each way; on two layers at full
   width each installed request's first two logits bit for bit those of
   a second merged run, and against the same run with the plain
   versions (every run after the first feeds each request's first decode
   step the first run's prompt-end token, so a near tie there cannot
   make two runs compare different steps) (and, bf16, against merged_prefill=False with the prompt
   pass's attention plain, as the chunk segment's is). Then
   each tree's HTTP server (libra_tpu_torch.serve: ServeApp + make_server
   on a localhost port, the engine phase's settings, max_batch 4, bucket
   128, max_len 768): /healthz, a malformed body (400), then at once four
   POSTs to /v1/generate (two text prompts, two with an image's pixels as
   JSON) and one server-sent-event stream, 16 tokens each; every answer
   the decode of its request's tokens in the scheduler's waves, the
   stream's deltas adding up to its text, each wave replayed through
   ServingEngine.run with equal tokens and equal launches; B1 launched,
   and B2 / B5 and B3 in the quantized trees; requests/s and TTFT p50
   from each request's send (smoke figures of five requests).
6c. checkpoint loading, once in bf16: a reference-layout checkpoint of
   libra-11b at full width cut to 2 layers written to a temporary dir
   (config.json, the decoder's state dict in two pytorch_model-*.bin
   shards, vqgan.ckpt with the quant and post-quant convs, the conv
   decoder at the default VQGANConfig and a loss.* key, the nested CLIP
   ViT-L/14-336 dir; no YAML) from seeded, noised trees on the card by
   the script's inverse mappings (the VQGAN decoder from the package's
   init_params); loaded through the helper
   LibraPipeline.from_pretrained calls: every leaf bit for bit its
   source (the decoder bf16, CLIP and VQGAN fp32); a ServeApp over the
   loaded trees answers a text and a pixels request, tokens equal to an
   engine's over the source trees (CLIP and VQGAN widened to fp32);
   generate_image (greedy) on the loaded trees, tokens equal to the same
   call on the source trees and pixels bit for bit; load time and bytes.
7. the training path: the fused pretrain step (CLIP + LFQ tokenizing inside
   the step, frozen-language AdamW, remat), libra-11b at full width cut to
   4 layers, B=8, N=120+578=698 (bench.py's train-step proxy), for remat
   "big_dots" and "full": one warm-up step and 4 timed steps each, with
   ms/step, tokens/s, MFU, peak memory, loss and grad_norm; frozen leaves
   bitwise unchanged, trainable leaves moved, launch counts as derived from
   the config; on two layers at full width the loss and trainable
   gradients against the same step with the plain versions patched in,
   without dropout and with dropout 0.1 on every site but the attention
   probabilities (the same dropout key both ways), and with attn_pdrop
   0.1 too no flash launch and a finite loss; torch.profiler's split of
   one step by kernel.
7b. the training entry point: libra_tpu_torch.train.run on a run config
   built as a dict (no PyYAML on the card): libra-11b at full width cut to
   4 layers, bf16, frozen language, dropout 0.1 on every site but the
   attention probabilities, the CLIP ViT-L/14-336 + LFQ tokenizer of
   build_model_and_tokenizer's from-scratch branch (two taps), a
   map-style dataset of LAION-format i2t / t2i pair samples built in the
   script (seeded uint8 336x336 images normalized in numpy in place of
   the JPEG decode, captions and label spans through the port's
   caption_format), libra_pretrain.yaml's run section cut to 4 steps of
   2 accumulated micro-batches of 4 (max length 700, remat full): B1 and
   B4 launches equal to 4 steps x 4 layers x 2 micro-batches (x 2 for B1,
   the remat recompute), ms/step, training tokens/s, peak memory, one
   profiled step; on 2 layers 4 straight steps against 2 steps, a save,
   and a fresh run that resumes for 2 more: losses and every leaf bit for
   bit, the checkpoint's bytes and a timed save and restore; one
   update_ema over the 4-layer tree; a debug_model run.
8. the int4 decode-matvec experiment (B6) at its full size (K = 4096,
   O = 11008, L = 8, G = 128, M = 4, Bp = 8): the weight-only kernels D
   (both unpack widths) and C, and the W4A8 kernels in every unpack mode
   (E; H and F, each with and without the int8-domain mask; F at bp = 32),
   against their plain versions at layers 0 and 7 (M = 4), 4 (M = 7, a
   zero row), 1 and 6 (M = 1 and 2: every row count the templates
   instantiate), to 1e-4 of max|ref|, rows >= M exactly 0, timed beside
   torch._weight_int4pack_mm; every one on its decode template (the script
   raises if it takes the other) and on its chunked template alone, each
   checked, the chunked one timed beside the decode one; B5's W4A8 decode
   template (the same function, bf16 out) checked and timed at the same
   shape; then the experiment's entry point,
   libra_tpu_torch.tools.exp_int4.main([]), all 21 rows.

torch.profiler traces the card's activity alone, and the host's operators
only where a record_function region is read (the fused prompt pass's
CLIP + LFQ): their events cost the profiler seconds a call.

Each phase-6, 6c, phase-7, 7b and phase-8 run sets every kernel's launch count
to 0 just before it and reads them just after; the line before the last is the
kernel report as JSON, with the launches summed over those runs and each
kernel's bound (bytes over HBM's 3.35 TB/s or operations over the dense
peak of their type, the larger) from its inputs here: an attention
kernel's cache bytes only at the slots some query leaves unmasked, its
operations only over the unmasked pairs; the last line is
{"ok": true, "device": {...}}. Every number printed stands beside the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
B, NQ, NK, H, HD = 4, 610, 738, 32, 128      # the prompt pass's attention shape
IMG0, IMG1 = 8, 586                          # image block of the kernel checks
PAD_LONG = 70                                # a left pad longer than a key tile
S_DECODE = 674                               # 610 prompt + 64 new tokens
MATMUL_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# int8 (B2) and int4 (B5) also on an F that is not a multiple of the
# decode templates' 128-column tile (libra-11b's vision-MLP bottleneck), at
# the decode row counts 1, 4, 7, 8 (the templates' MT = 1, 4, 8 and a
# ragged 7), 62 and 124 (the serving engine's k = 1 and 2 pixels refills
# at a 128 bucket: k * (640 - 578) text rows, a ragged last n8 tile), 128
# (the split prompt pass's text rows, B * 32) and 160; 68 (M_PACKED, the
# merged chunk's B decode tokens and ENGINE_C prompt tokens); and 16
# (M_VERIFY, a spec-decode verify pass's B * (SPEC_GAMMA + 1) rows)
QUANT_SHAPES = MATMUL_SHAPES + [(4096, 2752)]
# phase 6's speculative decode: SPEC_GAMMA bigram drafts a verify pass
SPEC_GAMMA = 3
M_VERIFY = B * (SPEC_GAMMA + 1)
QUANT_M = (1, 4, 7, 8, M_VERIFY, 62, 68, 124, 128, 160)
M_SPLIT = 128                                # B * (NQ - 578) text rows
M_DENSE = B * NQ                             # the dense prompt pass's rows
LAYERS_11B = 32
# a layer's language projections by shape: q, k, v, o; gate, up; down
PROJECTIONS = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
SEED = 0
MAX_NEW = 64
# phase 6's serving engine: a burst of ENGINE_N pixels requests with budgets
# ENGINE_CHUNK * (i + 1), prompts bucketed to 128 (610 -> 640), max_len 768
ENGINE_N, ENGINE_CHUNK, ENGINE_BUCKET, ENGINE_MAX_LEN = 8, 8, 128, 768
ENGINE_C = 64                                # merged_chunk: prompt tokens an iteration
M_PACKED = B + ENGINE_C                      # a merged iteration's packed rows
# the merged burst's two-layer logits check: decode chunks of one step, so
# that every chunk ends on a step (and the merged chunks run one iteration)
PARITY_BUDGETS = (2, 4, 6, 8, 10, 12)
STRICT_CHUNK = 2                             # the burst's chunk with no sync allowed
STRICT_MERGED = 1                            # the merged burst's merged chunk, likewise
PROFILE_ROWS = 8                             # kernels listed per profile
# phase 6's chat sessions (ChatSession(B, max_len=S_CHAT, delta_bucket=
# CHAT_BUCKET)): turn 1 the fused prompt (NQ tokens, bucketed to 640), then
# text deltas of CHAT_LENS tokens a row (bucketed to 64), CHAT_NEW tokens a
# turn. Turn 2's delta rows sit at slots DELTA_AT.. of the S_CHAT-slot
# cache, after turn 1's 640 slots and its answers: phases 3 and 5 check B1
# and B3 at that shape
S_CHAT, CHAT_BUCKET, CHAT_NEW = 1024, 64, 32
CHAT_LENS = ([8 + 7 * b for b in range(B)], [29 - 7 * b for b in range(B)])
TURN1_PAD = -NQ % CHAT_BUCKET                 # turn 1's left pad in its bucket
DELTA_AT = NQ + TURN1_PAD + CHAT_NEW          # 672
FOLLOW_UPS = [["What else is there?", "Why?", "Which one is larger?", "Describe it again."],
              ["Thanks.", "And the colors?", "Is it outdoors?", "Count them."]]
THREAD_NEW = 8                                # ChatThread's tokens a turn
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
# phase 6's text-to-image (t2i_path): one caption (a 13-token t2i prompt
# ending in BOI), then the image block decoded through both paths: on
# T2I_LAYERS layers in every tree against the plain versions, on the bf16
# tree's first T2I_IMAGE_LAYERS layers once, sampled (a dual step's wall is
# host time, ~3 ms a layer: the 32-layer image took 60-87 s of the
# script); T2I_PROFILED dual steps profiled
T2I_CAPTION = "a watercolor painting of a small red fox in the snow"
T2I_LAYERS = 2
T2I_IMAGE_LAYERS = 8
T2I_PROFILED = 4
# phase 6's 2D modes (twod_path): the image with 2D prediction and 2D RoPE
# at TWOD_IMAGE_LAYERS layers (full width); on two layers, TWOD_STEPS new
# tokens: past one grid row (R = 24), so that the decode reads its
# up-neighbours from the hidden ring
TWOD_IMAGE_LAYERS = 4
TWOD_STEPS = 64
# The decoded image with cuDNN's TF32 convolutions (PyTorch's default on the
# card) against the same decode_code in full fp32: TF32 keeps 10 mantissa
# bits (2^-11 relative a product), summed in fp32 over 9 * Cin terms a conv,
# through ~30 convs and GroupNorms; the pixels' relative L2 is expected
# near 1e-3, and 1e-2 is allowed. A swapped axis or a lost level moves
# them by their whole size.
T2I_TF32_TOL = 1e-2
QUESTIONS = ["What is shown in this picture?",
             "Describe the image.",
             "What color is the left object?",
             "How many people are there?"]
# The card's published rates (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): a kernel's bound is
# the larger of its bytes over HBM_BPS and its operations over PEAK.
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12}
# training phase: bench.py's train-step proxy (bench.py:580-685)
TRAIN_LAYERS, TRAIN_B, TRAIN_TEXT = 4, 8, 120
TRAIN_STEPS = 4
IMG_T = 8                                    # the image block's start
# Two-layer training step, kernels vs plain versions: the loss is a mean
# over 5,584 tokens of log-softmaxes in fp32, so the logits' one-ulp
# differences (E2E_TOL) average out to ~1e-5 of it (measured on an H100:
# 6.6e-6); 1e-4 is allowed. The kernels and the plain backward both round
# p and ds to bf16 before the gradient products, from fp32 values summed in
# another order, so a rounding flips here and there (2^-8 relative for the
# term it hits); the gradients are stored in bf16 (2^-9). The bridge
# leaves take theirs from ds = p (dp - delta), a difference of near-equal
# terms that magnifies those flips (measured on an H100 with the earlier
# fp32 kernels: 0.0034-0.0081 on the bridge leaves, 0.0010-0.0055 on the
# others). Each
# trainable leaf's gradient is held on its own, to a relative L2 of 0.02:
# a dropped bridge term or a wrong mask moves a leaf by its whole size.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.02
# phase 7b, the training entry point (harness_path): libra_pretrain.yaml's
# run section cut to HARNESS_STEPS steps of HARNESS_B samples times
# HARNESS_ACCUM micro-batches; libra-11b at full width cut to
# HARNESS_LAYERS layers, with dropout on every site but the attention
# probabilities (which would take the plain attention)
HARNESS_LAYERS, HARNESS_B, HARNESS_ACCUM, HARNESS_STEPS = 4, 4, 2, 4
HARNESS_MAX_LEN = 700
HARNESS_RATE = 0.1
HARNESS_WORDS = ("a photo of two small red cats sitting on green grass near an old "
                 "wooden house under the blue sky with white clouds").split()
# phase 8, the experiment's shape (tools/exp_int4.py:46-50)
EXP_K, EXP_O, EXP_L, EXP_G, EXP_M, EXP_BP = 4096, 11008, 8, 128, 4, 8
# K = 2816 and 11008 give each block of a cluster 11 and 43 units of 32 k:
# the decode template's shared memory past an odd count of units a slice
EXP_ODD_K, EXP_ODD_O = (2816, 11008), 1024
# D and C against their plain versions: the same products, summed in fp32
# in another order over K = 4096 (each term's rounding is 2^-24 of it;
# ~1e-6 of max|ref| in all); a lost bf16 rounding of D's weights moves the
# output by ~3e-3 of max|ref| (measured at K = 256 on the CPU). The W4A8
# kernels' group sums are exact integers, so only the fp32 sums over the
# 32 groups and the correction differ in order; one flipped rounding of x
# to int8 moves an output by ~1/127 of its row's step, far over 1e-4.
EXP_TOL = 1e-4
KERNELS = [
    dict(name="flash_bridged_attention", module="libra_tpu_torch.ops.flash_bridge",
         source="libra_tpu_torch/csrc/flash_bridge.cu",
         replaces="libra_tpu/ops/pallas/flash_bridge.py:117"),
    dict(name="flash_bridged_attention_bwd", module="libra_tpu_torch.ops.flash_bridge",
         source="libra_tpu_torch/csrc/flash_bridge_bwd.cu",
         replaces="libra_tpu/ops/pallas/flash_bridge.py:268"),
    dict(name="int8_matmul", module="libra_tpu_torch.ops.int8_matmul",
         source="libra_tpu_torch/csrc/int8_matmul.cu",
         replaces="libra_tpu/ops/pallas/int8_matmul.py:59"),
    dict(name="int4_matmul", module="libra_tpu_torch.ops.int4_matmul",
         source="libra_tpu_torch/csrc/int4_matmul.cu",
         replaces="libra_tpu/ops/pallas/int4_matmul.py:140"),
    dict(name="int8_decode_attention", module="libra_tpu_torch.ops.decode_attention",
         source="libra_tpu_torch/csrc/decode_attention.cu",
         replaces="libra_tpu/ops/pallas/decode_attention.py:172"),
    dict(name="int4_exp_d", module="libra_tpu_torch.ops.int4_exp",
         source="libra_tpu_torch/csrc/int4_exp.cu", replaces="tools/exp_int4.py:157"),
    dict(name="int4_exp_c", module="libra_tpu_torch.ops.int4_exp",
         source="libra_tpu_torch/csrc/int4_exp.cu", replaces="tools/exp_int4.py:213"),
    dict(name="int4_exp_e", module="libra_tpu_torch.ops.int4_exp",
         source="libra_tpu_torch/csrc/int4_exp.cu", replaces="tools/exp_int4.py:291"),
    dict(name="int4_exp_a8", module="libra_tpu_torch.ops.int4_exp",
         source="libra_tpu_torch/csrc/int4_exp.cu", replaces="tools/exp_int4.py:420"),
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: float, kind: str = "bf16") -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM_BPS and the operations over the dense peak of their type."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def build(card: str) -> None:
    from libra_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all(dict.fromkeys(ROOT / k["source"] for k in KERNELS))
    print(f"build: {len(libs)} sources of {len(KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel) [{card}]")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {lib.stem}:", line.strip())
    # B2's, B3's and the int4 experiment's decode templates and B3's wide
    # template make their floats without I2F, and their products on the
    # tensor cores of their type; so do B2's and B5's rows templates (whose
    # per-stage index arithmetic may divide by runtime counts, so I2F is not
    # counted there)
    mixes_of = {}
    for stem, kernel, no_i2f in (("int8_matmul-", "int8_decode_kernel", True),
                                 ("decode_attention-", "attn_decode_kernel", True),
                                 ("decode_attention-", "attn_wide_kernel", True),
                                 ("int4_exp-", "int4_exp_decode_kernel", True),
                                 ("int8_matmul-", "rows_kernel", False),
                                 ("int4_matmul-", "rows_kernel", False)):
        lib = next(l for l in libs if l.stem.startswith(stem))
        if lib not in mixes_of:
            mixes_of[lib] = sass_mix(lib)
            for name, mix in mixes_of[lib].items():
                print(f"  sass {lib.stem}: {name}: " + ", ".join(
                    f"{op} {n}" for op, n in sorted(mix.items())))
        ours = {n: mix for n, mix in mixes_of[lib].items() if kernel in n}
        bad = [n for n, mix in ours.items() if (no_i2f and mix["I2F"])
               or not mix[mma_op(n)] or (mma_op(n) == "IMMA" and mix["HMMA"])]
        print(f"  sass {kernel}: " + "; ".join(
            f"{n}: I2F {mix['I2F']}, HMMA {mix['HMMA']}, IMMA {mix['IMMA']}"
            for n, mix in ours.items()) + f" [{card}]")
        if bad or not ours:
            raise AssertionError(f"{kernel} missing, converting with I2F or without "
                                 f"its tensor-core products: {bad}")


SASS_OPS = ("I2F", "PRMT", "FADD", "FFMA", "HFMA2", "HMMA", "IMMA", "LDG", "LDS", "LOP3",
            "BAR")


def mma_op(kernel: str) -> str:
    """The tensor-core opcode a decode or rows kernel (its mangled name)
    must use: IMMA for the W4A8 modes (the int4 experiment's template
    argument MODE_A8 = 2; B5's rows template on rows::Mode<true>), HMMA for
    the others."""
    w4a8 = (re.search(r"int4_exp_decode_kernelILi\d+ELi2E", kernel)
            or re.search(r"rows_kernelI.*ModeILb1E", kernel))
    return "IMMA" if w4a8 else "HMMA"


def sass_mix(lib: Path) -> dict:
    """Per kernel of a built library (its mangled name): the SASS
    instructions in all and those of SASS_OPS by opcode (I2F counts
    every I2F* opcode), from cuobjdump -sass."""
    from libra_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    mix, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            mix[name] = Counter({op: 0 for op in SASS_OPS})
            continue
        ins = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and ins:
            op = ins.group(1)
            mix[name]["all"] += 1
            for want in SASS_OPS:
                if op == want or (want == "I2F" and op.startswith("I2F")):
                    mix[name][want] += 1
    return mix


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def attention_inputs(use_bridge: bool, dev):
    """Prompt-pass inputs: keys span the whole cache (610 prompt slots +
    128 decode slots, the tail masked); rows 1, 2 and 3 are left-padded by
    70, 3 and 5 tokens, so their first query rows are fully masked, and
    row 1's live rows see masked key tiles before their first live key."""
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
    mask[1, :PAD_LONG] = 0
    mask[2, :3] = 0
    mask[3, :5] = 0
    causal = torch.arange(NK, device=dev)[None, :] <= torch.arange(NQ, device=dev)[:, None]
    keep = causal[None, None] & mask.bool()[:, None, None, :]
    bias = torch.where(keep, 0.0, -2.0 ** 30).float()
    return q, k, v, kb, vb, flag_q, flag_kv, bias


def needed_pairs(bias) -> int:
    """The (batch, query, key) pairs whose products the function needs:
    the unmasked ones (bias above BIG_NEG / 2; a masked pair's probability
    is exactly 0 once its row has a live key), and every key of a fully
    masked row (its output is the uniform average)."""
    keep = bias[:, 0] > -2.0 ** 29
    dead = ~keep.any(dim=-1)
    return int(keep.sum().item()) + int(dead.sum().item()) * bias.shape[-1]


def needed_slots(bias) -> torch.Tensor:
    """(B, S): the cache slots a batch row's queries need: those some query
    leaves unmasked, and every slot of a row with a fully masked query (its
    output is the uniform average). bias: (B, 1, Nq, S)."""
    keep = bias[:, 0] > -2.0 ** 29
    return keep.any(dim=1) | (~keep.any(dim=-1)).any(dim=1, keepdim=True)


def cache_bytes(bias, *caches) -> int:
    """The bytes of the cache operands (each (B, S, ...) or head-major
    (B, H, S, ...)) that the function must read: the needed_slots only."""
    need = needed_slots(bias)
    per_slot = sum(t.numel() // need.numel() * t.element_size()
                   for t in caches if t is not None)
    return int(need.sum().item()) * per_slot


def rate_line(ops_needed: float, ops_dense: float, ms: float, bnd: dict) -> str:
    """TFLOP/s over the products the data needs and over the dense
    products (what SDPA, which cannot skip a masked tile, computes), and
    the share of the bound."""
    return (f"{ops_needed / ms / 1e9:.1f} TFLOP/s needed, {ops_dense / ms / 1e9:.1f} "
            f"dense-equivalent, {bnd['bound_ms'] / ms:.2%} of the bound")


def delta_bias(dev) -> torch.Tensor:
    """(B, CHAT_BUCKET, S_CHAT) bias of a chat session's turn-2 delta:
    query i at slot DELTA_AT + i sees the keys up to it, less turn 1's
    bucket pad (slots below TURN1_PAD) and the delta's own left pad (row b
    holds CHAT_LENS[0][b] tokens at the end of the bucket); the keys past
    the delta are unwritten and masked."""
    slots = torch.arange(S_CHAT, device=dev)
    q_at = DELTA_AT + torch.arange(CHAT_BUCKET, device=dev)
    keep = (slots[None, None, :] <= q_at[None, :, None]).expand(
        B, CHAT_BUCKET, S_CHAT).clone()
    keep[:, :, :TURN1_PAD] = False
    for b, n in enumerate(CHAT_LENS[0]):
        keep[b, :, DELTA_AT:DELTA_AT + CHAT_BUCKET - n] = False
    return torch.where(keep, 0.0, -2.0 ** 30).float()


def delta_flags(dev):
    """Text query flags of the delta; key flags with turn 1's image block
    (at TURN1_PAD + IMG_T) set."""
    flag_q = torch.zeros((B, CHAT_BUCKET), dtype=torch.bool, device=dev)
    flag_kv = torch.zeros((B, S_CHAT), dtype=torch.bool, device=dev)
    flag_kv[:, TURN1_PAD + IMG_T:TURN1_PAD + IMG_T + IMG1 - IMG0] = True
    return flag_q, flag_kv


def check_flash_delta(card: str, dev) -> dict:
    """B1 at a chat turn's text delta (phase 3): Nq = CHAT_BUCKET query
    rows at slots DELTA_AT onward against the whole S_CHAT-slot cache,
    masked gaps (delta_bias), bridge on and off, against its plain
    version; timed beside SDPA (no bridge), with the share of the bound.
    Returns the rows by use_bridge."""
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    bias = delta_bias(dev)[:, None]
    flag_q, flag_kv = delta_flags(dev)
    report = {}
    for use_bridge in (True, False):
        def rnd(n):
            return torch.randn((B, n, H, HD), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = rnd(CHAT_BUCKET), rnd(S_CHAT), rnd(S_CHAT)
        kb, vb = (rnd(S_CHAT), rnd(S_CHAT)) if use_bridge else (None, None)
        args = (q, k, v, kb, vb, flag_q, flag_kv, bias)
        got = flash_bridged_attention(*args)
        torch.cuda.synchronize()
        label = (f"flash chat delta Nq={CHAT_BUCKET} Nk={S_CHAT} at slot {DELTA_AT} "
                 f"use_bridge={use_bridge}")
        err = check(label, got, flash_bridged_attention_plain(*args), card)
        ms = cuda_ms(lambda: flash_bridged_attention(*args))
        plain_ms = cuda_ms(lambda: flash_bridged_attention_plain(*args))
        per_pair = 2 * H * HD * (4 if use_bridge else 2)
        ops, dense = per_pair * needed_pairs(bias), per_pair * B * CHAT_BUCKET * S_CHAT
        # q, the flags, the bias and the output whole; k, v, kb, vb at the
        # slots some query needs (turn 1's pad, the delta's pads and the
        # unwritten tail are masked for every query)
        bnd = bound(nbytes(q, flag_q, flag_kv, bias, got)
                    + cache_bytes(bias, k, v, kb, vb), ops)
        lib_ms = None if use_bridge else cuda_ms(lambda: sdpa(q, k, v, bias))
        print(f"{label}: kernel {ms:.4f} ms ({rate_line(ops, dense, ms, bnd)}), plain "
              f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"SDPA {lib_ms} ms" + ("" if lib_ms is None else
                                     f" (kernel at {lib_ms / ms:.2f}x its speed)")
              + f" [{card}]")
        report[use_bridge] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, **bnd)
    return report


def t2i_prompt_len() -> int:
    """The t2i prompt's length for T2I_CAPTION (BOS, its words, BOI)."""
    from libra_tpu_torch.pipeline import t2i_prompt
    from libra_tpu_torch.tokenization import SimpleTextTokenizer
    return len(SimpleTextTokenizer(32000).encode_one(t2i_prompt(T2I_CAPTION)))


def check_flash_t2i(card: str, dev) -> dict:
    """B1 at the t2i prompt pass's shape (phase 3): B = 1, Nq = the t2i
    prompt's length, under one query tile, its last row a vision query
    (BOI, flagged in the keys too), bridge on; keys Nk = Nq, and the main
    path's Nk = Nq + 578 (the cache of generate_image's prompt pass, the
    tail unwritten and masked). Against the plain version, timed beside
    SDPA on the unbridged part (no library call computes the bridged
    function). Returns the rows by Nk."""
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    n = t2i_prompt_len()
    report = {}
    for nk in (n, n + 578):
        def rnd(m):
            return torch.randn((1, m, H, HD), generator=g, device=dev).to(torch.bfloat16)
        q, k, v, kb, vb = rnd(n), rnd(nk), rnd(nk), rnd(nk), rnd(nk)
        flag_q = torch.zeros((1, n), dtype=torch.bool, device=dev)
        flag_q[:, -1] = True
        flag_kv = torch.zeros((1, nk), dtype=torch.bool, device=dev)
        flag_kv[:, n - 1] = True
        keep = torch.arange(nk, device=dev)[None, :] <= torch.arange(n, device=dev)[:, None]
        bias = torch.where(keep, 0.0, -2.0 ** 30).float()[None, None]
        args = (q, k, v, kb, vb, flag_q, flag_kv, bias)
        got = flash_bridged_attention(*args)
        torch.cuda.synchronize()
        label = f"flash t2i prompt B=1 Nq={n} Nk={nk} last row vision use_bridge=True"
        err = check(label, got, flash_bridged_attention_plain(*args), card)
        ms = cuda_ms(lambda: flash_bridged_attention(*args))
        plain_ms = cuda_ms(lambda: flash_bridged_attention_plain(*args))
        per_pair = 2 * H * HD * 4
        ops, dense = per_pair * needed_pairs(bias), per_pair * n * nk
        bnd = bound(nbytes(q, flag_q, flag_kv, bias, got) + cache_bytes(bias, k, v, kb, vb),
                    ops)
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, bias))
        print(f"{label}: kernel {ms:.4f} ms ({rate_line(ops, dense, ms, bnd)}), plain "
              f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"SDPA on the unbridged part {lib_ms:.4f} ms [{card}]")
        report[nk] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          **bnd)
    return report


def check_flash(card: str, dev) -> dict:
    from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                                  flash_bridged_attention_plain)
    report = {}
    for use_bridge in (True, False):
        args = attention_inputs(use_bridge, dev)
        got = flash_bridged_attention(*args)
        torch.cuda.synchronize()
        # the plain version on the same bf16 inputs: fp32 scores and
        # softmax, p rounded to bf16 for the value products, as the kernel
        err = check(f"flash use_bridge={use_bridge}", got,
                    flash_bridged_attention_plain(*args), card)
        if not (bool(torch.isfinite(got[2:, :3]).all())
                and bool(torch.isfinite(got[1, :PAD_LONG]).all())):
            raise AssertionError("fully masked query rows must stay finite")
        ms = cuda_ms(lambda: flash_bridged_attention(*args))
        plain_ms = cuda_ms(lambda: flash_bridged_attention_plain(*args))
        q, k = args[0], args[1]
        # the products the function needs: QK^T and PV, with the bridge
        # also QKb^T and (P cross)Vb, over the pairs the mask leaves
        per_pair = 2 * H * HD * (4 if use_bridge else 2)
        ops, dense = per_pair * needed_pairs(args[7]), per_pair * B * NQ * NK
        # the keys and values at the slots some query needs (the decode
        # tail is masked for every query); the rest whole
        bnd = bound(nbytes(q, *args[5:], got) + cache_bytes(args[7], *args[1:5]), ops)
        # no library call computes the bridged function; without the
        # bridge, SDPA with the additive mask does
        lib_ms = None if use_bridge else cuda_ms(lambda: sdpa(q, k, args[2], args[7]))
        print(f"flash use_bridge={use_bridge}: kernel {ms:.4f} ms "
              f"({rate_line(ops, dense, ms, bnd)}), plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; dense products "
              f"{dense / PEAK['bf16'] * 1e3:.4f} ms), SDPA {lib_ms} ms"
              + ("" if lib_ms is None else f" ({dense / lib_ms / 1e9:.1f} TFLOP/s)")
              + f" [{card}]")
        report[use_bridge] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, **bnd)
    return dict(report[True], max_abs_err=max(r["max_abs_err"] for r in report.values()))


def sdpa(q, k, v, bias):
    """torch's scaled_dot_product_attention on (B, N, H, d) operands with
    the additive (B, 1, Nq, Nk) bias: the library call that computes the
    unbridged function (a yardstick only; the port never calls it)."""
    F = torch.nn.functional
    t = [x.transpose(1, 2) for x in (q, k, v)]
    return F.scaled_dot_product_attention(*t, attn_mask=bias.to(q.dtype)).transpose(1, 2)


def train_attention_inputs(use_bridge: bool, dev):
    """Training-shape inputs (B=8, N=120+578=698, the image block at 8):
    rows 1-5 right-padded by 7r tokens, as the tokenizer pads captions;
    rows 0, 6 and 7 left-padded by 70, 3 and 5, so their first query rows
    see no key. Returns the forward's arguments and an output cotangent."""
    from libra_tpu_torch.ops.attention import causal_bias
    Bt, N, Mv = TRAIN_B, TRAIN_TEXT + 578, 578
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rnd():
        return torch.randn((Bt, N, H, HD), generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(), rnd(), rnd()
    kb, vb = (rnd(), rnd()) if use_bridge else (None, None)
    flag = torch.zeros((Bt, N), dtype=torch.bool, device=dev)
    flag[:, IMG_T:IMG_T + Mv] = True
    mask = torch.ones((Bt, N), dtype=torch.int64, device=dev)
    for r in range(1, 6):
        mask[r, N - 7 * r:] = 0
    mask[0, :PAD_LONG] = 0
    mask[6, :3] = 0
    mask[7, :5] = 0
    return (q, k, v, kb, vb, flag, flag, causal_bias(mask, N, N)), rnd()


def check_flash_bwd(card: str, dev) -> dict:
    """The backward kernel against the plain backward on the same bf16
    inputs (which rounds p and ds to bf16 before the gradient products, as
    the kernel does), with the forward kernel's row max and denominator
    checked against the plain softmax's on fp32 copies on the way; dq
    exactly 0 on the fully masked rows."""
    from libra_tpu_torch.ops import flash_bridge as FB
    report = {}
    for use_bridge in (True, False):
        args, do = train_attention_inputs(use_bridge, dev)
        Bt, N = args[0].shape[:2]
        out, (m, l) = FB._launch_fwd(*args, stats=True)
        grads = FB.flash_bridged_attention_bwd(*args, out, do, m, l)
        torch.cuda.synchronize()
        f32 = [None if t is None else (t.float() if t.is_floating_point() else t)
               for t in args]
        _, m_ref, l_ref = FB._probs(f32[0], f32[1], f32[3], *f32[5:])
        m_err = (m - m_ref[..., 0]).abs().max().item()
        l_err = ((l - l_ref[..., 0]).abs() / l_ref[..., 0]).max().item()
        print(f"flash fwd stats use_bridge={use_bridge}: row max max_abs_err "
              f"{m_err:.6g} (tol 1e-4), denominator max rel err {l_err:.6g} "
              f"(tol 1e-4: fp32 sums in another order) [{card}]")
        if not (m_err <= 1e-4 and l_err <= 1e-4):
            raise AssertionError("the forward kernel's softmax stats disagree")
        want = FB.flash_bridged_attention_bwd_plain(*args, out, do)
        errs = [check(f"flash bwd {name} use_bridge={use_bridge}", g, w, card)
                for name, g, w in zip(("dq", "dk", "dv", "dkb", "dvb"), grads, want)
                if g is not None]
        if not (bool((grads[0][6, :3] == 0).all()) and bool((grads[0][7, :5] == 0).all())
                and bool((grads[0][0, :PAD_LONG] == 0).all())):
            raise AssertionError("fully masked query rows must get dq == 0")
        ms = cuda_ms(lambda: FB.flash_bridged_attention_bwd(*args, out, do, m, l),
                     n=5, reps=3)
        plain_ms = cuda_ms(lambda: FB.flash_bridged_attention_bwd_plain(*args, out, do),
                           n=2, reps=3)
        fwd_ms = cuda_ms(lambda: FB._launch_fwd(*args, stats=True), n=5, reps=3)
        # the products the function needs: s = QK^T, dp = dO V^T, dq = ds K,
        # dk = ds^T Q, dv = P^T dO; with the bridge also sb = QKb^T,
        # dpb = dO Vb^T, dq += dsb Kb, dkb = dsb^T Q, dvb = (P cross)^T dO;
        # over the pairs the mask leaves
        per_pair = 2 * H * HD * (10 if use_bridge else 5)
        ops, dense = per_pair * needed_pairs(args[7]), per_pair * Bt * N * N
        bnd = bound(nbytes(*args, out, do, m, l, *grads), ops)
        lib = ""
        if not use_bridge:
            # SDPA's forward + backward minus its forward: the library's
            # backward for the unbridged function (no single call)
            qg, kg, vg = (t.detach().requires_grad_(True) for t in args[:3])
            bias = args[7]

            def lib_step():
                o = sdpa(qg, kg, vg, bias)
                torch.autograd.grad(o, (qg, kg, vg), do)
            lib_fb = cuda_ms(lib_step, n=5, reps=3)
            lib_f = cuda_ms(lambda: sdpa(args[0], args[1], args[2], bias), n=5, reps=3)
            lib = (f", SDPA fwd+bwd {lib_fb:.4f} ms - fwd {lib_f:.4f} ms = "
                   f"{lib_fb - lib_f:.4f} ms ({dense / (lib_fb - lib_f) / 1e9:.1f} "
                   f"TFLOP/s)")
        fwd_ops = ops * (4 if use_bridge else 2) // (10 if use_bridge else 5)
        print(f"flash bwd use_bridge={use_bridge} B={Bt} N={N}: kernel {ms:.4f} "
              f"ms ({rate_line(ops, dense, ms, bnd)}), plain {plain_ms:.4f} ms, "
              f"forward kernel {fwd_ms:.4f} ms ({fwd_ops / fwd_ms / 1e9:.1f} TFLOP/s "
              f"needed), bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; dense "
              f"products {dense / PEAK['bf16'] * 1e3:.4f} ms){lib} [{card}]")
        report[use_bridge] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                  library_ms=None, **bnd)
        del args, do, out, grads, want, f32
        torch.cuda.empty_cache()
    return dict(report[True], max_abs_err=max(r["max_abs_err"] for r in report.values()))


def check_matmuls(card: str, dev) -> dict:
    """Each case against its plain version on the same inputs, from bf16 x
    in fp32; timed on layer views that rotate over the 8 layers of the
    stacked buffer, so each launch reads its weights from device memory
    (8 layers exceed the 50 MB L2 at every shape), as a decode step does.
    Each case names the template it ran and must take the decode template
    at M <= 8 and the rows template above. At M = 4, 128 and 160 each
    kernel also runs its chunked template alone (the one unaligned
    operands take), checked and timed in the same way; at M = 128 on
    4096->4096 an x with an odd row pitch must
    take the chunked template, checked too. At M = 128 (the split prompt
    pass's language projections, rows template) each case
    is timed beside the library calls for its rows (weight-only:
    torch._weight_int8pack_mm / _weight_int4pack_mm; int8: _a8_dot on
    torch._int_mm) and beside the route the dense prompt pass takes for
    the same projection at M = 2440 (qdot: _a8_dot for int8 weights, the
    dequantized bf16 matmul for int4), the cost the split removes."""
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    L = 8
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    report = {"int8_matmul": [], "int4_matmul": []}
    for K, F in QUANT_SHAPES:
        q = torch.randint(-127, 128, (L, K, F), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((L, 1, F), generator=g, device=dev) * 2e-3
        packed = torch.randint(-128, 128, (L, K // 2, F), generator=g, device=dev,
                               dtype=torch.int8)
        s4 = torch.rand((L, K // 128, F), generator=g, device=dev) * 2e-2
        for M in QUANT_M:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            if M == 7 or M > 8:
                x[3] = 0   # a zero row: its absmax takes the scale 1
            cases = [("int8_matmul", "", I8.int8_matmul, I8.int8_matmul_plain,
                      lambda l: (q[l], s[l]), int8_template, int8_chunked)]
            for a8 in (False, True):
                cases.append((
                    "int4_matmul", f" a8={a8}",
                    functools.partial(I4.int4_matmul, group=128, a8=a8),
                    functools.partial(I4.int4_matmul_plain, group=128, a8=a8),
                    lambda l: (packed[l], s4[l]),
                    functools.partial(int4_template, group=128),
                    functools.partial(int4_chunked, group=128, a8=a8)))
            for name, tag, kernel, plain, layer, which, chunked in cases:
                a8 = "a8=True" in tag
                template = which(x, *layer(3))
                label = f"{name}{tag} M={M} {K}->{F} [{template}]"
                if template != matmul_template(M):
                    raise AssertionError(f"{label}: M = {M} took the {template} template")
                got = kernel(x, *layer(3))
                torch.cuda.synchronize()
                want = plain(x.float(), *layer(3))
                err = check(label, got, want, card)
                turn = itertools.cycle(range(L))
                ms = cuda_ms(lambda: kernel(x, *layer(next(turn))))
                plain_ms = cuda_ms(lambda: plain(x, *layer(next(turn))))
                bnd = bound(nbytes(x, *layer(3), got), 2 * M * K * F,
                            "int8" if a8 else "bf16")
                lib_ms = None
                if name == "int8_matmul" and M in (4, M_VERIFY, M_PACKED, M_SPLIT, 160):
                    lib_ms = int8_library_ms(x, q, s, want, label, card)
                elif (name == "int4_matmul" and M in (4, M_VERIFY, M_PACKED, M_SPLIT)
                      and not a8):
                    lib_ms = int4_library_ms(x, packed, s4, 128, card)
                row = dict(M=M, K=K, F=F, tag=tag, template=template, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bnd)
                if M == M_SPLIT and (K, F) in MATMUL_SHAPES:
                    row.update(prompt_routes(name, a8, x, q, s, packed, s4, want,
                                             label, card))
                extra = ""
                if M in (4, M_SPLIT, 160):
                    row["chunked_err"] = check(f"{label} chunked template",
                                               chunked(x, *layer(3)), want, card)
                    row["chunked_ms"] = cuda_ms(lambda: chunked(x, *layer(next(turn))))
                    extra = (f", chunked template {row['chunked_ms']:.4f} ms "
                             f"({bnd['bound_ms'] / row['chunked_ms']:.1%})")
                if M == M_SPLIT and (K, F) == MATMUL_SHAPES[0]:
                    row["unaligned_err"] = unaligned(label, kernel, which, x, layer(3),
                                                     want, card)
                print(f"{label}: kernel {ms:.4f} ms ({bnd['bound_ms'] / ms:.1%} of the "
                      f"bound){extra}, plain {plain_ms:.4f} ms, bound "
                      f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library {lib_ms} ms"
                      + ("" if lib_ms is None else f" ({bnd['bound_ms'] / lib_ms:.1%})")
                      + f" [{card}]")
                report[name].append(row)
        del q, s, packed, s4
    for name, rows in report.items():
        print(f"{name} at M = 4 (ms, share of the bound: decode template; chunked "
              "template; library): " + "; ".join(
                  f"{r['K']}->{r['F']}{r['tag']} {r['template']} {r['ms']:.4f} "
                  f"({r['bound_ms'] / r['ms']:.1%} of {r['bound_ms']:.4f}), chunked "
                  f"{r['chunked_ms']:.4f} ({r['bound_ms'] / r['chunked_ms']:.1%}), "
                  f"library {r['library_ms']}"
                  + ("" if r["library_ms"] is None
                     else f" ({r['bound_ms'] / r['library_ms']:.1%})")
                  for r in rows if r["M"] == 4) + f" [{card}]")
        print(f"{name} at M = {M_SPLIT}, the split prompt pass's rows (ms, share of "
              f"the bound): " + "; ".join(
                  f"{r['K']}->{r['F']}{r['tag']} {r['template']} {r['ms']:.4f} "
                  f"({r['bound_ms'] / r['ms']:.1%} of {r['bound_ms']:.4f}), chunked "
                  f"{r['chunked_ms']:.4f} ({r['bound_ms'] / r['chunked_ms']:.1%}), library "
                  + ("none" if r["library_ms"] is None else
                     f"{r['library_ms']:.4f} ({r['bound_ms'] / r['library_ms']:.1%})")
                  + ("" if r.get("a8_ms") is None else
                     f", _a8_dot {r['a8_ms']:.4f} ({r['bound_ms'] / r['a8_ms']:.1%})")
                  + f", dense route at M = {M_DENSE} {r['dense_ms']:.4f} "
                  f"({r['dense_bound_ms'] / r['dense_ms']:.1%} of "
                  f"{r['dense_bound_ms']:.4f})"
                  for r in rows if r["M"] == M_SPLIT and "dense_ms" in r)
              + f" [{card}]")
        for m, what in ((M_VERIFY, "a spec-decode verify pass's rows"),
                        (M_PACKED, "the merged chunk's packed rows")):
            print(f"{name} at M = {m}, {what} (ms, share of "
                  f"the bound): " + "; ".join(
                      f"{r['K']}->{r['F']}{r['tag']} {r['template']} {r['ms']:.4f} "
                      f"({r['bound_ms'] / r['ms']:.1%} of {r['bound_ms']:.4f}), plain "
                      f"{r['plain_ms']:.4f}, library "
                      + ("none" if r["library_ms"] is None else
                         f"{r['library_ms']:.4f} ({r['bound_ms'] / r['library_ms']:.1%})")
                      for r in rows if r["M"] == m) + f" [{card}]")
        for tag in sorted({r["tag"] for r in rows}):
            split = {(r["K"], r["F"]): r for r in rows
                     if r["M"] == M_SPLIT and r["tag"] == tag and "dense_ms" in r}
            per_pass = {key: LAYERS_11B * sum(n * split[kf][key]
                                              for kf, n in PROJECTIONS.items())
                        for key in ("ms", "chunked_ms", "dense_ms")}
            print(f"{name}{tag} per prompt pass of libra-11b ({LAYERS_11B} layers x "
                  f"q, k, v, o, gate, up, down): the split's {7 * LAYERS_11B} launches "
                  f"at M = {M_SPLIT} {per_pass['ms']:.3f} ms (rows template; the "
                  f"chunked template {per_pass['chunked_ms']:.3f} ms) against the dense "
                  f"route at M = {M_DENSE} {per_pass['dense_ms']:.3f} ms [{card}]")
    return report


def unaligned(label, kernel, which, x, weights, want, card) -> float:
    """x's rows with an odd row pitch (a view of an (M, K + 1) buffer): the
    kernel must take the chunked template, and agree with the plain
    version as on aligned rows."""
    M, K = x.shape
    xo = torch.empty((M, K + 1), dtype=x.dtype, device=x.device)[:, :K]
    xo.copy_(x)
    template = which(xo, *weights)
    if template != "chunked":
        raise AssertionError(f"{label}: x pitch {K + 1} took the {template} template")
    got = kernel(xo, *weights)
    torch.cuda.synchronize()
    return check(f"{label} x pitch {K + 1} [{template}]", got, want, card)


def prompt_routes(name, a8, x, q, s, packed, s4, want, label, card) -> dict:
    """Beside a kernel at M = M_SPLIT: _a8_dot on its rows (int8 weights,
    checked against the plain version to the w8a8 error), and qdot's route
    for the dense prompt pass's M_DENSE rows of the same projection under
    a8_enabled (_a8_dot for int8 weights; for int4 the dequantized weight
    and a bf16 matmul), each timed on the rotating layers, the dense route
    with its own bound."""
    from libra_tpu_torch.ops.qlinear import _a8_dot, a8_enabled, qdot
    from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray
    L, K = q.shape[0], x.shape[-1]
    turn = itertools.cycle(range(L))
    out = {}
    if name == "int8_matmul":
        got = _a8_dot(x, q[3], s[3])
        rel = ((got.float() - want).norm() / want.norm()).item()
        print(f"{label} _a8_dot: relative L2 {rel:.4g} against the plain version "
              f"(tol {E2E_TOL_QUANT}: activations rounded to int8) [{card}]")
        if not rel < E2E_TOL_QUANT:
            raise AssertionError(f"{label}: _a8_dot disagrees with the plain version")

        def a8_call():
            l = next(turn)
            return _a8_dot(x, q[l], s[l])
        out["a8_ms"] = cuda_ms(a8_call)
        weights = [QuantizedArray(q[l], s[l]) for l in range(L)]
        w_bytes, kind = nbytes(q[0], s[0]), "int8"
    else:
        weights = [Quantized4Array(packed[l], s4[l], 128, a8=a8) for l in range(L)]
        w_bytes, kind = nbytes(packed[0], s4[0]), "bf16"
    xd = torch.randn((M_DENSE, K), generator=torch.Generator(device=x.device)
                     .manual_seed(SEED + 3), device=x.device).to(x.dtype)
    with a8_enabled(True):
        y = qdot(xd, weights[0])
        out["dense_ms"] = cuda_ms(lambda: qdot(xd, weights[next(turn)]))
    dense = bound(nbytes(xd, y) + w_bytes, 2 * M_DENSE * K * y.shape[-1], kind)
    out.update(dense_bound_ms=dense["bound_ms"], dense_bound_by=dense["bound_by"])
    return out


# what int8_matmul_template and int4_matmul_template return
TEMPLATES = {0: "chunked", 1: "decode", 2: "rows"}


def matmul_template(M: int) -> str:
    """The template B2 and B5 must take for M rows of aligned operands."""
    return "decode" if M <= 8 else "rows"


def int8_template(x, q, _scale) -> str:
    """The template int8_matmul launches for x (M, K) and the weight q, as
    the CUDA source's int8_matmul_template decides it."""
    from libra_tpu_torch.ops import _build, int8_matmul as I8
    fn = _build.function(I8.SOURCE, "int8_matmul_template",
                         (ctypes.c_int,) * 3 + (ctypes.c_longlong,) * 2
                         + (ctypes.c_void_p,) * 2)
    return TEMPLATES[fn(x.shape[0], x.shape[-1], q.shape[1], x.stride(0),
                        q.stride(0), x.data_ptr(), q.data_ptr())]


def int8_chunked(x, q, scale):
    """The chunked template alone on x (M, K): the C function
    int8_matmul_chunked, with int8_matmul's arguments (the parent's kernel)."""
    from libra_tpu_torch.ops import _build, int8_matmul as I8
    out = torch.empty((x.shape[0], q.shape[1]), dtype=x.dtype, device=x.device)
    fn = _build.function(I8.SOURCE, "int8_matmul_chunked", I8._ARGTYPES)
    _build.check_launch(I8._launch(fn, x, q, scale, out, _build.stream(x)),
                        "int8_matmul_chunked")
    return out


def int4_template(x, packed, scales, group) -> str:
    """The template int4_matmul launches for x (M, K) and these weights, as
    the CUDA source's int4_matmul_template decides it."""
    from libra_tpu_torch.ops import _build, int4_matmul as I4
    fn = _build.function(I4.SOURCE, "int4_matmul_template",
                         (ctypes.c_int,) * 4 + (ctypes.c_longlong,) * 3
                         + (ctypes.c_void_p,) * 3)
    K = x.shape[-1]
    return TEMPLATES[fn(x.shape[0], K, packed.shape[1], group, x.stride(0),
                        packed.stride(0), scales.stride(0), x.data_ptr(),
                        packed.data_ptr(), scales.data_ptr())]


def int4_chunked(x, packed, scales, group, a8):
    """The chunked template alone on x (M, K): the C function
    int4_matmul_chunked, with int4_matmul's arguments."""
    from libra_tpu_torch.ops import _build, int4_matmul as I4
    out = torch.empty((x.shape[0], packed.shape[1]), dtype=x.dtype, device=x.device)
    fn = _build.function(I4.SOURCE, "int4_matmul_chunked", I4._ARGTYPES)
    _build.check_launch(I4._launch(fn, x, packed, scales, out, group, a8, None,
                                   _build.stream(x)), "int4_matmul_chunked")
    return out


def int8_library_ms(x, q, s, want, label, card):
    """torch._weight_int8pack_mm, x @ (q * scale) with the int8 weight in
    its own (F, K) layout, on the layers' weights rotated as the kernel's
    are: the one PyTorch call of the same function. None, with the reason
    printed, where this build has no such call on the card or it
    disagrees."""
    L = q.shape[0]
    qt = [q[l].t().contiguous() for l in range(L)]
    sc = [s[l, 0].to(x.dtype) for l in range(L)]
    try:
        got = torch._weight_int8pack_mm(x, qt[3], sc[3])
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        print(f"{label}: torch._weight_int8pack_mm unavailable on the card: "
              f"{str(e).splitlines()[0][:120]} [{card}]")
        return None
    if not (got.float() - want).abs().max().item() <= bf16_tol(want) * 4:
        print(f"{label}: torch._weight_int8pack_mm disagrees; not timed [{card}]")
        return None
    turn = itertools.cycle(range(L))

    def call():
        i = next(turn)
        return torch._weight_int8pack_mm(x, qt[i], sc[i])
    return cuda_ms(call)


DA_N = (1, 2, 4, 7, 8, 16, 64)    # the decode template's N, then the wide template's
DA_S = (S_DECODE, S_DECODE - 1, 128, 1024, 2048)
DA_ROWS_N = (1, 8, 64)             # the rows template beside, at S_DECODE


def check_decode_attention(card: str, dev) -> list:
    """Decode steps over an int8 cache of S slots (S = 674: a prompt of 610
    and 64 new tokens; 673, a ragged last unit; 128, one pass a rank; 1024,
    a chat session's cache; 2048, passes): the N query rows sit at the
    slots min(610, S - N) onward (keys past them masked), rows 2 and 3
    left-padded by 3 and 5, batch 0's last query row fully masked (the
    uniform average of V); mixed query flags for N > 1. Layer views of a
    stacked (2, ...) cache. Every template against the plain version on
    the same bf16 q (probabilities rounded to bf16, as the Pallas kernel
    rounds them); at S = 674 every N timed, the wide template (N > 8) also
    at S = 1024 and 2048, and the rows template beside at N in DA_ROWS_N."""
    from libra_tpu_torch.ops.decode_attention import (
        int8_decode_attention, int8_decode_attention_plain)
    L = 2
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for S in DA_S:
        print(f"int8_decode_attention S={S}: clusters resident at once (bridge, no "
              f"bridge): decode template {decode_clusters(S, True)}, "
              f"{decode_clusters(S, False)}; wide template {decode_clusters(S, True, 'wide')}, "
              f"{decode_clusters(S, False, 'wide')} (of {B * H} a call) [{card}]")
    report = []
    for S in DA_S:
        def buf():
            q = torch.randint(-127, 128, (L, B, H, S, HD), generator=g, device=dev,
                              dtype=torch.int8)
            return q, torch.rand((L, B, H, S), generator=g, device=dev) * 0.03 + 1e-3

        bufs = [buf() for _ in range(4)]
        flag_kv = torch.zeros((B, S), dtype=torch.bool, device=dev)
        flag_kv[:, IMG0:IMG1] = True
        for N in DA_N:
            for bridge in (True, False):
                q = torch.randn((B, N, H, HD), generator=g, device=dev).to(torch.bfloat16)
                flag_q = torch.zeros((B, N), dtype=torch.bool, device=dev)
                slots = torch.arange(S, device=dev)
                first = min(NQ, S - N)
                keep = slots[None, None, :] <= (first + torch.arange(N, device=dev))[None, :, None]
                keep = keep.expand(B, N, S).clone()
                keep[2, :, :3] = False
                keep[3, :, :5] = False
                keep[0, N - 1] = False
                if N > 1:
                    flag_q[:, ::2] = True
                bias = torch.where(keep, 0.0, -2.0 ** 30).float()
                fq = flag_q[:, 0] if N == 1 else flag_q
                bias = bias[:, 0] if N == 1 else bias

                def layer(l, bridge=bridge):
                    names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"]
                    ts = [t[l] for pair in bufs[:4 if bridge else 2] for t in pair]
                    return dict(zip(names, ts))

                kw = dict(flag_q=fq, kv_flag=flag_kv, bias=bias)
                template = decode_template(q, **layer(1))
                label = f"int8_decode_attention N={N} bridge={bridge} S={S} [{template}]"
                if template != ("decode" if N <= 8 else "wide"):
                    raise AssertionError(f"{label}: N = {N} took the {template} template")
                got = int8_decode_attention(q, **layer(1), **kw)
                torch.cuda.synchronize()
                # every template rounds its probabilities to bf16 as the
                # Pallas kernel does: the plain version on the same bf16 q
                want = int8_decode_attention_plain(q, **layer(1), **kw,
                                                   out_dtype=torch.float32)
                err = check(label, got, want, card)
                row = dict(N=N, S=S, bridge=bridge, template=template, max_abs_err=err,
                           library_ms=None)
                report.append(row)
                if S != S_DECODE and (N <= 8 or S not in (1024, 2048)):
                    continue
                turn = itertools.cycle(range(L))
                row["ms"] = cuda_ms(lambda: int8_decode_attention(q, **layer(next(turn)), **kw))
                # the cache at the slots some query needs; score and value
                # products over the pairs the mask leaves (x2 with the
                # bridge); no library call reads an int8 cache
                full = torch.where(keep, 0.0, -2.0 ** 30)[:, None]
                row.update(bound(nbytes(q, fq, flag_kv, bias, got)
                                 + cache_bytes(full, *layer(1).values()),
                                 2 * H * HD * (4 if bridge else 2) * needed_pairs(full)))
                extra = ""
                if S == S_DECODE and N in DA_ROWS_N:
                    row["plain_ms"] = cuda_ms(lambda: int8_decode_attention_plain(
                        q, **layer(next(turn)), **kw))
                    row["rows_err"] = check(f"{label} rows template",
                                            decode_rows(q, **layer(1), **kw), want, card)
                    row["rows_ms"] = cuda_ms(lambda: decode_rows(q, **layer(next(turn)), **kw))
                    extra = (f", rows template {row['rows_ms']:.4f} ms "
                             f"({row['bound_ms'] / row['rows_ms']:.1%}), plain "
                             f"{row['plain_ms']:.4f} ms")
                print(f"{label}: kernel {row['ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%} "
                      f"of the bound){extra}, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}) [{card}]")
        del bufs
        torch.cuda.empty_cache()
    print("int8_decode_attention timed (ms, share of the bound: the template it takes; "
          "the rows template): " + "; ".join(
              f"N={r['N']} bridge={r['bridge']} S={r['S']} {r['template']} {r['ms']:.4f} "
              f"({r['bound_ms'] / r['ms']:.1%} of {r['bound_ms']:.4f})"
              + (f", rows {r['rows_ms']:.4f} ({r['bound_ms'] / r['rows_ms']:.1%})"
                 if "rows_ms" in r else "")
              for r in report if "ms" in r) + f" [{card}]")
    return report


def check_decode_delta(card: str, dev) -> list:
    """B3 at a chat turn's text delta (phase 5): N = CHAT_BUCKET query rows
    at slots DELTA_AT onward over an int8 cache of S_CHAT slots (layer
    views of a stacked (2, ...) cache), delta_bias's causal offset and
    gaps, bridge on and off; the wide template must take it. Against the
    plain version on the same bf16 q, timed, with the share of the bound;
    the rows template (the fallback, the parent's kernel for this call)
    checked and timed beside it. Returns phase 5's rows."""
    from libra_tpu_torch.ops.decode_attention import (
        int8_decode_attention, int8_decode_attention_plain)
    L, N = 2, CHAT_BUCKET
    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def buf():
        q = torch.randint(-127, 128, (L, B, H, S_CHAT, HD), generator=g, device=dev,
                          dtype=torch.int8)
        return q, torch.rand((L, B, H, S_CHAT), generator=g, device=dev) * 0.03 + 1e-3

    bufs = [buf() for _ in range(4)]
    flag_q, flag_kv = delta_flags(dev)
    kw = dict(flag_q=flag_q, kv_flag=flag_kv, bias=delta_bias(dev))
    rows = []
    for bridge in (True, False):
        q = torch.randn((B, N, H, HD), generator=g, device=dev).to(torch.bfloat16)

        def layer(l, bridge=bridge):
            names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"]
            ts = [t[l] for pair in bufs[:4 if bridge else 2] for t in pair]
            return dict(zip(names, ts))

        template = decode_template(q, **layer(1))
        label = (f"int8_decode_attention chat delta N={N} S={S_CHAT} at slot {DELTA_AT} "
                 f"bridge={bridge} [{template}]")
        if template != "wide":
            raise AssertionError(f"{label}: N = {N} took the {template} template")
        got = int8_decode_attention(q, **layer(1), **kw)
        torch.cuda.synchronize()
        want = int8_decode_attention_plain(q, **layer(1), **kw, out_dtype=torch.float32)
        err = check(label, got, want, card)
        rows_err = check(f"{label} rows template", decode_rows(q, **layer(1), **kw), want,
                         card)
        turn = itertools.cycle(range(L))
        row = dict(N=N, S=S_CHAT, bridge=bridge, template=template, max_abs_err=err,
                   rows_err=rows_err, library_ms=None,
                   ms=cuda_ms(lambda: int8_decode_attention(q, **layer(next(turn)), **kw)),
                   rows_ms=cuda_ms(lambda: decode_rows(q, **layer(next(turn)), **kw)),
                   plain_ms=cuda_ms(lambda: int8_decode_attention_plain(
                       q, **layer(next(turn)), **kw)))
        # the cache at the slots some query needs; score and value products
        # over the pairs the mask leaves (x2 with the bridge), as phase 5
        # counts them; no library call reads an int8 cache
        full = kw["bias"][:, None]
        row.update(bound(nbytes(q, *kw.values(), got) + cache_bytes(full, *layer(1).values()),
                         2 * H * HD * (4 if bridge else 2) * needed_pairs(full)))
        print(f"{label}: kernel {row['ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%} of "
              f"the bound), rows template {row['rows_ms']:.4f} ms "
              f"({row['bound_ms'] / row['rows_ms']:.2%}), plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
        rows.append(row)
    del bufs
    torch.cuda.empty_cache()
    return rows


DECODE_TEMPLATES = {0: "rows", 1: "decode", 2: "wide"}


def decode_template(q, kq, ks, vq, vs, kbq=None, kbs=None, vbq=None, vbs=None) -> str:
    """The template int8_decode_attention launches for these operands, as
    the CUDA source's int8_decode_attention_template decides it."""
    from libra_tpu_torch.ops import _build, decode_attention as DA
    fn = _build.function(DA.SOURCE, "int8_decode_attention_template",
                         (ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong))
                         + (ctypes.c_void_p,) * 5)
    zeros = torch.zeros((1, 1), device=q.device)   # the flag and bias strides do not decide
    strides = DA._strides(q, kq, ks, zeros, zeros, zeros)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return DECODE_TEMPLATES[fn(q.shape[1], kq.shape[2],
                               (ctypes.c_longlong * DA.N_STRIDES)(*strides),
                               ptr(q), ptr(kq), ptr(vq), ptr(kbq), ptr(vbq))]


def decode_rows(q, kq, ks, vq, vs, kbq=None, kbs=None, vbq=None, vbs=None,
                flag_q=None, kv_flag=None, bias=None):
    """The rows template alone: the C function int8_decode_attention_rows,
    with int8_decode_attention's arguments (the fallback for unaligned
    operands; before the wide template, the kernel of every 8 < N call)."""
    from libra_tpu_torch.ops import _build, decode_attention as DA
    fq, fk, bias = DA._flags_bias(q, kq.shape[2], flag_q, kv_flag, bias)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.function(DA.SOURCE, "int8_decode_attention_rows", DA._ARGTYPES)
    _build.check_launch(DA._launch(fn, q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias,
                                   out, _build.stream(q)), "int8_decode_attention_rows")
    return out


def decode_clusters(S: int, bridge: bool, template: str = "decode") -> int:
    """The clusters of the decode (or wide) template that fit on the card
    at once for a cache of S slots (cudaOccupancyMaxActiveClusters)."""
    from libra_tpu_torch.ops import _build, decode_attention as DA
    name = {"decode": "int8_decode_attention_clusters",
            "wide": "int8_decode_attention_wide_clusters"}[template]
    n = _build.function(DA.SOURCE, name, (ctypes.c_int, ctypes.c_int))(S, int(bridge))
    if n < 1:
        raise AssertionError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {-n}")
    return n


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
    with torch.no_grad():      # not inference_mode: training takes these too
        params = M.init_params(g, cfg, dev)
        attn = params["layers"]["attn"]
        for name in ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis"):
            wb = attn[name]["wb"]
            wb.copy_(torch.randn(wb.shape, generator=g, device=dev) * 0.02)
        if mode != "bf16":
            params = quantize_params(params, bits=8 if mode == "int8" else 4)
    return params


def expected_counts(cfg, mode: str, kv_quant: bool, prefills: int,
                    steps: int, split_prefills: int = 0,
                    text_rows: int = 0) -> Counter:
    """Kernel launches of `prefills` prompt passes and `steps` text-only
    decode steps: the flash kernel once per layer in a prompt pass; in a
    quantized tree one matmul launch per weight matmul at M <= MAX_M (the
    prompt pass's lm_head at the last position, and in each decode step
    the 7 projections q, k, v, o, gate, up, down of every layer and
    lm_head); with the int8 cache one decode-attention launch per layer
    and step. `split_prefills` of the prompt passes are fused ones with
    the split, their language projections on `text_rows` = B * (N - 578)
    rows: where those are at most MAX_M, each adds a matmul launch for
    the 7 projections of every layer."""
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    L = cfg.num_hidden_layers
    want = Counter({k["name"]: 0 for k in KERNELS})
    want["flash_bridged_attention"] = prefills * L
    if MATMUL_KERNEL[mode]:
        max_m = I8.MAX_M if mode == "int8" else I4.MAX_M
        split = split_prefills * 7 * L if text_rows <= max_m else 0
        want[MATMUL_KERNEL[mode]] = prefills + split + steps * (7 * L + 1)
    if kv_quant:
        want["int8_decode_attention"] = steps * L
    return want


def assert_counts(label: str, got: Counter, want: Counter, card: str) -> None:
    print(f"{label}: launches {dict(got)} (expected {dict(want)}) [{card}]")
    if dict(got) != dict(want):
        raise AssertionError(f"{label}: kernel launches {dict(got)}, "
                             f"expected {dict(want)}")


def text_logits(cfg, params, args, gen, tok=None, fused=None):
    """Text-vocab logits of the prompt pass and of the next text-only
    decode step (on `tok`, or on the argmax); and that token. fused:
    _prefill's keywords of the fused-pixels path."""
    from libra_tpu_torch.generation import _prefill, decode_micro_step
    st = _prefill(params, *args, cfg=cfg, gen=gen, **(fused or {}))
    out = {"prompt pass": st.logits[0, :, :cfg.vocab_size].float()}
    tok = torch.argmax(st.logits, dim=-1) if tok is None else tok
    st.mask_buf[:, args[0].shape[-1]] = 1
    step, *_ = decode_micro_step(params, cfg, tok, st.mask_buf, st.cache,
                                 st.vi_last, st.last_pos, lang_only=True)
    out["decode step"] = step[0, :, :cfg.vocab_size].float()
    return out, tok


def plain_kernels():
    """Every kernel's plain version patched in where the model calls it:
    the flash forward and backward where flash_bridged_attention and its
    autograd Function dispatch."""
    from libra_tpu_torch.models import libra as M
    from libra_tpu_torch.ops import decode_attention as DA, flash_bridge as FB
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8

    def plain_forward(q, k, v, kb, vb, flag_q, flag_kv, bias, stats):
        return FB.flash_bridged_attention_plain(q, k, v, kb, vb, flag_q, flag_kv,
                                                bias), ()

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(FB, "_forward", plain_forward))
    stack.enter_context(mock.patch.object(
        FB, "flash_bridged_attention_bwd", FB.flash_bridged_attention_bwd_plain))
    stack.enter_context(mock.patch.object(
        M, "int8_decode_attention", DA.int8_decode_attention_plain))
    stack.enter_context(mock.patch.object(I8, "int8_matmul", I8.int8_matmul_plain))
    stack.enter_context(mock.patch.object(I4, "int4_matmul", I4.int4_matmul_plain))
    return stack


def full_path(card: str, dev, cfg, vq_cfg, vq_params, mode: str,
              main: Counter):
    """Chat, logit checks and TTFT/decode timing for one weight mode, its
    speculative decode (spec_path), its text-to-image (t2i_path), then its
    fused-pixels path, its multi-turn chat sessions (and, in bf16, a
    ChatThread), its serving-engine phase and its HTTP server. Adds the
    main-path runs' kernel launches to `main`; returns the prompt length,
    the fused path's, the chat sessions', the engine's and the spec
    phase's figures (its seconds summed over its three parts: spec_path,
    and in int8 spec_chat and spec_engine), the server's and the t2i
    phase's."""
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

    import libra_tpu_torch.generation as G
    margins = []
    run(g1)
    with logit_margins(G, margins, cfg.vocab_size):
        _, r0 = run(g64)                        # warm-up: the steps' top-2 gaps
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
    if not (torch.equal(r1.sequences, r2.sequences)
            and torch.equal(r0.sequences, r1.sequences)):
        raise AssertionError("three greedy runs gave different tokens")
    if bool((new >= cfg.vocab_size).any()):
        raise AssertionError("text positions emitted vision ids")
    print(f"{mode} VQA B={B} N={N} {qkw}: TTFT {ttft * 1e3:.3f} ms, decode "
          f"{tok_s:.3f} tok/s ({MAX_NEW} new tokens in {t64 * 1e3:.3f} ms) "
          f"[{card}]")
    spec = spec_path(card, cfg, params, mode, pipe.generator, inputs, r1,
                     torch.stack(margins).cpu(), ttft, tok_s, main)
    profile_paths(card, cfg, params, args, g64, mode)
    t2i = t2i_path(card, dev, cfg, vq_cfg, vq_params, params, mode, main)
    t2i["2d"] = twod_path(card, dev, cfg, vq_cfg, vq_params, params, mode,
                          torch.stack(images), main)
    fused, seqs = fused_path(card, dev, cfg, vq_cfg, vq_params, params, mode,
                             torch.stack(images), main)
    chat = chat_path(card, dev, cfg, vq_cfg, vq_params, params, mode,
                     torch.stack(images), main)
    if mode == "bf16":
        chat_thread(card, pipe, images, main)
    engine = engine_path(card, dev, cfg, vq_cfg, vq_params, params, mode,
                         torch.stack(images), seqs, fused["on"]["ttft_ms"], main)
    spec["phase_s"] += chat.get("spec", {}).get("phase_s", 0) + engine.get(
        "spec", {}).get("phase_s", 0)
    serve = serve_path(card, cfg, vq_cfg, pipe, mode, images, main)
    return N, fused, chat, engine, spec, serve, t2i


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def logit_margins(module, sink: list, vocab: int):
    """Patch module.sample_tokens so that each call also appends its
    logits' top2_gap: the tie rule's gap and range at each emitted token
    of a standard run."""
    sample = module.sample_tokens

    def record(logits, gen, generator=None):
        sink.append(top2_gap(logits, vocab))
        return sample(logits, gen, generator)
    return mock.patch.object(module, "sample_tokens", record)


def top2_gap(logits, vocab: int) -> torch.Tensor:
    """Codebook 0's (top-1 minus top-2, max minus min) over the text vocab
    of logits (Q, B, Vc): (B, 2) fp32, on the logits' device."""
    t = logits[0, :, :vocab].float()
    top = t.topk(2, dim=-1).values
    return torch.stack([top[:, 0] - top[:, 1], top[:, 0] - t.amin(dim=-1)], -1)


def tie_rule(label: str, got, want, margins, tol: float, card: str,
             rows: Optional[list] = None) -> list:
    """Spec tokens `got` against a standard run's `want` ((B, n) each), each
    row (of `rows`, default all) up to its first difference, where the
    standard step's top-2 logit gap (`margins` (n, B, 2): gap, range) must
    be under tol of that row's logit range: a near tie, which the verify
    pass's other summation order (B * (gamma + 1) matmul rows, gamma + 1
    attention rows) may flip; past it the two streams continue from
    different tokens. Returns the rows that are equal throughout."""
    same = []
    for b in range(got.shape[0]) if rows is None else rows:
        diff = (got[b] != want[b]).nonzero()
        if not len(diff):
            same.append(b)
            continue
        t = int(diff[0])
        gap, rng = (float(v) for v in margins[t, b])
        print(f"{label}: row {b} first differs at new token {t} ({int(got[b, t])} "
              f"against {int(want[b, t])}): the standard step's top-2 gap {gap:.6g} of "
              f"its range {rng:.6g} ({gap / rng:.4%}; tol {tol:.0%}) [{card}]")
        if not gap < tol * rng:
            raise AssertionError(f"{label}: row {b} differs at token {t} where the "
                                 f"standard step has no near tie")
    return same


def launch_shapes(sink: Counter):
    """Patch the matmul and decode-attention wrappers where the model calls
    them (ops.qlinear's module references, models.libra's name; the
    wrappers' own modules keep theirs, which count the launches), so that
    each call also counts (kernel, rows) in `sink`: a matmul's rows of x,
    the decode attention's query rows N. qdot calls a matmul wrapper only
    where its kernel takes the call."""
    import types
    from libra_tpu_torch.models import libra as M
    from libra_tpu_torch.ops import qlinear

    def recorded(fn, name, rows):
        def wrapped(x, *a, **k):
            sink[(name, rows(x))] += 1
            return fn(x, *a, **k)
        return wrapped

    stack = contextlib.ExitStack()
    for ref in ("i8", "i4"):
        mod = getattr(qlinear, ref)
        name = mod.__name__.rsplit(".", 1)[1]
        proxy = types.SimpleNamespace(**vars(mod))
        setattr(proxy, name, recorded(getattr(mod, name), name,
                                      lambda x: x.numel() // x.shape[-1]))
        stack.enter_context(mock.patch.object(qlinear, ref, proxy))
    stack.enter_context(mock.patch.object(M, "int8_decode_attention", recorded(
        M.int8_decode_attention, "int8_decode_attention", lambda q: q.shape[1])))
    return stack


def verify_counts(cfg, mode: str, kv_quant: bool, iterations: int,
                  prompts: int = 0) -> Counter:
    """(kernel, rows) of `iterations` spec verify passes: the 7
    projections of every layer and lm_head at M_VERIFY rows, B3 at
    SPEC_GAMMA + 1 query rows once a layer with the int8 cache; and of
    `prompts` prompt passes' lm_head at the B last positions."""
    L, mm = cfg.num_hidden_layers, MATMUL_KERNEL[mode]
    want = Counter()
    if mm:
        want[(mm, M_VERIFY)] = iterations * (7 * L + 1)
        if prompts:
            want[(mm, B)] = prompts
    if kv_quant:
        want[("int8_decode_attention", SPEC_GAMMA + 1)] = iterations * L
    return want


def spec_path(card: str, cfg, params, mode: str, generate, inputs, r1, margins,
              ttft: float, std_tok_s: float, main: Counter) -> dict:
    """Speculative decoding through the Generator (gen.spec_decode =
    SPEC_GAMMA, text decode, the quantized trees with kv_quant and
    a8_prefill) on the VQA prompts `inputs`, beside the standard run `r1`
    (its steps' top-2 gaps in `margins`, its TTFT `ttft`, its decode rate
    `std_tok_s`):
      a. the bigram drafter: a warm-up, then two counted runs of MAX_NEW
         tokens, the better one's decode tok/s ((MAX_NEW - 1) * B over its
         time less the standard TTFT) and tokens per verify iteration;
         tokens held to r1's under the tie rule (tie_rule), the warm-up
         and the two runs equal;
      b. oracle drafts read from the bigram run's own stream, the greedy
         stream under the verify pass's numerics (the script swaps
         spec_decode._bigram_drafts, as bench.py does): two counted runs,
         tokens equal to the bigram run's and held to r1's under the tie
         rule, acceptance and tok/s;
      c. each counted run's launches against those derived from its
         iterations (expected_counts: a verify iteration launches what a
         decode step does), and each launch's rows (verify_counts: the
         matmuls at M_VERIFY, B3 at N = SPEC_GAMMA + 1);
      d. torch.profiler over one spec_decode_loop of one verify
         iteration from a prompt pass: its device and wall time.
    Adds the counted runs' launches to `main`; returns the figures."""
    import torch.nn.functional as F
    import libra_tpu_torch.spec_decode as SD
    from libra_tpu_torch.generation import GenerationConfig, _prefill
    t_phase = time.perf_counter()
    quant = mode != "bf16"
    tol = E2E_TOL_QUANT if quant else E2E_TOL
    qkw = dict(kv_quant=True, a8_prefill=True) if quant else {}
    gen = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, decode_modality="text",
                           spec_decode=SPEC_GAMMA, **qkw)
    N = inputs["input_ids"].shape[-1]
    want = r1.sequences[0, :, N:].cpu()

    def counted(label, runs, exact=None):
        shapes, out = Counter(), []
        zero_counts()
        with launch_shapes(shapes):
            for _ in range(runs):
                t = time.perf_counter()
                res = generate(inputs, gen)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t, res))
        got = read_counts()
        main.update(got)
        iters = sum(int(r.iterations) for _, r in out)
        assert_counts(f"{mode} spec {label} ({runs} runs, {iters} verify iterations)",
                      got, expected_counts(cfg, mode, quant, runs, iters), card)
        want_shapes = verify_counts(cfg, mode, quant, iters, runs)
        print(f"{mode} spec {label}: launches by (kernel, rows) {dict(shapes)} "
              f"(expected {dict(want_shapes)}) [{card}]")
        if shapes != want_shapes:
            raise AssertionError(f"{mode} spec {label}: launch shapes {dict(shapes)}")
        seqs = [r.sequences for _, r in out]
        if not all(torch.equal(x, seqs[0]) for x in seqs):
            raise AssertionError(f"{mode} spec {label}: two greedy runs differ")
        if exact is not None and not torch.equal(seqs[0], exact):
            raise AssertionError(f"{mode} spec {label}: tokens differ from the "
                                 f"bigram run's, whose stream the drafts are")
        t, res = min(out, key=lambda o: o[0])
        ng = res.num_generated
        if not bool((ng == MAX_NEW).all()):
            raise AssertionError(f"{mode} spec {label}: num_generated {ng.tolist()}")
        per_iter = float(ng.sum()) / B / int(res.iterations)
        figs = dict(tok_s=(MAX_NEW - 1) * B / (t - ttft), ms=t * 1e3, tok_per_iter=per_iter,
                    accept=(per_iter - 1) / SPEC_GAMMA, iterations=int(res.iterations))
        same = tie_rule(f"{mode} spec {label}", res.sequences[0, :, N:].cpu(), want,
                        margins, tol, card)
        print(f"{mode} spec {label} B={B} gamma={SPEC_GAMMA} {qkw}: decode "
              f"{figs['tok_s']:.3f} tok/s ({MAX_NEW} new tokens in {t * 1e3:.3f} ms; "
              f"the standard run {std_tok_s:.3f} tok/s), {figs['iterations']} verify "
              f"iterations, {per_iter:.4f} tokens a row an iteration (acceptance "
              f"{figs['accept']:.4f}); rows equal to the standard run's throughout "
              f"{same} [{card}]")
        return figs

    bigram = generate(inputs, gen)                           # warm-up
    out = {"bigram": counted("bigram", 2, exact=bigram.sequences)}
    # oracle drafts: the bigram run's own next tokens after each pending,
    # the greedy stream under the verify pass's numerics (bench.py's
    # design; the standard run's stream parts from it at its first near
    # tie, after which its drafts are rejected)
    oracle = F.pad(bigram.sequences[0, :, N:], (0, SPEC_GAMMA + 1))

    def oracle_drafts(hist, valid, P, pending, gamma):
        start = (P - N + 1).clamp_min(0)
        return oracle.gather(1, start[:, None] + torch.arange(gamma, device=P.device))

    with mock.patch.object(SD, "_bigram_drafts", oracle_drafts):
        out["oracle"] = counted("oracle drafts", 2, exact=bigram.sequences)

    # one spec_decode_loop of one verify iteration (max_new 2: the pending
    # token and at least one more), profiled: torch.profiler's cost grows
    # with the events it records
    prof = {}
    args = tuple(inputs[k] for k in ("input_ids", "attention_mask", "vision_indices",
                                     "coninous_signal"))
    with torch.inference_mode():
        st = _prefill(params, *args, cfg=cfg, gen=gen, extra_cache=SPEC_GAMMA + 1)
        hist = F.pad(st.tokens[0], (0, SPEC_GAMMA + 1))
        pending = torch.argmax(st.logits[0], dim=-1)
        hist[:, N] = pending
        P = torch.full((B,), N, dtype=torch.int64, device=pending.device)
        res = profiled(card, f"{mode} spec_decode_loop, one verify iteration "
                       f"({M_VERIFY} rows a forward)",
                       lambda: SD.spec_decode_loop(params, hist, st.mask_buf,
                                                   st.cache._replace(index=P), pending,
                                                   st.last_pos, P, cfg=cfg, gen=gen,
                                                   max_new=2), out=prof)
    n = int(res.iterations)
    out.update(std_tok_s=std_tok_s, verify_device_ms=prof["device_ms"] / n,
               verify_wall_ms=prof["wall_ms"] / n)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{mode} spec phase (Generator): a verify iteration {out['verify_device_ms']:.3f} "
          f"ms device, {out['verify_wall_ms']:.3f} ms wall (profiled, {n} iterations); "
          f"{out['phase_s']:.1f} s [{card}]")
    return out


def fused_inputs(cfg, dev, pixels):
    """bench.py:523-556's batch: B rows of 32 random text ids (a seeded
    torch.Generator) with one image block at IMG_T, unpadded, the prompts
    ending in text; the block's ids are placeholders that the encode
    overwrites."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    n = NQ
    g = torch.Generator().manual_seed(SEED + 4)
    ids = torch.randint(3, cfg.vocab_size, (1, B, n), generator=g).expand(
        Q, B, n).contiguous()
    vi = torch.full((B, n), Mv, dtype=torch.long)
    vi[:, IMG_T:IMG_T + Mv] = torch.arange(Mv)
    return {"input_ids": ids.to(dev), "attention_mask": torch.ones((B, n), dtype=torch.long,
                                                                  device=dev),
            "vision_indices": vi.to(dev), "pixels": pixels,
            "img_start": torch.full((B,), IMG_T, dtype=torch.long, device=dev)}


ENCODE_REGION = "clip+lfq (encode_images_to_tokens)"


def fused_path(card: str, dev, cfg, vq_cfg, vq_params, params, mode: str,
               pixels, main: Counter) -> dict:
    """The fused-pixels path (bench.py::bench_vqa_fused_full32's shape):
    uint8 pixels and img_start through the Generator, CLIP + LFQ inside
    the prompt pass, the language projections on the B * 32 text rows
    (split_prefill), then the decode. Checks the fused image ids against
    ImageTokenizer's, two-layer logits against the plain versions and
    split on against split off, two greedy runs equal, the launch counts;
    times TTFT and decode tok/s with split on and off in turns; profiles
    one prompt pass each way. Adds the timed runs' launches to `main`.
    Returns (TTFT and decode tok/s each way, the split-on sequences of
    MAX_NEW greedy tokens)."""
    from libra_tpu_torch.generation import GenerationConfig, Generator
    from libra_tpu_torch.tokenization import ImageTokenizer
    from libra_tpu_torch.training.fused import (encode_images_to_tokens,
                                                maybe_normalize_pixels)
    quant = mode != "bf16"
    Mv = cfg.max_vision_token_length
    inputs = fused_inputs(cfg, dev, pixels)
    N = inputs["input_ids"].shape[-1]
    text_rows = B * (N - Mv)

    # --- the image ids: the fused encode against the tokenizer's ---
    with torch.inference_mode():
        ids, _ = encode_images_to_tokens(vq_params, vq_cfg, cfg, pixels)
        tok_ids = ImageTokenizer(vq_cfg, vq_params, cfg.vocab_size, Mv).encode(
            maybe_normalize_pixels(vq_cfg, pixels))["input_ids"]
    agree = (ids == tok_ids).float().mean().item()
    print(f"{mode} fused image ids: {ids.shape[-1]} a row, share equal to "
          f"ImageTokenizer's on the same pixels {agree:.6f} [{card}]")
    if agree < 1.0:
        # the same normalization and encode run on both sides; only a
        # feature within rounding of an LFQ sign boundary could flip
        print(f"{mode} fused image ids differ in {1 - agree:.6f} of the codes: "
              f"one LFQ bit flips where a feature sits at 0 within rounding "
              f"[{card}]")
        if agree < 0.99:
            raise AssertionError("the fused encode disagrees with ImageTokenizer")

    # --- two layers at full width: kernels against the plain versions,
    # split on against split off ---
    qkw = dict(kv_quant=True, a8_prefill=True, decode_modality="text") if quant else {}
    gen = GenerationConfig(max_new_tokens=2, eos_token_id=-1, **qkw)
    off = dataclasses.replace(gen, split_prefill=False)
    args = (inputs["input_ids"], inputs["attention_mask"], inputs["vision_indices"],
            None)
    fkw = dict(vq_params=vq_params, pixels=pixels, img_start=inputs["img_start"],
               vq_cfg=vq_cfg)
    small_cfg = cfg.replace(num_hidden_layers=2)
    with torch.inference_mode():
        small = decoder_params(small_cfg, dev, mode)
        got_l, tok = text_logits(small_cfg, small, args, gen, fused=fkw)
        off_l, _ = text_logits(small_cfg, small, args, off, tok, fused=fkw)
        with plain_kernels():
            want_l, _ = text_logits(small_cfg, small, args, gen, tok, fused=fkw)
        del small
    tol = E2E_TOL_QUANT if quant else E2E_TOL

    def rel(a, b):
        return {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in a}
    vs_plain, vs_off = rel(got_l, want_l), rel(got_l, off_l)
    print(f"{mode} fused 2-layer logits, relative L2: split on vs the plain "
          f"versions " + ", ".join(f"{k} {v:.6g}" for k, v in vs_plain.items())
          + "; split on vs split off " + ", ".join(f"{k} {v:.6g}" for k, v in
                                                  vs_off.items())
          + f" (tol {tol}) [{card}]")
    if not max(vs_plain.values()) < tol:
        raise AssertionError(f"fused 2-layer logits differ from the plain path: {vs_plain}")
    if not max(vs_off.values()) < tol:
        raise AssertionError(f"fused 2-layer logits, split on vs off: {vs_off}")

    # --- TTFT and decode rate, split on and off in turns ---
    g = Generator(params, cfg, vq_params=vq_params, vq_cfg=vq_cfg)
    gens = {split: (GenerationConfig(max_new_tokens=1, eos_token_id=-1,
                                     split_prefill=split, **qkw),
                    GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1,
                                     split_prefill=split, **qkw))
            for split in (True, False)}

    def run(gen_cfg):
        t = time.perf_counter()
        res = g(inputs, gen_cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t, res

    for pair in gens.values():                   # warm-up
        for gen_cfg in pair:
            run(gen_cfg)
    zero_counts()
    times = {split: ([], []) for split in gens}
    seqs = []
    for order in ((True, False), (False, True)):
        for split in order:
            t1, _ = run(gens[split][0])
            t64, res = run(gens[split][1])
            times[split][0].append(t1)
            times[split][1].append(t64)
            if split:
                seqs.append(res.sequences)
    got = read_counts()
    main.update(got)
    assert_counts(f"{mode} fused generator (split on and off, each 2 x 1 + 2 x "
                  f"{MAX_NEW} new tokens)", got,
                  expected_counts(cfg, mode, quant, 8, 4 * (MAX_NEW - 1),
                                  split_prefills=4, text_rows=text_rows), card)
    if not torch.equal(seqs[0], seqs[1]):
        raise AssertionError("two fused greedy runs gave different tokens")
    if not torch.equal(seqs[0][:, :, IMG_T:IMG_T + Mv], ids):
        raise AssertionError("the fused prompt does not hold the encoded image ids")
    if bool((seqs[0][:, :, N:] >= cfg.vocab_size).any()):
        raise AssertionError("text positions emitted vision ids")
    stats = {}
    for split, (t1, t64) in times.items():
        ttft, best64 = min(t1), min(t64)
        stats["on" if split else "off"] = dict(
            ttft_ms=ttft * 1e3, tok_s=(MAX_NEW - 1) * B / (best64 - ttft))
    print(f"{mode} fused VQA B={B} N={N} img_start={IMG_T} {qkw}: "
          + "; ".join(f"split {k}: TTFT {v['ttft_ms']:.3f} ms, decode "
                      f"{v['tok_s']:.3f} tok/s" for k, v in stats.items())
          + f" (best of 2 each, in turns) [{card}]")
    profile_fused(card, cfg, params, args, fkw, gens[True][1], mode)
    return stats, seqs[0]


# ---------------------------------------------------------------------------
# Multi-turn chat
# ---------------------------------------------------------------------------

def chat_turns(cfg, dev, pixels) -> list:
    """A chat session's three turns: turn 1 fused_inputs (raw pixels, the
    image block at IMG_T, NQ tokens); turns 2 and 3 text deltas of
    CHAT_LENS tokens a row, left-padded to the longest (random ids from a
    seeded torch.Generator)."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    turns = [fused_inputs(cfg, dev, pixels)]
    for t, lens in enumerate(CHAT_LENS):
        g = torch.Generator().manual_seed(SEED + 20 + t)
        n = max(lens)
        mask = (torch.arange(n)[None] >= n - torch.tensor(lens)[:, None]).long()
        ids = torch.randint(3, cfg.vocab_size, (1, B, n), generator=g) * mask[None]
        turns.append({"input_ids": ids.expand(Q, B, n).to(dev),
                      "attention_mask": mask.to(dev),
                      "vision_indices": torch.full((B, n), Mv, dtype=torch.long,
                                                   device=dev)})
    return turns


def chat_history(cfg, turns, answers, bucket: Optional[int] = None) -> dict:
    """The Generator's input for a conversation's token history: `turns`
    with the TurnResults `answers` after each of the first ones, and turn
    1's raw pixels. bucket=None keeps each row's real tokens only (what a
    client re-sending the conversation sends), the rows left-padded to the
    longest; bucket=k keeps the session's slot layout (each turn left-padded
    to a multiple of k), so the history's slots are the session's cache
    slots."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    rows, starts = [], []
    for b in range(B):
        ids, mask, vi, start = [], [], [], None
        for i, t in enumerate(turns):
            n = t["input_ids"].shape[-1]
            pad = (-n) % bucket if bucket else 0
            m = torch.cat([torch.zeros(pad, dtype=torch.long),
                           t["attention_mask"][b].cpu()])
            keep = torch.ones_like(m, dtype=torch.bool) if bucket else m.bool()
            if i == 0:
                start = int(keep[:pad + IMG_T].sum())
            ids.append(torch.nn.functional.pad(t["input_ids"][:, b].cpu(), (pad, 0))[:, keep])
            mask.append(m[keep])
            vi.append(torch.nn.functional.pad(t["vision_indices"][b].cpu(), (pad, 0),
                                              value=Mv)[keep])
            if i < len(answers):
                k = int(answers[i].num_generated[b])
                ids.append(answers[i].tokens[:, b, :k].cpu())
                mask.append(torch.ones(k, dtype=torch.long))
                vi.append(torch.full((k,), Mv, dtype=torch.long))
        rows.append((torch.cat(ids, -1), torch.cat(mask), torch.cat(vi)))
        starts.append(start)
    n = max(r[1].shape[0] for r in rows)
    out = {"input_ids": torch.zeros((Q, B, n), dtype=torch.long),
           "attention_mask": torch.zeros((B, n), dtype=torch.long),
           "vision_indices": torch.full((B, n), Mv, dtype=torch.long)}
    for b, (ids, mask, vi) in enumerate(rows):
        w = mask.shape[0]
        out["input_ids"][:, b, n - w:] = ids
        out["attention_mask"][b, n - w:] = mask
        out["vision_indices"][b, n - w:] = vi
        starts[b] += n - w
    dev = turns[0]["pixels"].device
    out = {k: v.to(dev) for k, v in out.items()}
    out.update(pixels=turns[0]["pixels"],
               img_start=torch.tensor(starts, dtype=torch.long, device=dev))
    return out


def delta_width(turn) -> int:
    """The rows of a turn's delta pass: its width bucketed to CHAT_BUCKET."""
    return -(-turn["input_ids"].shape[-1] // CHAT_BUCKET) * CHAT_BUCKET


def chat_counts(cfg, mode: str, kv_quant: bool, turns) -> Counter:
    """Kernel launches of a ChatSession's turns, each (rows of its delta
    pass, decode steps, raw pixels): the int8 cache's decode-attention
    gate takes a delta of at most 8 rows, or of a multiple of 8 up to 64
    (B3 once a layer), else the prompt pass's B1 runs once a layer; a
    delta's lm_head at the last position is one matmul launch in a
    quantized tree, and its projections at B x rows (the split's text rows
    with pixels) launch none, being past MAX_M (checked here); each decode
    step as expected_counts counts it."""
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    L, Mv = cfg.num_hidden_layers, cfg.max_vision_token_length
    want = Counter({k["name"]: 0 for k in KERNELS})
    for n, steps, pixels in turns:
        rows = B * (n - Mv if pixels else n)
        if MATMUL_KERNEL[mode] and rows <= (I8.MAX_M if mode == "int8" else I4.MAX_M):
            raise AssertionError(f"a delta of {rows} projection rows takes the matmul "
                                 f"kernels; chat_counts does not count them")
        b3 = kv_quant and (n <= 8 or (n <= 64 and n % 8 == 0))
        want.update(expected_counts(cfg, mode, kv_quant, int(not b3), steps))
        if b3:
            want["int8_decode_attention"] += L
            if MATMUL_KERNEL[mode]:
                want[MATMUL_KERNEL[mode]] += 1
    return want


def chat_turn2_logits(cfg, params, gen, turns, vq_params, vq_cfg, tok=None,
                      plain: bool = False):
    """A fresh session runs turn 1 with the kernels, then turn 2 with one
    new token, with every kernel's plain version patched in when `plain`:
    the text-vocab logits of turn 2's delta pass and of the decode step
    after it (on `tok`, or on the sampled token). Returns (logits, that
    token, turn 1's TurnResult)."""
    from libra_tpu_torch import chat as CH
    sess = CH.ChatSession(params, cfg, batch=B, max_len=S_CHAT, gen=gen,
                          delta_bucket=CHAT_BUCKET, vq_params=vq_params, vq_cfg=vq_cfg)
    first = sess.ask(turns[0], max_new_tokens=CHAT_NEW)
    out = {}
    sample, step = CH.sample_tokens, CH.decode_micro_step

    def sampled(logits, g, generator=None):
        out["delta pass"] = logits[0, :, :cfg.vocab_size].float()
        return sample(logits, g, generator) if tok is None else tok

    def stepped(*args, **kwargs):
        res = step(*args, **kwargs)
        out["decode step"] = res[0][0, :, :cfg.vocab_size].float()
        return res

    with mock.patch.object(CH, "sample_tokens", sampled), \
            mock.patch.object(CH, "decode_micro_step", stepped), \
            (plain_kernels() if plain else contextlib.nullcontext()):
        res = sess.ask(turns[1], max_new_tokens=1)
    return out, res.tokens[:, :, 0], first


def weight_only(tree):
    """The tree with every int4 leaf's a8 flag off (the same tensors): B5
    runs it weight-only, the function its dequantized dense route computes."""
    from libra_tpu_torch.quantization import Quantized4Array
    if isinstance(tree, dict):
        return {k: weight_only(v) for k, v in tree.items()}
    if isinstance(tree, Quantized4Array):
        return Quantized4Array(tree.packed, tree.scale, tree.group, tree.out_features,
                               a8=False)
    return tree


def chat_path(card: str, dev, cfg, vq_cfg, vq_params, params, mode: str, pixels,
              main: Counter) -> dict:
    """Multi-turn chat (chat.ChatSession) on this tree, the quantized trees
    with kv_quant, a8_prefill and text decode: B conversations, max_len
    S_CHAT, delta_bucket CHAT_BUCKET, three turns of CHAT_NEW tokens
    (chat_turns: the fused prompt from raw pixels, then two text deltas),
    in two sessions on the same inputs:
      1. the first, the main path: counted, launches derived from the
         turns (chat_counts); peak memory;
      2. the second: equal tokens in every turn; every int8_decode_
         attention call of more than 8 rows on B3's wide template; then a
         prefill-only turn of turn 2's delta profiled (torch.profiler's
         split of a delta pass; its rows at slot 864 instead of 672);
         each turn's TTFT (its first token on the host) and turn 2's
         decode tok/s: the better of the two sessions;
      3. the Generator re-prefilling turn 2's whole history (chat_history,
         real tokens only), max_new_tokens=1: its TTFT, best of 2;
      4. two layers at full width: turn 2's delta-pass and first decode
         step logits against the same turn with the plain versions, and
         against generation._prefill over the history in the session's
         slot layout at the same cache length (E2E_TOL; quantized
         E2E_TOL_QUANT on a pair that computes one function: a8_prefill
         off on both sides, and in int4 the leaves weight-only (weight_
         only), since B5's decode steps run a W4A8 leaf as W4A8 and the
         re-prefill's 256-row projections dequantize it. The distance with
         a8_prefill on, where the session's answers hold K/V from the
         decode steps and the re-prefill's from the w8a8 prompt pass, is
         printed).
    Adds the counted run's launches to `main`; returns the figures."""
    from libra_tpu_torch import chat as CH
    from libra_tpu_torch.generation import GenerationConfig, Generator
    from libra_tpu_torch.models import libra as M
    t_phase = time.perf_counter()
    quant = mode != "bf16"
    qkw = dict(kv_quant=True, a8_prefill=True, decode_modality="text") if quant else {}
    gen = GenerationConfig(eos_token_id=-1, **qkw)
    turns = chat_turns(cfg, dev, pixels)
    marks, margins = [], None
    sample = CH.sample_tokens

    def first_token(logits, g, generator=None):
        if margins is not None:          # the steps' top-2 gaps (spec_chat)
            margins.append(top2_gap(logits, cfg.vocab_size))
        tok = sample(logits, g, generator)
        if marks and marks[-1] is None:     # a turn's first token, on the host
            torch.cuda.synchronize()
            marks[-1] = time.perf_counter()
        return tok

    def converse(sess):
        """The three turns: (TurnResults, per-turn (rows, steps, pixels),
        TTFT s, wall s)."""
        results, shapes, ttft, walls = [], [], [], []
        with mock.patch.object(CH, "sample_tokens", first_token):
            for turn in turns:
                used = sess.used
                marks.append(None)
                t0 = time.perf_counter()
                results.append(sess.ask(turn, max_new_tokens=CHAT_NEW))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                ttft.append(marks[-1] - t0)
                n = delta_width(turn)
                shapes.append((n, sess.used - used - n, "pixels" in turn))
        return results, shapes, ttft, walls

    def session():
        return CH.ChatSession(params, cfg, batch=B, max_len=S_CHAT, gen=gen,
                              delta_bucket=CHAT_BUCKET, vq_params=vq_params,
                              vq_cfg=vq_cfg)

    # --- 1. the main path, counted ---
    sess = session()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    results, shapes, ttft, walls = converse(sess)
    got = read_counts()
    main.update(got)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert_counts(f"{mode} chat session ({len(turns)} turns, rows and steps "
                  f"{[s[:2] for s in shapes]})", got,
                  chat_counts(cfg, mode, quant, shapes), card)
    if any(steps != CHAT_NEW for _, steps, _ in shapes):
        raise AssertionError(f"{mode} chat: a turn did not run {CHAT_NEW} steps: {shapes}")
    for r in results:
        if bool((r.tokens >= cfg.vocab_size).any()) or not bool((r.num_generated
                                                                  == CHAT_NEW).all()):
            raise AssertionError(f"{mode} chat: vision ids or short answers in a text turn")
    S = sess.S
    del sess

    # --- 2. a second session: equal tokens, B3's wide template, a profiled delta ---
    templates, prof = [], {}
    b3 = M.int8_decode_attention

    def b3_template(q, kq, ks, vq, vs, kbq=None, kbs=None, vbq=None, vbs=None, **kw):
        if q.shape[1] > 8:
            templates.append((q.shape[1], decode_template(q, kq, ks, vq, vs, kbq, kbs,
                                                          vbq, vbs)))
        return b3(q, kq, ks, vq, vs, kbq=kbq, kbs=kbs, vbq=vbq, vbs=vbs, **kw)

    sess = session()
    margins = [] if mode == "int8" else None
    with mock.patch.object(M, "int8_decode_attention", b3_template):
        again, _, ttft2, walls2 = converse(sess)
    profiled(card, f"{mode} chat delta pass of turn 2's input ({B} x {CHAT_BUCKET} rows "
             f"at slot {sess.used}, a prefill-only turn)",
             lambda: sess.ask(turns[1], max_new_tokens=0), out=prof)
    del sess
    same = all(torch.equal(a.tokens, b.tokens) and torch.equal(a.num_generated,
                                                               b.num_generated)
               for a, b in zip(results, again))
    want_t = ([(CHAT_BUCKET, "wide")] * (cfg.num_hidden_layers * (len(turns) - 1))
              if quant else [])
    print(f"{mode} chat second session: tokens equal to the first's in every turn "
          f"{same}; int8_decode_attention calls of more than 8 rows (N, template): "
          f"{sorted(Counter(templates).items())} [{card}]")
    if not same:
        raise AssertionError(f"{mode} chat: two sessions gave different tokens")
    if templates != want_t:
        raise AssertionError(f"{mode} chat: the deltas' decode-attention calls "
                             f"{Counter(templates)}, expected {Counter(want_t)}")
    ttft = [min(a, b) for a, b in zip(ttft, ttft2)]
    tok_s = max((CHAT_NEW - 1) * B / (w[1] - t[1]) for w, t in ((walls, ttft),
                                                              (walls2, ttft2)))
    out = dict(ttft_ms=[t * 1e3 for t in ttft], tok_s=tok_s, peak_gb=peak_gb,
               delta_device_ms=prof["device_ms"])
    if margins is not None:
        out["spec"] = spec_chat(card, cfg, params, gen, turns, vq_params, vq_cfg,
                                again, torch.stack(margins).cpu(), main)
    print(f"{mode} chat session B={B} max_len {S_CHAT} (S = {S}) delta_bucket "
          f"{CHAT_BUCKET} {qkw}: turns of {[s[0] for s in shapes]} rows, {CHAT_NEW} "
          f"tokens each; TTFT (best of the two sessions) " + ", ".join(
              f"turn {i + 1} {t * 1e3:.3f} ms" for i, t in enumerate(ttft))
          + f"; turn walls {[round(w, 3) for w in walls]} and "
          f"{[round(w, 3) for w in walls2]} s; turn 2 decode {tok_s:.3f} tok/s; peak "
          f"memory {peak_gb:.3f} GB [{card}]")

    # --- 3. what the session saves: the Generator re-prefilling turn 2's
    # whole history ---
    hist = chat_history(cfg, turns[:2], results[:1])
    g = Generator(params, cfg, vq_params=vq_params, vq_cfg=vq_cfg)
    g1 = GenerationConfig(max_new_tokens=1, eos_token_id=-1, **qkw)

    def reprefill():
        t = time.perf_counter()
        g(hist, g1)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    reprefill()
    out["reprefill_ms"] = min(reprefill() for _ in range(2)) * 1e3
    print(f"{mode} chat: the Generator re-prefilling turn 2's history "
          f"({hist['input_ids'].shape[-1]} tokens) TTFT {out['reprefill_ms']:.3f} ms "
          f"(best of 2) against the session's turn-2 TTFT {out['ttft_ms'][1]:.3f} ms "
          f"[{card}]")

    # --- 4. two layers at full width ---
    small_cfg = cfg.replace(num_hidden_layers=2)
    tol = E2E_TOL_QUANT if quant else E2E_TOL

    def vs_reprefill(small, g_cfg, got_l, tok, first):
        """got_l against _prefill over turn 1 and its answers and turn 2's
        delta, in the session's slot layout, at S_CHAT slots."""
        hist = chat_history(cfg, turns[:2], [first], bucket=CHAT_BUCKET)
        n = hist["input_ids"].shape[-1]
        fkw = dict(vq_params=vq_params, vq_cfg=vq_cfg, pixels=hist.pop("pixels"),
                   img_start=hist.pop("img_start"))
        args = tuple(hist[k] for k in ("input_ids", "attention_mask", "vision_indices"))
        re_l, _ = text_logits(small_cfg, small, args + (None,), dataclasses.replace(
            g_cfg, max_new_tokens=S_CHAT - n), tok, fused=fkw)
        re_l["delta pass"] = re_l.pop("prompt pass")
        return {k: rel_l2(got_l[k], re_l[k]) for k in got_l}, n

    with torch.inference_mode():
        small = decoder_params(small_cfg, dev, mode)
        got_l, tok, first = chat_turn2_logits(small_cfg, small, gen, turns, vq_params,
                                              vq_cfg)
        want_l, _, _ = chat_turn2_logits(small_cfg, small, gen, turns, vq_params,
                                         vq_cfg, tok, plain=True)
        vs_re, n = vs_reprefill(small, gen, got_l, tok, first)
        bounded = vs_re
        if quant:
            off = dataclasses.replace(gen, a8_prefill=False)
            same = weight_only(small)
            off_l, off_tok, off_first = chat_turn2_logits(small_cfg, same, off, turns,
                                                          vq_params, vq_cfg)
            bounded, _ = vs_reprefill(same, off, off_l, off_tok, off_first)
            del same
        del small
    vs_plain = {k: rel_l2(got_l[k], want_l[k]) for k in got_l}

    def line(d):
        return ", ".join(f"{k} {v:.6g}" for k, v in d.items())
    print(f"{mode} chat 2-layer logits of turn 2 (delta pass, first decode step), "
          f"relative L2: against the plain versions {line(vs_plain)}; against _prefill "
          f"over the history ({n} slots, cache {S_CHAT}) {line(vs_re)}"
          + (f" (a8_prefill on, not bounded), and with a8_prefill off on both sides "
             + ("and the int4 leaves weight-only " if mode == "int4" else "")
             + f"{line(bounded)}" if quant else "") + f" (tol {tol}) [{card}]")
    if not max(vs_plain.values()) < tol:
        raise AssertionError(f"{mode} chat 2-layer logits differ from the plain path: "
                             f"{vs_plain}")
    if not max(bounded.values()) < tol:
        raise AssertionError(f"{mode} chat 2-layer logits differ from the re-prefill: "
                             f"{bounded}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{mode} chat phase: {out['phase_s']:.1f} s [{card}]")
    return out


def spec_chat(card: str, cfg, params, gen, turns, vq_params, vq_cfg, std, margins,
              main: Counter) -> dict:
    """A spec ChatSession (gen.spec_decode = SPEC_GAMMA; the int8 tree) over
    chat_turns' first two turns against the standard session's `std`
    (TurnResults; its steps' top-2 gaps in `margins`, CHAT_NEW a turn):
    turn 1's tokens under the tie rule; turn 2's against a standard
    session whose turn-1 tokens are forced to the spec session's answers
    (the same history; its turn-2 margins recorded), under the tie rule,
    with equal slots used; every answer CHAT_NEW tokens; launches derived
    from each turn's delta pass (chat_counts), its verify iterations (a
    decode step's each) and its flush step (the 7 projections of every
    layer and B3, no lm_head). Adds the launches to `main`."""
    from libra_tpu_torch import chat as CH
    t_phase = time.perf_counter()
    L, mm = cfg.num_hidden_layers, MATMUL_KERNEL["int8"]
    sess = CH.ChatSession(params, cfg, batch=B, max_len=S_CHAT,
                          gen=dataclasses.replace(gen, spec_decode=SPEC_GAMMA),
                          delta_bucket=CHAT_BUCKET, vq_params=vq_params, vq_cfg=vq_cfg)
    iters, results, walls = [], [], []
    loop = CH.spec_decode_loop

    def counted_loop(*a, **k):
        res = loop(*a, **k)
        iters.append(int(res.iterations))
        return res

    zero_counts()
    with mock.patch.object(CH, "spec_decode_loop", counted_loop):
        for turn in turns[:2]:
            t = time.perf_counter()
            results.append(sess.ask(turn, max_new_tokens=CHAT_NEW))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    got = read_counts()
    main.update(got)
    want = chat_counts(cfg, "int8", True, [(delta_width(t), 0, "pixels" in t)
                                           for t in turns[:2]])
    for n in iters:
        want.update(expected_counts(cfg, "int8", True, 0, n))
        want[mm] += 7 * L
        want["int8_decode_attention"] += L
    assert_counts(f"int8 spec chat session (2 turns, {iters} verify iterations)", got,
                  want, card)
    if not all(bool((r.num_generated == CHAT_NEW).all()) for r in results):
        raise AssertionError("int8 spec chat: an answer is short")
    same = [tie_rule("int8 spec chat turn 1", results[0].tokens[0].cpu(),
                     std[0].tokens[0].cpu(), margins[:CHAT_NEW], E2E_TOL_QUANT, card)]
    # turn 2 from the same history: a standard session whose turn-1 tokens
    # are forced to the spec session's answers (its decode steps emit them
    # in place of their own argmax), then its own turn 2, margins recorded
    forced = iter(results[0].tokens.unbind(-1))
    ref = CH.ChatSession(params, cfg, batch=B, max_len=S_CHAT, gen=gen,
                         delta_bucket=CHAT_BUCKET, vq_params=vq_params, vq_cfg=vq_cfg)
    with mock.patch.object(CH, "sample_tokens", lambda *a, **k: next(forced)):
        ref.ask(turns[0], max_new_tokens=CHAT_NEW)
    margins2 = []
    with logit_margins(CH, margins2, cfg.vocab_size):
        ref2 = ref.ask(turns[1], max_new_tokens=CHAT_NEW)
    if ref.used != sess.used:
        raise AssertionError(f"int8 spec chat: {sess.used} slots used, the standard "
                             f"session {ref.used}")
    same.append(tie_rule("int8 spec chat turn 2 (against the standard session with "
                         "turn 1's answers forced to the spec session's)",
                         results[1].tokens[0].cpu(), ref2.tokens[0].cpu(),
                         torch.stack(margins2).cpu(), E2E_TOL_QUANT, card))
    out = dict(tok_per_iter=[CHAT_NEW / n for n in iters], walls_s=walls,
               phase_s=time.perf_counter() - t_phase)
    print(f"int8 spec chat session (gamma {SPEC_GAMMA}): turns of {CHAT_NEW} tokens in "
          f"{iters} verify iterations ({', '.join(f'{x:.3f}' for x in out['tok_per_iter'])}"
          f" tokens a row an iteration), walls {[round(w, 3) for w in walls]} s; rows "
          f"equal to the standard session's throughout, turn 1 and turn 2: {same}; "
          f"{out['phase_s']:.1f} s [{card}]")
    return out


def chat_thread(card: str, pipe, images, main: Counter) -> None:
    """LibraPipeline.start_chat: a ChatThread of B conversations, three
    turns of THREAD_NEW tokens (turn 1 the pipeline's image prompt, then
    FOLLOW_UPS); non-empty answers, launches derived from the turns."""
    from libra_tpu_torch import chat as CH
    thread = pipe.start_chat(n_parallel=B, max_len=S_CHAT, max_new_tokens=THREAD_NEW,
                             delta_bucket=CHAT_BUCKET)
    widths, shapes = [], []
    t0 = time.perf_counter()
    zero_counts()
    with mock.patch.object(CH.M, "forward", forwards_of(CH.M.forward, widths)):
        answers = []
        for qs, ims in [(QUESTIONS, images)] + [(f, None) for f in FOLLOW_UPS]:
            used = thread.session.used
            widths.clear()
            answers.append(thread.ask(qs, images=ims))
            shapes.append((widths[0], thread.session.used - used - widths[0], False))
    torch.cuda.synchronize()
    got = read_counts()
    main.update(got)
    assert_counts(f"chat thread ({len(shapes)} turns, rows and steps "
                  f"{[s[:2] for s in shapes]})", got,
                  chat_counts(pipe.cfg, "bf16", False, shapes), card)
    print(f"chat thread: {thread.turn} turns of {B} conversations in "
          f"{time.perf_counter() - t0:.3f} s, answers {answers} [{card}]")
    if thread.turn != 3 or not all(len(a) == B and all(isinstance(x, str) and x
                                                        for x in a) for a in answers):
        raise AssertionError("the chat thread did not answer every question")


def forwards_of(fn, widths: list):
    """models/libra.forward that also appends each call's width to `widths`."""
    def wrapped(params, cfg, input_ids, *args, **kwargs):
        widths.append(input_ids.shape[-1])
        return fn(params, cfg, input_ids, *args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Text-to-image
# ---------------------------------------------------------------------------

def np_finite(a) -> bool:
    return bool(torch.isfinite(torch.from_numpy(a)).all())


def t2i_pipeline(cfg, params, vq_cfg, vq_params, text_tok=None):
    """A LibraPipeline over `params` whose image tokenizer decodes with
    vq_params (post_quant_conv and the conv decoder, fp32)."""
    from libra_tpu_torch.pipeline import LibraPipeline
    from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                              SimpleTextTokenizer)
    from libra_tpu_torch.training.fused import maybe_normalize_pixels
    img_tok = ImageTokenizer(vq_cfg, vq_params, cfg.vocab_size,
                             cfg.max_vision_token_length)
    return LibraPipeline(cfg, params, LibraTokenizer(
        text_tok or SimpleTextTokenizer(vocab_size=cfg.vocab_size), img_tok),
        functools.partial(maybe_normalize_pixels, vq_cfg))


def image_call(pipe, **kw):
    """pipe.generate_image(T2I_CAPTION, **kw) with its Generator's result
    kept: (pixels, GenerateResult, the prompt's length)."""
    results, generate = [], pipe.generator
    pipe.generator = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    try:
        pixels = pipe.generate_image(T2I_CAPTION, **kw)
    finally:
        pipe.generator = generate
    res = results[0]
    return pixels, res, res.sequences.shape[-1] - pipe.cfg.max_vision_token_length


def forced_margins(module, sink: list, vocab: int, tokens):
    """Patch module.sample_tokens so that step t emits tokens[:, :, t]
    ((Q, B, n): another run's tokens) in place of its own choice, and
    appends per codebook of row 0 its own argmax, its top logit minus the
    emitted token's, and the vision slice's range: (Q, 3) fp32."""
    def forced(logits, gen, generator=None):
        tok = tokens[:, :, len(sink)]
        lg = logits[:, 0].float()
        top = lg.argmax(dim=-1)
        gap = lg.gather(-1, top[:, None])[:, 0] - lg.gather(-1, tok[:, :1])[:, 0]
        v = lg[:, vocab:]
        sink.append(torch.stack([top.float(), gap, v.amax(dim=-1) - v.amin(dim=-1)], -1))
        return tok
    return mock.patch.object(module, "sample_tokens", forced)


def forced_rule(label: str, got, record, tol: float, card: str) -> tuple:
    """A run's tokens `got` (Q, n) against the plain versions' choices at
    every step of the same sequence (`record` (n, Q, 3) from
    forced_margins): where the plain step's argmax is another token, the
    emitted token's logit must be within tol of the step's vision-logit
    range of the top one (a near tie, which the other summation order may
    flip). Returns (the steps before the first difference, the steps
    where a codebook differs)."""
    top, gap, rng = record[:, :, 0].long().T, record[:, :, 1].T, record[:, :, 2].T
    diff = top != got.cpu()
    steps = diff.any(dim=0).nonzero()[:, 0]
    first = int(steps[0]) if len(steps) else got.shape[1]
    share = (gap[diff] / rng[diff]).max().item() if len(steps) else 0.0
    print(f"{label}: the plain versions' argmax on the same sequence differs at "
          f"{len(steps)} of {got.shape[1]} steps, the first at new token {first}; "
          f"the emitted token's logit below the top one by at most {share:.4%} of "
          f"the step's range (tol {tol:.0%}) [{card}]")
    if not share < tol:
        raise AssertionError(f"{label}: a token differs from the plain versions' "
                             f"choice where the plain step has no near tie")
    return first, len(steps)


def block_structure(label: str, cfg, img_tok, res, n: int, card: str) -> None:
    """The generated image block of a generate_image result: the prompt's
    last token BOI, every generated block token a vision id (the text
    slice is -inf at vision positions) on every codebook, and the token
    after the block the forced newline. generate_image, as libra_tpu's,
    constrains nothing inside the block, so on random weights a block
    token may be BOI or EOI (2 of the 514 vision ids), and the last one
    need not be EOI; the decode drops the block's first and last token
    whatever they hold and maps BOI / EOI inside it to codes as
    libra_tpu does. Prints the counts of codes and of EOI at the end."""
    V, Mv = cfg.vocab_size, cfg.max_vision_token_length
    seq = res.sequences[:, 0]
    block = seq[:, n - 1:n + Mv - 1]
    ok = (bool((block[:, 0] == img_tok.boi_token_id).all())
          and bool(((block[:, 1:] >= V) & (block[:, 1:] < V + cfg.vision_vocab_size)).all())
          and bool((seq[:, n + Mv - 1] == cfg.newline_token_id).all()))
    inner = block[:, 1:Mv - 1] - V
    print(f"{label}: block of {Mv} tokens: BOI first, {Mv - 1} vision ids on each of "
          f"{seq.shape[0]} codebooks, then the forced newline: {ok}; "
          f"{int((inner < img_tok.cfg.codebook_size).sum())} of {inner.numel()} inner "
          f"tokens codes, EOI last on {int((block[:, -1] == img_tok.eoi_token_id).sum())} "
          f"of {seq.shape[0]} codebooks [{card}]")
    if not ok:
        raise AssertionError(f"{label}: the image block is malformed: {block.tolist()}")


def t2i_args(pipe, dev) -> tuple:
    """_prefill's positional inputs of the t2i prompt, on `dev`."""
    from libra_tpu_torch.pipeline import t2i_prompt
    inputs = pipe._tokenize([t2i_prompt(T2I_CAPTION)], None)
    return tuple(None if inputs[k] is None else inputs[k].to(dev) for k in (
        "input_ids", "attention_mask", "vision_indices", "coninous_signal"))


def dual_logits(cfg, params, args, gen, tok=None):
    """Vision-slice logits (Q, B, Vv) of the t2i prompt pass (its last
    position is BOI) and of the next dual decode step (on `tok`, or on
    the argmax); and that token."""
    from libra_tpu_torch.generation import _prefill, decode_micro_step
    V = cfg.vocab_size
    st = _prefill(params, *args, cfg=cfg, gen=gen)
    out = {"prompt pass": st.logits[:, :, V:].float()}
    tok = torch.argmax(st.logits, dim=-1) if tok is None else tok
    st.mask_buf[:, args[0].shape[-1]] = 1
    step, *_ = decode_micro_step(params, cfg, tok, st.mask_buf, st.cache,
                                 st.vi_last, st.last_pos, lang_only=False)
    out["dual step"] = step[:, :, V:].float()
    return out, tok


def t2i_path(card: str, dev, cfg, vq_cfg, vq_params, params, mode: str,
             main: Counter) -> dict:
    """Text-to-image for one tree: on T2I_LAYERS layers at full width,
    LibraPipeline.generate_image greedy (launches derived from the config
    and the tree's leaves), its tokens held at every step to the choice of
    the same call with every plain version patched in, run along the same
    tokens (forced_rule: equal, or a near tie), the block's structure, the
    prompt pass's and
    the first dual step's vision logits against the plain versions; in
    bf16 then one image on the tree's first T2I_IMAGE_LAYERS layers
    (t2i_image). Adds the counted runs' launches to `main`; returns the
    figures."""
    import libra_tpu_torch.generation as G
    from libra_tpu_torch.generation import GenerationConfig
    t_phase = time.perf_counter()
    Mv, V = cfg.max_vision_token_length, cfg.vocab_size
    tol = E2E_TOL_QUANT if mode != "bf16" else E2E_TOL
    small_cfg = cfg.replace(num_hidden_layers=T2I_LAYERS)
    with torch.no_grad():
        small = decoder_params(small_cfg, dev, mode)
    pipe = t2i_pipeline(small_cfg, small, vq_cfg, vq_params)
    zero_counts()
    t0 = time.perf_counter()
    pixels, res, n = image_call(pipe, temperature=0.0)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    got = read_counts()
    main.update(got)
    label = f"{mode} t2i {T2I_LAYERS} layers"
    assert_counts(f"{label} greedy (1 prompt pass of {n} tokens, {Mv - 1} dual steps)",
                  got, t2i_counts(small_cfg, small, n, Mv - 1), card)
    if pixels is None or pixels.shape != (vq_cfg.resolution,) * 2 + (3,) or not (
            np_finite(pixels)):
        raise AssertionError(f"{label}: pixels {None if pixels is None else pixels.shape}")
    block_structure(label, small_cfg, pipe.tokenizer.image_tokenizer, res, n, card)
    new_tokens = res.sequences[:, :, n:]
    record = []
    with plain_kernels(), forced_margins(G, record, V, new_tokens):
        image_call(pipe, temperature=0.0)
    same, ties = forced_rule(f"{label} tokens vs the plain versions", new_tokens[:, 0],
                             torch.stack(record).cpu(), tol, card)
    args = t2i_args(pipe, dev)
    gen = GenerationConfig(max_new_tokens=2, eos_token_id=-1)
    with torch.inference_mode():
        got_l, tok = dual_logits(small_cfg, small, args, gen)
        with plain_kernels():
            want_l, _ = dual_logits(small_cfg, small, args, gen, tok)
    rel = {k: ((got_l[k] - want_l[k]).norm() / want_l[k].norm()).item() for k in got_l}
    print(f"{label}: greedy call {call_s:.2f} s; vision logits vs the plain "
          "versions, relative L2: " + ", ".join(f"{k} {v:.6g}" for k, v in rel.items())
          + f" (tol {tol}) [{card}]")
    if not max(rel.values()) < tol:
        raise AssertionError(f"{label}: logits differ from the plain path: {rel}")
    del pipe, small
    out = dict(same=same, ties=ties, rel=rel, call_s=call_s)
    if mode == "bf16":
        out.update(t2i_image(card, dev, cfg.replace(num_hidden_layers=T2I_IMAGE_LAYERS),
                             vq_cfg, vq_params, first_layers(params, T2I_IMAGE_LAYERS),
                             main))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def first_layers(params, n: int) -> dict:
    """A decoder tree of the first n layers of `params`: views of its
    stacked layer leaves, the rest shared."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n] for k, v in tree.items()}
    return dict(params, layers=cut(params["layers"]))


def t2i_image(card: str, dev, cfg, vq_cfg, vq_params, params, main: Counter) -> dict:
    """One image at cfg's depth: generate_image with its defaults (top-k 100
    at temperature 1) from a seeded torch.Generator. TTFT (the first
    sample on the host, synchronized), image tokens/s = (Mv - 1) / (the
    call's wall - TTFT), the call's wall and peak memory; launches from
    the config; the pixels finite, (S, S, 3) and those of decode_code on
    the same ids; decode_code against itself with TF32 off (relative L2
    under T2I_TF32_TOL) and its time (CUDA events, best of 3);
    torch.profiler over T2I_PROFILED dual steps."""
    import libra_tpu_torch.generation as G
    from libra_tpu_torch.generation import GenerationConfig, _prefill, decode_micro_step
    from libra_tpu_torch.models import vqgan
    Mv = cfg.max_vision_token_length
    pipe = t2i_pipeline(cfg, params, vq_cfg, vq_params)
    sample, stamps = G.sample_tokens, []

    def first_sample(logits, gen, generator=None):
        if not stamps:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return sample(logits, gen, generator)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(G, "sample_tokens", first_sample):
        pixels, res, n = image_call(pipe, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = read_counts()
    main.update(got)
    ttft = stamps[0] - t0
    tok_s = (Mv - 1) / (wall - ttft)
    assert_counts(f"bf16 t2i image ({cfg.num_hidden_layers} layers)", got,
                  t2i_counts(cfg, params, n, Mv - 1), card)
    img_tok = pipe.tokenizer.image_tokenizer
    block_structure("bf16 t2i image", cfg, img_tok, res, n, card)
    block = res.sequences[:, 0, n - 1:n + Mv - 1]
    decoded = img_tok.decode(block[None])[0]
    if pixels.shape != (vq_cfg.resolution,) * 2 + (3,) or not np_finite(pixels) or not (
            torch.equal(torch.from_numpy(pixels), decoded.cpu())):
        raise AssertionError(f"bf16 t2i image: pixels {pixels.shape}, finite "
                             f"{np_finite(pixels)}, equal to decode_code's "
                             f"{torch.equal(torch.from_numpy(pixels), decoded.cpu())}")
    g = int(round((Mv - 2) ** 0.5))
    idx = (block[:, 1:-1].reshape(-1, g, g).permute(1, 2, 0)[None] - img_tok.offset)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            exact = vqgan.decode_code(img_tok.params, vq_cfg, idx)[0]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    tf32_rel = rel_l2(decoded, exact)
    decode_ms = []
    with torch.inference_mode():
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            vqgan.decode_code(img_tok.params, vq_cfg, idx)
            end.record()
            end.synchronize()
            decode_ms.append(start.elapsed_time(end))
    print(f"bf16 t2i image: decode_code ({pixels.shape}, fp32) {min(decode_ms):.3f} ms "
          f"(best of 3: {', '.join(f'{t:.3f}' for t in decode_ms)}); against TF32 off, "
          f"relative L2 {tf32_rel:.6g} (tol {T2I_TF32_TOL}) [{card}]")
    if not tf32_rel < T2I_TF32_TOL:
        raise AssertionError(f"bf16 t2i image: decode_code moves by {tf32_rel} with TF32")
    args = t2i_args(pipe, dev)
    prof = {}
    with torch.inference_mode():
        st = _prefill(params, *args, cfg=cfg,
                      gen=GenerationConfig(max_new_tokens=Mv, eos_token_id=-1))

        def steps():
            tok, cache, vi, pos = torch.argmax(st.logits, dim=-1), st.cache, st.vi_last, st.last_pos
            for i in range(T2I_PROFILED):
                st.mask_buf[:, n + i] = 1
                logits, cache, vi, pos = decode_micro_step(params, cfg, tok, st.mask_buf, cache,
                                                           vi, pos, lang_only=False)
                tok = torch.argmax(logits, dim=-1)

        profiled(card, f"bf16 t2i {T2I_PROFILED} dual steps", steps, out=prof)
    del pipe, st
    return dict(ttft_ms=ttft * 1e3, tok_s=tok_s, wall_s=wall, peak_gb=peak_gb,
                decode_ms=min(decode_ms), tf32_rel=tf32_rel,
                steps_device_ms=prof["device_ms"], steps_wall_ms=prof["wall_ms"])


# ---------------------------------------------------------------------------
# The 2D modes
# ---------------------------------------------------------------------------

def twod(cfg, **kw):
    """cfg with both 2D modes on: 2D vision prediction (the heads over a
    hidden and its up / left neighbours, the decode's hidden ring) and 2D
    RoPE."""
    return cfg.replace(vision_prediction_mode="2d", use_2d_rope=True, **kw)


def twod_path(card: str, dev, cfg, vq_cfg, vq_params, params, mode: str, pixels,
              main: Counter) -> dict:
    """The 2D modes on this tree. In bf16: the 2D image (twod_image) and the
    fused-pixels VQA with 2D RoPE at full depth on `params` (2D RoPE adds
    no parameter): TTFT and decode tok/s, launches, two runs equal. Then on
    two layers at full width (twod_small). Adds the counted runs' launches
    to `main`; returns the figures."""
    from libra_tpu_torch.generation import GenerationConfig, Generator
    t_phase = time.perf_counter()
    before = Counter(main)
    out = {}
    if mode == "bf16":
        out["image"] = twod_image(card, dev, cfg, vq_cfg, vq_params, main)
        rope = cfg.replace(use_2d_rope=True)
        inputs = fused_inputs(rope, dev, pixels)
        N, Mv = inputs["input_ids"].shape[-1], cfg.max_vision_token_length
        g = Generator(params, rope, vq_params=vq_params, vq_cfg=vq_cfg)
        g1 = GenerationConfig(max_new_tokens=1, eos_token_id=-1)
        g64 = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1)

        def run(gen_cfg):
            t = time.perf_counter()
            res = g(inputs, gen_cfg)
            torch.cuda.synchronize()
            return time.perf_counter() - t, res
        run(g1)
        run(g64)                                 # warm-up
        zero_counts()
        ttft = min(run(g1)[0] for _ in range(2))
        (t64a, r1), (t64b, r2) = run(g64), run(g64)
        got = read_counts()
        main.update(got)
        assert_counts(f"bf16 2D-RoPE fused VQA ({cfg.num_hidden_layers} layers, 2 x 1 + "
                      f"2 x {MAX_NEW} new tokens)", got,
                      expected_counts(cfg, mode, False, 4, 2 * (MAX_NEW - 1),
                                      split_prefills=4, text_rows=B * (N - Mv)), card)
        if not torch.equal(r1.sequences, r2.sequences):
            raise AssertionError("two 2D-RoPE greedy runs gave different tokens")
        if bool((r1.sequences[:, :, N:] >= cfg.vocab_size).any()):
            raise AssertionError("2D RoPE: text positions emitted vision ids")
        tok_s = (MAX_NEW - 1) * B / (min(t64a, t64b) - ttft)
        out["vqa"] = dict(ttft_ms=ttft * 1e3, tok_s=tok_s)
        print(f"bf16 2D-RoPE fused VQA B={B} N={N} img_start={IMG_T}, "
              f"{cfg.num_hidden_layers} layers: TTFT {ttft * 1e3:.3f} ms, decode "
              f"{tok_s:.3f} tok/s (best of 2 each) [{card}]")
    out["small"] = twod_small(card, dev, cfg, vq_cfg, vq_params, mode, pixels, main)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = dict(Counter(main) - before)
    print(f"{mode} 2D phase: {out['phase_s']:.1f} s, its counted launches "
          f"{out['launches']} [{card}]")
    return out


def twod_image(card: str, dev, cfg, vq_cfg, vq_params, main: Counter) -> dict:
    """One image with both 2D modes on at TWOD_IMAGE_LAYERS layers, full
    width (a seeded tree with its 2 * D-input vision heads and placeholder):
    generate_image greedy, one 578-token block through the hidden ring,
    then LFQ's code lookup and the VQGAN decoder. TTFT (the first sample on
    the host), image tokens/s = (Mv - 1) / (wall - TTFT), launches from the
    config, the block's framing, the pixels finite; its tokens held at every
    step to the plain versions' choice along the same sequence
    (forced_rule); torch.profiler over T2I_PROFILED dual steps with the
    ring."""
    import libra_tpu_torch.generation as G
    from libra_tpu_torch.generation import GenerationConfig, _prefill, decode_micro_step
    cfg8 = twod(cfg, num_hidden_layers=TWOD_IMAGE_LAYERS)
    Mv, V = cfg.max_vision_token_length, cfg.vocab_size
    params = decoder_params(cfg8, dev)
    pipe = t2i_pipeline(cfg8, params, vq_cfg, vq_params)
    sample, stamps = G.sample_tokens, []

    def first_sample(logits, gen, generator=None):
        if not stamps:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return sample(logits, gen, generator)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(G, "sample_tokens", first_sample):
        pixels, res, n = image_call(pipe, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    main.update(got)
    ttft = stamps[0] - t0
    tok_s = (Mv - 1) / (wall - ttft)
    label = f"bf16 2D image ({TWOD_IMAGE_LAYERS} layers, 2D prediction + 2D RoPE)"
    assert_counts(label, got, t2i_counts(cfg8, params, n, Mv - 1), card)
    block_structure(label, cfg8, pipe.tokenizer.image_tokenizer, res, n, card)
    if pixels is None or pixels.shape != (vq_cfg.resolution,) * 2 + (3,) or not (
            np_finite(pixels)):
        raise AssertionError(f"{label}: pixels {None if pixels is None else pixels.shape}")
    new_tokens = res.sequences[:, :, n:]
    record = []
    with plain_kernels(), forced_margins(G, record, V, new_tokens):
        image_call(pipe, temperature=0.0)
    same, ties = forced_rule(f"{label} tokens vs the plain versions", new_tokens[:, 0],
                             torch.stack(record).cpu(), E2E_TOL, card)
    prof = {}
    with torch.inference_mode():
        st = _prefill(params, *t2i_args(pipe, dev), cfg=cfg8,
                      gen=GenerationConfig(max_new_tokens=Mv, eos_token_id=-1))

        def steps():
            tok, cache, vi, pos = torch.argmax(st.logits, dim=-1), st.cache, st.vi_last, st.last_pos
            for i in range(T2I_PROFILED):
                st.mask_buf[:, n + i] = 1
                logits, cache, vi, pos = decode_micro_step(params, cfg8, tok, st.mask_buf,
                                                           cache, vi, pos, lang_only=False,
                                                           ring=st.ring)
                tok = torch.argmax(logits, dim=-1)

        profiled(card, f"{label} {T2I_PROFILED} dual steps", steps, out=prof)
    print(f"{label}: greedy, TTFT {ttft * 1e3:.3f} ms, image tokens/s {tok_s:.3f} "
          f"({Mv - 1} / (wall - TTFT)), call wall {wall:.3f} s; a dual step "
          f"{prof['device_ms'] / T2I_PROFILED:.3f} ms device / "
          f"{prof['wall_ms'] / T2I_PROFILED:.3f} ms wall [{card}]")
    del pipe, st, params
    return dict(ttft_ms=ttft * 1e3, tok_s=tok_s, wall_s=wall, same=same, ties=ties,
                step_device_ms=prof["device_ms"] / T2I_PROFILED,
                step_wall_ms=prof["wall_ms"] / T2I_PROFILED)


def twod_requests(cfg, n: int):
    """B t2i requests of n tokens: n - 1 random text ids (a torch.Generator
    seeded per request), then BOI at vision index 0; no signal."""
    import numpy as np
    from libra_tpu_torch.serving import Request
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    vi = np.full((n,), Mv, np.int64)
    vi[-1] = 0
    reqs = []
    for i in range(B):
        g = torch.Generator().manual_seed(SEED + 30 + i)
        ids = torch.randint(3, cfg.vocab_size, (1, n), generator=g).expand(Q, n).clone()
        ids[:, -1] = cfg.vocab_size + cfg.vision_vocab_size - 2          # BOI
        reqs.append(Request(i, ids.numpy(), vi, max_new_tokens=TWOD_STEPS))
    return reqs


def twod_small(card: str, dev, cfg, vq_cfg, vq_params, mode: str, pixels,
               main: Counter) -> dict:
    """The 2D modes on two layers at full width (the quantized trees with
    kv_quant and a8_prefill, as the main path runs them), each with
    launches derived from the config:
      1. the fused-pixels Generator with 2D RoPE, TWOD_STEPS text tokens,
         against the same call with every plain version patched in
         (tie_rule on the plain run's top-2 gaps);
      2. a 2D-RoPE ChatSession's turn 2 (chat_turns' first two turns,
         CHAT_NEW tokens each) against the Generator re-prefilling the
         history (chat_history, real tokens only): tie_rule on the
         re-prefill's gaps. Both sides compute one function: a8_prefill off
         and, in int4, the leaves weight-only (as chat_path's bounded
         check);
      3. with both 2D modes on (the 2 * D-input heads' tree), the t2i
         prompt's first TWOD_STEPS image tokens through the Generator's
         dual decode and its ring, held at every step to the plain
         versions' choice along the same tokens (forced_rule);
      4. the ServingEngine on B t2i requests (twod_requests) at once,
         decoded in lockstep through the per-slot ring: tokens equal to the
         Generator's on the same B prompts.
    Returns the figures."""
    import libra_tpu_torch.generation as G
    from libra_tpu_torch import chat as CH
    from libra_tpu_torch.generation import GenerationConfig, Generator
    from libra_tpu_torch.serving import ServingEngine
    quant = mode != "bf16"
    tol = E2E_TOL_QUANT if quant else E2E_TOL
    qkw = dict(kv_quant=True, a8_prefill=True) if quant else {}
    V, Mv = cfg.vocab_size, cfg.max_vision_token_length
    out = {}

    # --- 1. 2D-RoPE fused VQA ---
    rope = cfg.replace(use_2d_rope=True, num_hidden_layers=2)
    small = decoder_params(rope, dev, mode)
    inputs = fused_inputs(rope, dev, pixels)
    N = inputs["input_ids"].shape[-1]
    g = Generator(small, rope, vq_params=vq_params, vq_cfg=vq_cfg)
    gen = GenerationConfig(max_new_tokens=TWOD_STEPS, eos_token_id=-1,
                           decode_modality="text", **qkw)
    zero_counts()
    res = g(inputs, gen)
    got = read_counts()
    main.update(got)
    label = f"{mode} 2D-RoPE fused VQA, 2 layers"
    assert_counts(label, got, expected_counts(rope, mode, quant, 1, TWOD_STEPS - 1,
                                              split_prefills=1, text_rows=B * (N - Mv)),
                  card)
    margins = []
    with plain_kernels(), logit_margins(G, margins, V):
        want = g(inputs, gen)
    rows = tie_rule(f"{label} tokens vs the plain versions", res.sequences[0, :, N:],
                    want.sequences[0, :, N:], torch.stack(margins).cpu(), tol, card)
    out["vqa_rows_equal"] = len(rows)
    print(f"{label}: {len(rows)} of {B} rows equal to the plain versions' over "
          f"{TWOD_STEPS} tokens [{card}]")

    # --- 2. a 2D-RoPE chat session against the re-prefilling Generator ---
    bounded = dict(qkw, a8_prefill=False)
    tree = weight_only(small) if mode == "int4" else small
    turns = chat_turns(rope, dev, pixels)[:2]
    sess = CH.ChatSession(tree, rope, batch=B, max_len=S_CHAT, delta_bucket=CHAT_BUCKET,
                          gen=GenerationConfig(eos_token_id=-1, **bounded),
                          vq_params=vq_params, vq_cfg=vq_cfg)
    zero_counts()
    answers, shapes = [], []
    for turn in turns:
        used = sess.used
        answers.append(sess.ask(turn, max_new_tokens=CHAT_NEW))
        n = delta_width(turn)
        shapes.append((n, sess.used - used - n, "pixels" in turn))
    got = read_counts()
    main.update(got)
    label = f"{mode} 2D-RoPE chat session, 2 layers"
    assert_counts(f"{label} (rows and steps {[s_[:2] for s_ in shapes]})", got,
                  chat_counts(rope, mode, quant, shapes), card)
    hist = chat_history(rope, turns, answers[:1])
    margins = []
    with logit_margins(G, margins, V):
        re = Generator(tree, rope, vq_params=vq_params, vq_cfg=vq_cfg)(
            hist, GenerationConfig(max_new_tokens=CHAT_NEW, eos_token_id=-1, **bounded))
    n_hist = hist["input_ids"].shape[-1]
    rows = tie_rule(f"{label} turn 2 vs the Generator re-prefilling the history "
                    f"({n_hist} tokens)", answers[1].tokens[0], re.sequences[0, :, n_hist:],
                    torch.stack(margins).cpu(), tol, card)
    out["chat_rows_equal"] = len(rows)
    print(f"{label}: turn 2's {CHAT_NEW} tokens equal to the re-prefill's in {len(rows)} "
          f"of {B} rows {bounded} [{card}]")
    del sess, small, tree, g

    # --- 3. both 2D modes: the t2i prompt's first image tokens ---
    both = twod(cfg, num_hidden_layers=2)
    small = decoder_params(both, dev, mode)
    pipe = t2i_pipeline(both, small, vq_cfg, vq_params)
    args = t2i_args(pipe, dev)
    n = args[0].shape[-1]
    t2i = {"input_ids": args[0], "attention_mask": args[1], "vision_indices": args[2],
           "coninous_signal": args[3]}
    g = Generator(small, both)
    gen = GenerationConfig(max_new_tokens=TWOD_STEPS, eos_token_id=-1)
    zero_counts()
    res = g(t2i, gen)
    got = read_counts()
    main.update(got)
    label = f"{mode} 2D image, 2 layers, first {TWOD_STEPS} tokens"
    assert_counts(label, got, t2i_counts(both, small, n, TWOD_STEPS - 1), card)
    if not bool((res.sequences[:, :, n:] >= V).all()):
        raise AssertionError(f"{label}: a text id inside the image block")
    record = []
    new_tokens = res.sequences[:, :, n:]
    with plain_kernels(), forced_margins(G, record, V, new_tokens):
        g(t2i, gen)
    out["image_same"], out["image_ties"] = forced_rule(
        f"{label} vs the plain versions", new_tokens[:, 0], torch.stack(record).cpu(),
        tol, card)

    # --- 4. the engine's lockstep t2i requests through the per-slot ring ---
    reqs = twod_requests(both, n)
    eng = ServingEngine(small, both, max_batch=B, max_len=n + TWOD_STEPS,
                        gen=GenerationConfig(eos_token_id=-1, **qkw))
    zero_counts()
    results = eng.run(reqs)
    got = read_counts()
    main.update(got)
    stats = eng.last_run_stats
    label = f"{mode} 2D engine, 2 layers, {B} t2i requests"
    assert_counts(f"{label} (prefill groups {stats['group_sizes']}, "
                  f"{stats['n_decode']} decode chunks)", got,
                  dual_counts(both, small, quant, B * n, B,
                              stats["n_decode"] * eng.decode_chunk), card)
    batch = {"input_ids": torch.stack([torch.from_numpy(r.input_ids) for r in reqs], 1)
             .to(dev),
             "attention_mask": torch.ones((B, n), dtype=torch.long, device=dev),
             "vision_indices": torch.from_numpy(reqs[0].vision_indices).to(dev)[None]
             .expand(B, n)}
    want = g(batch, GenerationConfig(max_new_tokens=TWOD_STEPS, eos_token_id=-1, **qkw))
    equal = all(torch.equal(torch.from_numpy(r.tokens), want.sequences[:, i, n:].cpu())
                for i, r in enumerate(results))
    print(f"{label}: lockstep tokens ({TWOD_STEPS} each, dual decode through the "
          f"per-slot ring) equal to the Generator's on the same {B} prompts {equal}; "
          f"merged prefill {'on' if eng._merged_on else 'off'} [{card}]")
    if not equal or eng._merged_on:
        raise AssertionError(f"{label}: engine tokens differ from the Generator's")
    del pipe, small, g, eng
    return out


# ---------------------------------------------------------------------------
# Serving engine
# ---------------------------------------------------------------------------

def engine_counts(cfg, mode: str, kv_quant: bool, eng, n_prompt: int,
                  pixels: bool = True) -> Counter:
    """Kernel launches of one ServingEngine.run, from its own schedule
    (last_run_stats): each prefill a prompt pass of a k-row group
    (group_sizes), with pixels a fused one with the split on, its text
    rows k * (n_prompt - 578); each decode step (n_decode chunks x
    decode_chunk, every slot stepping, idle ones too) a text-only decode
    step of max_batch rows; each spec verify iteration (n_spec chunks x
    decode_chunk) the same, and lm_head once more for the carried logits;
    each merged iteration (n_merged chunks x _Km) packed_counts'
    launches."""
    Mv = cfg.max_vision_token_length
    stats = eng.last_run_stats
    spec_iters = stats["n_spec"] * eng.decode_chunk
    want = expected_counts(cfg, mode, kv_quant, 0,
                           stats["n_decode"] * eng.decode_chunk + spec_iters)
    if MATMUL_KERNEL[mode]:
        want[MATMUL_KERNEL[mode]] += spec_iters
    for k in stats["group_sizes"]:
        want.update(expected_counts(cfg, mode, False, 1, 0, split_prefills=int(pixels),
                                    text_rows=k * (n_prompt - Mv)))
    if stats["n_merged"]:
        for name, n in packed_counts(cfg, eng.params, kv_quant).items():
            want[name] += n * stats["n_merged"] * eng._Km
    return want


def qdot_kernel(w, M: int) -> Optional[str]:
    """The kernel ops.qlinear.qdot launches for M rows of x against the
    weight w on the card, as its dispatch decides (None: no kernel)."""
    from libra_tpu_torch.ops import int4_matmul as I4, int8_matmul as I8
    from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray
    if isinstance(w, Quantized4Array):
        x = torch.empty((M, 2 * w.packed.shape[-2]), device="meta")
        return "int4_matmul" if I4.supports(x, w.packed, w.scale, w.group) else None
    if isinstance(w, QuantizedArray):
        x = torch.empty((M, w.q.shape[-2]), device="meta")
        return "int8_matmul" if I8.supports(x, w.q, w.scale) else None
    return None


def body_counts(cfg, params, rows: int) -> Counter:
    """Matmul-kernel launches of one dual-path forward of `rows` rows:
    every weight of the layer body at `rows` rows, in every layer (the
    language q, k, v, o, gate, up, down; the vision low-rank pairs' wa and
    wb; the bridges'), and the embedding's signal projection; decided per
    leaf by qdot_kernel (an int4 tree's int8 leaves take B2)."""
    from libra_tpu_torch.models import libra as M
    L = cfg.num_hidden_layers
    layer = M._layer(params["layers"], 0)
    a, m = layer["attn"], layer["mlp"]
    weights = [a[n] for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
    weights += [m[n] for n in ("gate_proj", "up_proj", "down_proj")]
    pairs = [a[n] for n in ("vision_q", "vision_k", "vision_v", "vision_o")]
    pairs += [m[n] for n in ("vision_gate", "vision_up", "vision_down")]
    if cfg.use_bridge:
        pairs += [a[n] for n in ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang",
                                 "v_bridge_vis")]
    weights += [p[x] for p in pairs for x in ("wa", "wb")]
    want = Counter()
    for w, n in [(w, L) for w in weights] + [(params["signal_proj"], 1)]:
        name = qdot_kernel(w, rows)
        if name:
            want[name] += n
    return want


def packed_counts(cfg, params, kv_quant: bool) -> Counter:
    """Kernel launches of one merged iteration (serving._merged): the
    dual-path body at M_PACKED rows (body_counts), lm_head at the B decode
    rows and at the chunk's last row; with the int8 cache, one
    decode-attention launch a layer (the decode segment; the chunk segment
    attends in plain PyTorch)."""
    want = body_counts(cfg, params, M_PACKED)
    for rows in (B, 1):
        name = qdot_kernel(params["lm_head"], rows)
        if name:
            want[name] += 1
    if kv_quant:
        want["int8_decode_attention"] += cfg.num_hidden_layers
    return want


def dual_counts(cfg, params, kv_quant: bool, prompt_rows: int, batch: int,
                steps: int) -> Counter:
    """Kernel launches of a dual-path generation of `batch` rows: the prompt
    pass, B1 once a layer and the dual-path body at prompt_rows rows; then
    `steps` dual decode steps, the body at `batch` rows and, with the int8
    cache, one decode-attention launch a layer; each with lm_head at its
    batch last rows (the vision heads, 1D or 2D, are einsums: no
    kernel)."""
    want = Counter({k["name"]: 0 for k in KERNELS})
    want["flash_bridged_attention"] = cfg.num_hidden_layers
    want.update(body_counts(cfg, params, prompt_rows))
    step = body_counts(cfg, params, batch)
    head = qdot_kernel(params["lm_head"], batch)
    if head:
        want[head] += 1
        step[head] += 1
    for name, n in step.items():
        want[name] += n * steps
    if kv_quant:
        want["int8_decode_attention"] += cfg.num_hidden_layers * steps
    return want


def t2i_counts(cfg, params, n_prompt: int, steps: int) -> Counter:
    """Kernel launches of one generate_image (batch 1, no int8 cache, no
    a8): dual_counts of an n_prompt-token prompt and `steps` steps."""
    return dual_counts(cfg, params, False, n_prompt, 1, steps)


def nth_call(fn, index: int, wrap):
    """fn with its index-th call (from 0) run as wrap(call)."""
    calls = itertools.count()

    def hooked(*args, **kwargs):
        call = functools.partial(fn, *args, **kwargs)
        return wrap(call) if next(calls) == index else call()
    return hooked


def no_sync(call):
    """call() under torch.cuda.set_sync_debug_mode("error"): any host sync
    inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return call()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def engine_requests(cfg, pixels, budgets, arrivals=None):
    """Raw-pixels requests of fused_inputs' shape, one per budget: 32 text
    ids from a torch.Generator seeded per request, the 578-token block at
    IMG_T (placeholder ids), image i % B of `pixels` (host uint8)."""
    import numpy as np
    from libra_tpu_torch.serving import Request
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    vi = np.full((NQ,), Mv, np.int64)
    vi[IMG_T:IMG_T + Mv] = np.arange(Mv)
    reqs = []
    for i, budget in enumerate(budgets):
        g = torch.Generator().manual_seed(SEED + 10 + i)
        ids = torch.randint(3, cfg.vocab_size, (1, NQ), generator=g).expand(Q, NQ)
        reqs.append(Request(i, ids.numpy().copy(), vi, max_new_tokens=budget,
                            pixels=pixels[i % len(pixels)], img_start=IMG_T,
                            arrival_s=None if arrivals is None else arrivals[i]))
    return reqs


def piece_bytes(cfg, n: int, kv_quant: bool) -> int:
    """Bytes of one slot row's cache piece of n positions, over the four
    buffers (int8 values and fp32 scales, or bf16)."""
    per = cfg.num_hidden_layers * n * cfg.num_attention_heads
    return 4 * (per * (cfg.head_dim + 4) if kv_quant else per * cfg.head_dim * 2)


def recorder(fn, pick, sink: list):
    """fn that also appends pick(its result) to `sink`."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append(pick(out))
        return out
    return wrapped


def rel_l2(a, b) -> float:
    """Relative L2 of logits a against b over b's finite entries (a text
    position's vision slice is -inf); inf where a's -inf entries are
    elsewhere."""
    live = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), live):
        return math.inf
    a, b = a[live].float(), b[live].float()
    return ((a - b).norm() / b.norm()).item()


class FirstStep(Exception):
    """Ends a run once its caller holds what it checks (burst_parity's
    Generator run, merged_burst's warm-up)."""


def burst_parity(card: str, cfg, params, vq_cfg, vq_params, mode: str, reqs, results,
                 firsts: dict, dispatch: list, qkw: dict) -> None:
    """The recycling burst against the port's Generator: each prefill group
    of the burst (`dispatch`, request ids in dispatch order) run alone
    through the fused Generator at B = k, the same bucket and the pool's
    cache length (max_new_tokens = ENGINE_MAX_LEN - N), stopped after its
    first decode step. `firsts` holds each request's first two logits in
    the engine: the prompt pass's, read from its slot row after the
    install, and the first decode step's, over the pool row it was
    installed into (the k = 1 refills' rows recycled, the pool's other
    slots at other key extents). Both must EQUAL the Generator's: the
    shapes, kernels and launch order are the same, apart from the decode
    step's row count at k < B, and every kernel of that step computes its
    rows independently. (A cache of another length would not do: it
    changes the order of the attention's sums, and 32 random layers grow
    the rounding differences far past any tolerance the check could set.)
    The first and the last k = 1 refill (recycled pool rows) run on to
    their budgets: every token they emitted must equal the Generator's."""
    import numpy as np
    import libra_tpu_torch.generation as G
    g = G.Generator(params, cfg, vq_params=vq_params, vq_cfg=vq_cfg)
    gen = G.GenerationConfig(max_new_tokens=ENGINE_MAX_LEN - -(-NQ // ENGINE_BUCKET)
                             * ENGINE_BUCKET, eos_token_id=-1,
                             prompt_bucket=ENGINE_BUCKET, **qkw)
    decode, sample = G.decode_micro_step, G.sample_tokens
    refills = [ids for ids in dispatch if len(ids) == 1]
    whole = {ids[0] for ids in refills[:1] + refills[-1:]}

    def stepped(*args, **kwargs):
        # stop before the step after the tokens wanted (the first step's
        # logits always)
        if step and len(toks) >= want_n:
            raise FirstStep
        out = decode(*args, **kwargs)
        if not step:
            step.append(out[0])
        return out
    rows, unequal = [], []
    for ids in dispatch:
        rq = [reqs[i] for i in ids]
        want_n = rq[0].max_new_tokens if ids[0] in whole else 1
        inputs = {"input_ids": np.stack([r.input_ids for r in rq], 1),
                  "attention_mask": np.ones((len(rq), NQ), np.int64),
                  "vision_indices": np.stack([r.vision_indices for r in rq]),
                  "pixels": np.stack([r.pixels for r in rq]),
                  "img_start": np.array([r.img_start for r in rq])}
        pre, step, toks = [], [], []
        with contextlib.suppress(FirstStep), \
                mock.patch.object(G, "_prefill", recorder(G._prefill, lambda st: st.logits,
                                                          pre)), \
                mock.patch.object(G, "sample_tokens", recorder(sample, lambda t: t, toks)), \
                mock.patch.object(G, "decode_micro_step", stepped):
            g(inputs, gen)
        for b, i in enumerate(ids):
            out = []
            if i in whole:
                seq = torch.stack(toks[:want_n], -1)[:, 0].cpu().numpy()
                same = bool(np.array_equal(results[i].tokens, seq))
                out.append(f"all {want_n} tokens " + ("equal" if same else "differ"))
                if not same:
                    unequal.append(i)
            for name, got, want in zip(("prompt pass", "first decode step"), firsts[i],
                                       (pre[0][:, b], step[0][:, b])):
                if torch.equal(got, want):
                    out.append(f"{name} equal")
                else:
                    out.append(f"{name} relative L2 {rel_l2(got, want):.6g}")
                    unequal.append(i)
            rows.append(f"request {i} (k = {len(ids)}): " + ", ".join(out))
    print(f"{mode} engine burst against the Generator on each prefill group alone, "
          f"logits: " + "; ".join(rows) + f" [{card}]")
    if unequal:
        raise AssertionError(f"{mode} engine burst: logits or tokens of requests "
                             f"{sorted(set(unequal))} differ "
                             f"from the Generator's")


def engine_path(card: str, dev, cfg, vq_cfg, vq_params, params, mode: str, pixels,
                want_seqs, gap_ms: float, main: Counter) -> dict:
    """The serving engine (libra_tpu_torch.serving.ServingEngine) on this
    tree, with raw-pixels requests of the fused path's shape (the quantized
    trees with kv_quant, a8_prefill and text decode):
      1. lockstep: the fused path's B requests at once, MAX_NEW tokens,
         max_len = NQ + MAX_NEW, one k = B group: every request's tokens
         equal to the fused Generator's (`want_seqs`, the same inputs);
      2. a recycling burst: ENGINE_N requests, budgets ENGINE_CHUNK * (i +
         1), bucket 128 (N = 640), max_len 768, run once, one of its
         chunks and its first k = 1 refill profiled: each its
         budget's count with "length", launches derived from the run's own
         schedule, one chunk under set_sync_debug_mode("error"); each
         request's first two logits, and the first and last k = 1
         refill's tokens, equal to the Generator's on its prefill group
         alone (burst_parity);
      3. open loop: the same requests with seeded exponential gaps of mean
         `gap_ms` (a B-row fused prompt pass's TTFT): TTFT p50 / p95 from
         arrival, tokens/s, requests/s, last_run_stats, wall time a chunk
         against the profiled chunk's device time, peak memory;
      4. on the int8 tree, engine.warmup once;
      5. merged chunked prefill (merged_burst).
    Adds the runs' launches to `main`; returns the open loop's figures and
    the merged burst's."""
    import random
    import numpy as np
    from libra_tpu_torch.generation import GenerationConfig
    from libra_tpu_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    quant = mode != "bf16"
    Mv = cfg.max_vision_token_length
    qkw = dict(kv_quant=True, a8_prefill=True, decode_modality="text") if quant else {}
    kw = dict(gen=GenerationConfig(eos_token_id=-1, **qkw), vq_params=vq_params,
              vq_cfg=vq_cfg, max_batch=B)
    px = pixels.cpu().numpy()

    def counted(label, eng, n_prompt, call):
        zero_counts()
        t = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = read_counts()
        main.update(got)
        assert_counts(f"{mode} engine {label}", got,
                      engine_counts(cfg, mode, quant, eng, n_prompt), card)
        return res, wall

    # --- 1. lockstep: the Generator's tokens ---
    inputs = fused_inputs(cfg, dev, pixels)
    ids = inputs["input_ids"].cpu().numpy()
    vi = inputs["vision_indices"].cpu().numpy()
    reqs = [Request(b, ids[:, b], vi[b], max_new_tokens=MAX_NEW, pixels=px[b],
                    img_start=IMG_T) for b in range(B)]
    eng = ServingEngine(params, cfg, max_len=NQ + MAX_NEW, **kw)
    import libra_tpu_torch.serving as SV
    margins = []
    with (logit_margins(SV, margins, cfg.vocab_size) if mode == "int8"
          else contextlib.nullcontext()):
        res, wall = counted("lockstep", eng, NQ, lambda: eng.run(reqs))
    want = want_seqs[:, :, NQ:].cpu().numpy()
    equal = [bool(np.array_equal(r.tokens, want[:, b])) for b, r in enumerate(res)]
    print(f"{mode} engine lockstep: {B} pixels requests, one group of k = "
          f"{eng.last_run_stats['group_sizes']}, {MAX_NEW} tokens each, max_len "
          f"{eng.S}: tokens equal to the fused Generator's {equal}, {wall:.3f} s "
          f"[{card}]")
    if eng.last_run_stats["group_sizes"] != [B] or not all(equal):
        raise AssertionError(f"{mode} engine lockstep differs from the Generator")
    del eng
    spec = {}
    if mode == "int8":
        spec = spec_engine(card, cfg, params, reqs, res, torch.stack(margins).cpu(), kw,
                           counted)

    # --- 2. the recycling burst ---
    budgets = [ENGINE_CHUNK * (i + 1) for i in range(ENGINE_N)]
    burst = engine_requests(cfg, px, budgets)
    eng = ServingEngine(params, cfg, max_len=ENGINE_MAX_LEN, prompt_bucket=ENGINE_BUCKET,
                        decode_chunk=ENGINE_CHUNK, **kw)
    n_bucket = -(-NQ // ENGINE_BUCKET) * ENGINE_BUCKET
    chunk, refill = {}, {}
    profile = functools.partial(profiled, card, f"{mode} engine decode chunk "
                                f"({ENGINE_CHUNK} steps, {B} slots)", out=chunk)
    profile_refill = functools.partial(profiled, card, f"{mode} engine k = 1 refill "
                                       f"(N = {-(-NQ // ENGINE_BUCKET) * ENGINE_BUCKET})",
                                       out=refill)
    # the run keeps each request's first two logits: the prompt pass's from
    # its slot row, the first decode step's from the pool
    firsts, pending, dispatch = {}, {}, []
    order = iter(range(ENGINE_N))       # one bucket, no arrivals: queue order

    def keep_prefill(prefill):
        def wrapped(N, has_px, k, state, reqs, slots):
            state = prefill(N, has_px, k, state, reqs, slots)
            dispatch.append([next(order) for _ in range(k)])
            for i, slot in zip(dispatch[-1], slots.tolist()):
                firsts[i] = [state.logits[:, slot].clone()]
                pending[slot] = i
            return state
        return wrapped

    def keep_step(*args, **kwargs):
        out = decode_step(*args, **kwargs)
        for slot, i in pending.items():
            firsts[i].append(out[0][:, slot].clone())
        pending.clear()
        return out
    decode_step = SV.decode_micro_step
    # the two profiles run inside the counted run: a warm-up run of their
    # own cost 21-35 s a tree of the script's time limit (PERF.md)
    decode = nth_call(nth_call(eng._decode, STRICT_CHUNK, no_sync), 1, profile)
    with mock.patch.object(eng, "_decode", decode), \
            mock.patch.object(eng, "_prefill", keep_prefill(
                nth_call(eng._prefill, 1, profile_refill))), \
            mock.patch.object(SV, "decode_micro_step", keep_step):
        second, t_second = counted("burst", eng, n_bucket, lambda: eng.run(burst))
    rs = dict(eng.last_run_stats)
    lengths = [r.tokens.shape[-1] for r in second]
    print(f"{mode} engine burst: {ENGINE_N} pixels requests, budgets {budgets}, bucket "
          f"{ENGINE_BUCKET} (N = {n_bucket}), max_len {ENGINE_MAX_LEN}, decode_chunk "
          f"{ENGINE_CHUNK}: {t_second:.3f} s (a chunk and a refill profiled), finish "
          f"{sorted({r.finish_reason for r in second})}, chunk {STRICT_CHUNK} under "
          f"set_sync_debug_mode('error') passed; last_run_stats {rs} [{card}]")
    if lengths != budgets or {r.finish_reason for r in second} != {"length"}:
        raise AssertionError(f"{mode} engine burst: lengths {lengths} != budgets "
                             f"{budgets}")
    burst_parity(card, cfg, params, vq_cfg, vq_params, mode, burst, second, firsts,
                 dispatch, qkw)
    moved = piece_bytes(cfg, n_bucket, quant)
    print(f"{mode} engine cache piece per refilled row: {moved / 1e6:.1f} MB written by "
          f"the prompt pass, then read and written again into the pool, "
          f"{2 * moved / 1e6:.1f} MB (whole rows of {ENGINE_MAX_LEN} slots gathered and "
          f"scattered back: {4 * piece_bytes(cfg, ENGINE_MAX_LEN, quant) / 1e6:.1f} MB) "
          f"[{card}]")

    # --- 3. open loop ---
    rng = random.Random(SEED)
    arrivals, t = [], 0.0
    for _ in range(ENGINE_N):
        arrivals.append(t)
        t += rng.expovariate(1e3 / gap_ms)
    stream = engine_requests(cfg, px, budgets, arrivals)
    torch.cuda.reset_peak_memory_stats()
    res, wall = counted("open loop", eng, n_bucket, lambda: eng.run(stream))
    rs = dict(eng.last_run_stats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttft = sorted(r.ttft_s * 1e3 for r in res if r.ttft_s is not None)
    if len(ttft) != ENGINE_N or any(r.tokens.shape[-1] != b for r, b in zip(res, budgets)):
        raise AssertionError(f"{mode} engine open loop: a request did not complete")
    out = dict(ttft_p50_ms=statistics.median(ttft),
               ttft_p95_ms=ttft[math.ceil(0.95 * len(ttft)) - 1],
               tok_s=rs["tokens"] / wall, req_s=ENGINE_N / wall,
               chunk_wall_ms=rs["t_decode"] / rs["n_decode"] * 1e3,
               chunk_device_ms=chunk["device_ms"], refill_device_ms=refill["device_ms"],
               peak_gb=peak_gb)
    print(f"{mode} engine open loop: {ENGINE_N} requests, arrivals at "
          f"{[round(a, 4) for a in arrivals]} s (exponential gaps, mean {gap_ms:.3f} ms), "
          f"{wall:.3f} s: TTFT from arrival p50 {out['ttft_p50_ms']:.3f} ms, p95 (nearest "
          f"rank) {out['ttft_p95_ms']:.3f} ms, {out['tok_s']:.3f} generated tokens/s, "
          f"{out['req_s']:.4f} requests/s; decode chunk {out['chunk_wall_ms']:.3f} ms "
          f"wall (t_decode / n_decode) against {chunk['device_ms']:.3f} ms device in the "
          f"profiled chunk ({chunk['wall_ms']:.3f} ms wall there); peak memory "
          f"{peak_gb:.3f} GB; last_run_stats {rs} [{card}]")

    # --- 4. warmup ---
    if mode == "int8":
        t = time.perf_counter()
        eng.warmup(burst[0])
        torch.cuda.synchronize()
        print(f"{mode} engine warmup: {time.perf_counter() - t:.3f} s, prompt-pass "
              f"shapes {sorted(eng._prefill_shapes)}, stats {eng.stats} [{card}]")
        if {k for _, _, k in eng._prefill_shapes} != set(eng._group_sizes):
            raise AssertionError("warmup did not run every group size")
    del eng
    out["merged"] = merged_burst(card, cfg, params, mode, pixels, kw, main)
    out["spec"] = spec
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{mode} engine phase: {out['phase_s']:.1f} s [{card}]")
    return out


def spec_engine(card: str, cfg, params, reqs, std, margins, kw: dict, counted) -> dict:
    """A spec ServingEngine (gen.spec_decode = SPEC_GAMMA; the int8 tree)
    on the lockstep requests `reqs` against the standard engine's results
    `std` (its steps' top-2 gaps in `margins`): max_len NQ + MAX_NEW +
    SPEC_GAMMA (the verify window's margin), every request MAX_NEW tokens
    held to the standard engine's under the tie rule, launches derived
    from its schedule (engine_counts, through `counted`), spec chunk
    STRICT_CHUNK under set_sync_debug_mode("error")."""
    import numpy as np
    from libra_tpu_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    skw = dict(kw, gen=dataclasses.replace(kw["gen"], spec_decode=SPEC_GAMMA))
    eng = ServingEngine(params, cfg, max_len=NQ + MAX_NEW + SPEC_GAMMA, **skw)
    eng._spec_decode = nth_call(eng._spec_decode, STRICT_CHUNK, no_sync)
    res, wall = counted("spec lockstep", eng, NQ, lambda: eng.run(reqs))
    rs = dict(eng.last_run_stats)
    if rs["n_spec"] <= STRICT_CHUNK or any(r.tokens.shape[-1] != MAX_NEW for r in res):
        raise AssertionError(f"int8 spec engine: {rs}, lengths "
                             f"{[r.tokens.shape[-1] for r in res]}")
    same = tie_rule("int8 spec engine lockstep",
                    torch.from_numpy(np.stack([r.tokens[0] for r in res])),
                    torch.from_numpy(np.stack([r.tokens[0] for r in std])),
                    margins, E2E_TOL_QUANT, card)
    out = dict(tok_s=rs["tokens"] / wall, tok_per_iter=rs["tokens"] / rs["active_iters"],
               chunk_wall_ms=rs["t_spec"] / rs["n_spec"] * 1e3,
               phase_s=time.perf_counter() - t_phase)
    print(f"int8 spec engine lockstep (gamma {SPEC_GAMMA}, max_len {eng.S}): {B} "
          f"requests of {MAX_NEW} tokens in {wall:.3f} s, {out['tok_s']:.3f} tokens/s, "
          f"{rs['n_spec']} spec chunks of {eng.decode_chunk} iterations "
          f"({out['chunk_wall_ms']:.3f} ms wall a chunk), {out['tok_per_iter']:.4f} "
          f"tokens a slot an active iteration; chunk {STRICT_CHUNK} under "
          f"set_sync_debug_mode('error') passed; rows equal to the standard engine's "
          f"throughout {same}; last_run_stats {rs}; {out['phase_s']:.1f} s [{card}]")
    return out


def preencoded_requests(cfg, vq_cfg, vq_params, pixels, budgets):
    """engine_requests' burst in its pre-encoded form: each prompt's image
    block holds the ids CLIP + LFQ give its image (ImageTokenizer's; the
    fused path holds the two equal) and its signal rows the encode's
    features. 610 tokens bucketed to 640, a multiple of ENGINE_C: each is
    merged-eligible."""
    import numpy as np
    from libra_tpu_torch.serving import Request
    from libra_tpu_torch.training.fused import encode_images_to_tokens
    Mv = cfg.max_vision_token_length
    with torch.inference_mode():
        img_ids, img_sig = encode_images_to_tokens(vq_params, vq_cfg, cfg, pixels)
    img_ids, img_sig = img_ids.cpu().numpy(), img_sig.float().cpu().numpy()
    reqs = []
    for r in engine_requests(cfg, pixels.cpu().numpy(), budgets):
        i = r.request_id % pixels.shape[0]
        ids = r.input_ids.copy()
        ids[:, IMG_T:IMG_T + Mv] = img_ids[:, i]
        sig = np.zeros((NQ, cfg.contiguous_signal_size), np.float32)
        sig[IMG_T:IMG_T + Mv] = img_sig[i]
        reqs.append(Request(r.request_id, ids, r.vision_indices, sig,
                            max_new_tokens=r.max_new_tokens))
    return reqs


@contextlib.contextmanager
def dispatch_order(eng, n: int, installed: list):
    """Within the block, `installed` receives the ids of the requests eng
    installs (merged), of n queued in id order with no arrivals: prefills
    and installs each take the queue's head."""
    order = iter(range(n))
    prefill, install = eng._prefill, eng._install

    def on_prefill(N, has_px, k, *args):
        for _ in range(k):
            next(order)
        return prefill(N, has_px, k, *args)

    def on_install(*args):
        installed.append(next(order))
        return install(*args)
    with mock.patch.object(eng, "_prefill", on_prefill), \
            mock.patch.object(eng, "_install", on_install):
        yield


def first_logits(eng, reqs, installed: Optional[list] = None,
                 fed: Optional[dict] = None) -> dict:
    """Run reqs (queued in id order) through eng, whose decode chunks run
    one step (decode_chunk 1, so its merged chunks one iteration too), and
    return each request's first two logits: its prompt's last position's
    (after its prompt pass, or after the merged iteration that took its
    last chunk) and its first decode step's, read from its pool row at the
    end of the chunk that ran them. `installed` receives the ids of the
    requests installed. fed: {request id: (Q,) token}: the token the
    request's first decode step takes, in place of its own prompt-end
    choice (its carried logits row is replaced by one whose argmax is that
    token, after the prompt-end logits are read), so that a run compared
    with another takes the other's token where a near tie at the prompt end
    could flip the argmax."""
    firsts, awaiting, installing = {}, {}, {}
    order = iter(range(len(reqs)))
    prefill, install, merged, decode = eng._prefill, eng._install, eng._merged, eng._decode

    def stepped(state):
        for slot, i in awaiting.items():
            firsts[i].append(state.logits[:, slot].clone())
        awaiting.clear()

    def feed(state):
        for slot, i in awaiting.items():
            if fed is not None and i in fed:
                row = torch.full_like(state.logits[:, slot], -1e30)
                state.logits[:, slot] = row.scatter_(-1, fed[i][:, None], 1e30)

    def on_prefill(N, has_px, k, state, staged, slots):
        state = prefill(N, has_px, k, state, staged, slots)
        for slot in slots.tolist():
            i = next(order)
            firsts[i] = [state.logits[:, slot].clone()]
            awaiting[slot] = i
        return state

    def on_install(state, prompts, staged, slot):
        installing[slot] = next(order)
        if installed is not None:
            installed.append(installing[slot])
        return install(state, prompts, staged, slot)

    def on_merged(state, prompts, flags, generator):
        f = flags.tolist()
        feed(state)
        out, state = merged(state, prompts, flags, generator)
        stepped(state)
        pf = [slot for slot in range(eng.B) if f[2][slot]]
        if pf and f[3][pf[0]] + eng._C >= f[4][pf[0]]:
            i = installing.pop(pf[0])
            firsts[i] = [state.logits[:, pf[0]].clone()]
            awaiting[pf[0]] = i
        return out, state

    def on_decode(state, *args):
        feed(state)
        out, state = decode(state, *args)
        stepped(state)
        return out, state
    if eng.decode_chunk != 1 or eng._Km != 1:
        raise ValueError("first_logits reads logits at chunk ends: one step a chunk")
    with mock.patch.object(eng, "_prefill", on_prefill), \
            mock.patch.object(eng, "_install", on_install), \
            mock.patch.object(eng, "_merged", on_merged), \
            mock.patch.object(eng, "_decode", on_decode):
        eng.run(reqs)
    return firsts


def merged_burst(card: str, cfg, params, mode: str, pixels, kw: dict,
                 main: Counter) -> dict:
    """Merged chunked prefill on this tree: the recycling burst's requests
    pre-encoded (preencoded_requests), an engine at max_len 768 (Np =
    704), bucket 128, decode_chunk 8 and merged_chunk 64 with
    merged_prefill=None resolving on, so that as slots free one at a time
    while the others decode, the next prompt is installed and rides the
    merged chunks, 64 tokens an iteration (_Km = 2 iterations a chunk, the
    largest divisor of 128 / 64 within 8).
      1. warm-up: the merged run until the first installed request's
         first token (FirstStep), merged chunk 1 profiled (device and wall
         ms), the tokens emitted until then kept;
      2. the same burst with merged_prefill=False (k = 1 refills);
      3. the merged run again: every token of the warm-up equal at full
         depth (the prefill group, the decode chunks, the first install's
         merged chunks), installs and merged chunks > 0, every request its
         budget with "length", launches as derived from the run's
         schedule (engine_counts), merged chunk STRICT_MERGED under
         set_sync_debug_mode("error");
      4. two layers at full width, decode chunks of one step (PARITY_
         BUDGETS): the merged run twice, each installed request's first
         two logits equal bit for bit (the two-run check), and within
         E2E_TOL (E2E_TOL_QUANT) of the same merged run with the plain
         versions and, in bf16, of merged_prefill=False with the prompt
         pass's attention plain, as the chunk segment's is (libra_tpu's
         bf16 scores); the distance to the flash prompt pass (fp32 scores)
         is printed beside. In the quantized trees merged against
         dedicated compares the kernels at M = 68 with the dense route at
         M = 640 (two functions, as split on and off in libra_tpu); those
         distances are printed, not bounded.
    TTFT p50 / p95 (from the run's start) of the installed requests and
    generated tokens/s are printed for runs 3 and 2 side by side. Adds the
    counted runs' launches to `main`; returns the figures."""
    import numpy as np
    from libra_tpu_torch.serving import ServingEngine
    quant = mode != "bf16"
    n_bucket = -(-NQ // ENGINE_BUCKET) * ENGINE_BUCKET
    budgets = [ENGINE_CHUNK * (i + 1) for i in range(ENGINE_N)]
    reqs = preencoded_requests(cfg, kw["vq_cfg"], kw["vq_params"], pixels, budgets)

    def engine(p, c, merged, chunk=ENGINE_CHUNK, **gen_kw):
        opts = dict(kw, gen=dataclasses.replace(kw["gen"], **gen_kw))
        return ServingEngine(p, c, max_len=ENGINE_MAX_LEN, prompt_bucket=ENGINE_BUCKET,
                             decode_chunk=chunk, merged_chunk=ENGINE_C,
                             merged_prefill=merged, **opts)

    def check_run(label, eng, res, merged):
        lengths = [r.tokens.shape[-1] for r in res]
        rs = eng.last_run_stats
        if lengths != budgets or {r.finish_reason for r in res} != {"length"}:
            raise AssertionError(f"{label}: lengths {lengths} != budgets {budgets}")
        if merged and not (rs["n_install"] > 0 and rs["n_merged"] > 0):
            raise AssertionError(f"{label}: no merged installs or chunks: {rs}")

    def counted(label, eng, call, merged):
        zero_counts()
        t = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = read_counts()
        main.update(got)
        assert_counts(label, got, engine_counts(cfg, mode, quant, eng, n_bucket,
                                                pixels=False), card)
        check_run(label, eng, res, merged)
        return res, wall

    eng = engine(params, cfg, None)
    n_iters = ENGINE_BUCKET // ENGINE_C
    km = max(d for d in range(1, min(ENGINE_CHUNK, n_iters) + 1) if n_iters % d == 0)
    if not (eng._merged_on and eng._Np == ENGINE_MAX_LEN - ENGINE_C and eng._Km == km):
        raise AssertionError(f"merged prefill: on {eng._merged_on}, Np {eng._Np}, "
                             f"Km {eng._Km}")
    # --- 1. warm-up: the merged run until the first installed request's
    # first token, merged chunk 1 profiled (every chunk has one shape: _Km
    # iterations of M_PACKED rows; profiling costs seconds a chunk in the
    # profiler's bookkeeping), the tokens emitted until then kept ---
    chunk, early, warm_installed = {}, {}, []
    profile = functools.partial(profiled, card, f"{mode} merged chunk ({eng._Km} "
                                f"iterations of T = {M_PACKED} packed rows, "
                                f"{cfg.num_hidden_layers} layers)", out=chunk)

    def keep(rid, tok, reason):
        early.setdefault(rid, []).append(np.asarray(tok).copy())
        if rid in warm_installed:
            raise FirstStep
    t = time.perf_counter()
    with dispatch_order(eng, ENGINE_N, warm_installed), \
            mock.patch.object(eng, "_merged", nth_call(eng._merged, 1, profile)):
        try:
            eng.run(reqs, on_token=keep)
            raise AssertionError(f"{mode} merged burst warm-up: no installed request "
                                 f"emitted a token")
        except FirstStep:
            pass
    t_first = time.perf_counter() - t
    if "device_ms" not in chunk:
        raise AssertionError(f"{mode} merged burst warm-up: no merged chunk profiled")
    n_early = sum(len(v) for v in early.values())
    print(f"{mode} merged burst warm-up, until installed request {warm_installed[0]}'s "
          f"first token: {t_first:.3f} s, {n_early} tokens of requests {sorted(early)}; "
          f"the profiled merged chunk {chunk['device_ms']:.3f} ms device "
          f"({chunk['device_ms'] / eng._Km:.3f} ms an iteration), {chunk['wall_ms']:.3f} "
          f"ms wall [{card}]")

    # --- 2. the same burst, dedicated prefill ---
    ded = engine(params, cfg, False)
    ded_res, ded_wall = counted(f"{mode} engine burst pre-encoded, merged_prefill=False",
                                ded, lambda: ded.run(reqs), False)
    ded_rs = dict(ded.last_run_stats)
    del ded

    # --- 3. merged again: counted, one chunk with no sync allowed; every
    # token the warm-up emitted equal ---
    installed = []
    with dispatch_order(eng, ENGINE_N, installed), \
            mock.patch.object(eng, "_merged", nth_call(eng._merged, STRICT_MERGED, no_sync)):
        second, wall = counted(f"{mode} engine merged burst", eng, lambda: eng.run(reqs),
                               True)
    rs = dict(eng.last_run_stats)
    by_id = {r.request_id: r for r in second}
    if warm_installed != installed[:len(warm_installed)] or not all(
            np.array_equal(np.stack(toks, -1), by_id[rid].tokens[:, :len(toks)])
            for rid, toks in early.items()):
        raise AssertionError(f"{mode} merged burst: the counted run parted from the "
                             f"warm-up's {n_early} tokens (installs {warm_installed} then "
                             f"{installed})")
    if rs["n_install"] != len(installed) or not installed:
        raise AssertionError(f"{mode} merged burst: installs {installed}, stats {rs}")
    del eng

    def ttft(res):
        t = sorted(res[i].ttft_s * 1e3 for i in installed)
        return statistics.median(t), t[math.ceil(0.95 * len(t)) - 1]
    agree = float(np.mean([np.mean(a.tokens == b.tokens) for a, b in zip(second, ded_res)]))
    out = dict(installs=rs["n_install"], chunks=rs["n_merged"], km=km,
               chunk_device_ms=chunk["device_ms"],
               chunk_wall_ms=rs["t_merged"] / rs["n_merged"] * 1e3,
               install_wall_ms=rs["t_install"] / rs["n_install"] * 1e3,
               ttft_ms=ttft(second), ded_ttft_ms=ttft(ded_res),
               tok_s=rs["tokens"] / wall, ded_tok_s=ded_rs["tokens"] / ded_wall)
    print(f"{mode} merged burst: {ENGINE_N} pre-encoded requests, budgets {budgets}, "
          f"bucket {ENGINE_BUCKET} (N = {n_bucket}), max_len {ENGINE_MAX_LEN}, "
          f"merged_chunk {ENGINE_C}: the warm-up's {n_early} tokens equal, merged chunk "
          f"{STRICT_MERGED} under set_sync_debug_mode('error') passed; installed "
          f"requests {installed} ({out['install_wall_ms']:.3f} ms wall an install), "
          f"{rs['n_merged']} merged chunks ({out['chunk_wall_ms']:.3f} ms wall each, "
          f"{out['chunk_device_ms']:.3f} ms device in the warm-up's profile), "
          f"{rs['n_decode']} decode chunks, prefill groups {rs['group_sizes']}; "
          f"{wall:.3f} s, {out['tok_s']:.3f} generated tokens/s, installed requests' "
          f"TTFT p50 {out['ttft_ms'][0]:.3f} ms, p95 {out['ttft_ms'][1]:.3f} ms; "
          f"last_run_stats {rs} [{card}]")
    print(f"{mode} same burst with merged_prefill=False: prefill groups "
          f"{ded_rs['group_sizes']}, {ded_rs['n_decode']} decode chunks, {ded_wall:.3f} s, "
          f"{out['ded_tok_s']:.3f} generated tokens/s, the same requests' TTFT p50 "
          f"{out['ded_ttft_ms'][0]:.3f} ms, p95 {out['ded_ttft_ms'][1]:.3f} ms; tokens "
          f"equal to the merged run's: {agree:.4f} of them [{card}]")

    # --- 4. two layers at full width: merged twice, kernels vs plain,
    # merged vs dedicated ---
    small_cfg = cfg.replace(num_hidden_layers=2)
    small = decoder_params(small_cfg, pixels.device, mode)
    parity = [dataclasses.replace(r, max_new_tokens=b)
              for r, b in zip(reqs, PARITY_BUDGETS)]
    two = []                                    # the installed requests
    got = first_logits(engine(small, small_cfg, None, 1), parity, two)
    # every other run's first decode steps take the checked run's
    # prompt-end tokens: a near tie there may flip the argmax, and a step on
    # another token is not the same step
    fed = {i: got[i][0].argmax(dim=-1) for i in got}
    again = first_logits(engine(small, small_cfg, None, 1), parity, fed=fed)
    with plain_kernels():
        want = first_logits(engine(small, small_cfg, None, 1), parity, fed=fed)
    ded_l = first_logits(engine(small, small_cfg, False, 1), parity, fed=fed)
    # dedicated prefill with the prompt pass's attention in plain PyTorch, as
    # the merged chunk segment's (libra_tpu's bridged_attention: scores
    # rounded to bf16), not in the flash kernel (fp32 scores)
    ded_plain = first_logits(engine(small, small_cfg, False, 1, attn_impl="plain"),
                             parity, fed=fed)
    del small
    tol = E2E_TOL_QUANT if quant else E2E_TOL
    if not two:
        raise AssertionError(f"{mode} merged 2-layer run installed nothing")

    def dist(ref):
        return {i: [round(rel_l2(a, b), 6) for a, b in zip(got[i], ref[i])] for i in two}
    vs_plain, vs_ded, vs_ded_plain = dist(want), dist(ded_l), dist(ded_plain)
    print(f"{mode} merged burst, 2 layers at full width, budgets {list(PARITY_BUDGETS)}: "
          f"installed requests' (prompt end, first decode step) logits bit for bit "
          f"those of a second merged run; relative L2 "
          f"against the plain versions {vs_plain} (tol {tol}); against "
          f"merged_prefill=False {vs_ded}, and with the prompt pass's attention plain "
          f"{vs_ded_plain}" + (f" (tol {tol} on the latter: the former also has fp32 "
                               f"scores in the flash kernel against bf16 in the chunk "
                               f"segment's plain attention)" if not quant else
                               " (not bounded: the kernels at M = 68 against the dense "
                               "route at M = 640 compute another function)")
          + f" [{card}]")
    if not all(torch.equal(a, b) for i in two for a, b in zip(got[i], again[i])):
        raise AssertionError(f"{mode} merged 2-layer run: two runs of one schedule "
                             "gave different logits")
    if any(len(got[i]) != 2 for i in two) or not all(v < tol for i in two
                                                       for v in vs_plain[i]):
        raise AssertionError(f"{mode} merged 2-layer logits differ from the plain "
                             f"versions: {vs_plain}")
    if not quant and not all(v < tol for i in two for v in vs_ded_plain[i]):
        raise AssertionError(f"{mode} merged 2-layer logits differ from dedicated "
                             f"prefill: {vs_ded_plain}")
    return out


def profile_fused(card: str, cfg, params, args, fkw, gen, mode: str) -> None:
    """torch.profiler over one fused prompt pass with split on and one
    with split off: device time by kernel, and that of CLIP + LFQ (the
    encode, under a record_function region)."""
    import libra_tpu_torch.generation as G
    encode = G.encode_images_to_tokens

    def encode_in_region(*a):
        with torch.profiler.record_function(ENCODE_REGION):
            return encode(*a)

    with mock.patch.object(G, "encode_images_to_tokens", encode_in_region), \
            torch.inference_mode():
        for split in (True, False):
            step = dataclasses.replace(gen, split_prefill=split)
            profiled(card, f"{mode} fused prompt pass, split {'on' if split else 'off'}",
                     lambda: G._prefill(params, *args, cfg=cfg, gen=step, **fkw),
                     regions=(ENCODE_REGION,))


def profiled(card: str, label: str, fn, rows: int = PROFILE_ROWS, regions=(),
             out: Optional[dict] = None):
    """Run fn under torch.profiler: print its wall and device time and the
    kernels that take the most device time, and the device time of the
    kernels run inside each record_function region named in `regions`;
    return fn's result. `out` receives wall_ms and device_ms. The host's
    operators are traced only where a region is asked for: their events
    (several for each kernel) cost the profiler seconds to collect and
    sort at a decode step's scale."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if regions else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels' own rows (an op's row repeats its kernels' time)
    cpu = torch.autograd.DeviceType.CPU
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type != cpu and e.key not in regions),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {label}: {wall * 1e3:.3f} ms wall, {device_ms:.3f} "
          f"ms device (the profile took {time.perf_counter() - t_all:.2f} s in all) [{card}]")
    if out is not None:
        out.update(wall_ms=wall * 1e3, device_ms=device_ms)
    for r in regions:
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.key == r and e.device_type == cpu) / 1e3
        print(f"  region {r}: {ms:.3f} ms device ({ms / device_ms:.1%} of the "
              f"device time)")
    for e in kernels[:rows]:
        print(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d} launches")
    return res


def profile_paths(card: str, cfg, params, args, gen, mode: str) -> None:
    """torch.profiler over one prompt pass, then over 4 text-only decode
    steps: wall and device time, and the kernels that take the most device
    time."""
    from libra_tpu_torch.generation import _prefill, decode_micro_step

    def record(name, fn):
        return profiled(card, f"{mode} {name}", fn)

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


# ---------------------------------------------------------------------------
# HTTP serving (serve.py) and checkpoint loading (checkpoint.py)
# ---------------------------------------------------------------------------

SERVE_NEW = 16                                # tokens a served request asks for
SERVE_POSTS = 4                               # concurrent POSTs, then one SSE stream
CKPT_LAYERS = 2                               # the checkpoint phase's depth
CLIP_DIR = "openai-clip-vit-large-patch14-336"


def recorded_waves(app, starts: Optional[dict] = None) -> list:
    """Patch app.engine.run on the instance (the scheduler thread reads it
    at each wave) so that each wave's requests and results are kept;
    `starts` receives each request's wave start (perf_counter)."""
    waves = []
    run = app.engine.run

    def wrapped(requests, on_token=None):
        if starts is not None:
            starts.update((r.request_id, time.perf_counter()) for r in requests)
        results = run(requests, on_token=on_token)
        waves.append((list(requests), results))
        return results
    app.engine.run = wrapped
    return waves


def replay_waves(label: str, app, waves, card: str) -> Counter:
    """Each served wave again through ServingEngine.run: the same requests
    in the same composition, so the same schedule (prefill groups, merged
    chunks, decode chunks) on the same engine. Every request's tokens and
    finish reason must equal the served ones exactly: a replay repeats
    every reduction in its order, so no near tie can flip (tie_rule is for
    runs that change the order). Returns the replay's launches."""
    import numpy as np
    run = type(app.engine).run.__get__(app.engine)      # the unpatched run
    zero_counts()
    for i, (reqs, served) in enumerate(waves):
        again = run(reqs)
        for a, b in zip(served, again):
            if (a.request_id, a.finish_reason) != (b.request_id, b.finish_reason) \
                    or not np.array_equal(a.tokens, b.tokens):
                diff = np.nonzero(a.tokens[0][:b.tokens.shape[-1]]
                                  != b.tokens[0][:a.tokens.shape[-1]])[0]
                raise AssertionError(
                    f"{label}: wave {i} request {a.request_id}: served {a.finish_reason} "
                    f"{a.tokens[0].tolist()}, ServingEngine.run {b.finish_reason} "
                    f"{b.tokens[0].tolist()} (first difference at {diff[:1].tolist()})")
    torch.cuda.synchronize()
    return read_counts()


def http(url: str, body: Optional[bytes] = None, stream: bool = False, timeout=900):
    """A GET (no body) or a JSON POST to the app's server: (status, parsed
    reply, seconds to the first server-sent event or None); a stream's
    reply is its list of events."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not stream:
                return r.status, json.loads(r.read()), None
            if r.headers["Content-Type"] != "text/event-stream":
                raise AssertionError(f"stream Content-Type {r.headers['Content-Type']}")
            events, first = [], None
            for line in r:
                if line.startswith(b"data: "):
                    first = first if first is not None else time.perf_counter() - t0
                    events.append(json.loads(line[len(b"data: "):]))
            return r.status, events, first
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), None


def serve_path(card: str, cfg, vq_cfg, pipe, mode: str, images, main: Counter) -> dict:
    """libra_tpu_torch.serve over this tree (`pipe`, full_path's pipeline,
    full width and depth; the quantized trees with the engine phase's
    kv_quant, a8_prefill and text decode): ServeApp + make_server on a
    free localhost port, then GET /healthz, a malformed body (400), and
    at once SERVE_POSTS POSTs to /v1/generate (two text prompts, two with
    the pixels of two of the images, CLIP-normalized, as JSON) and one
    SSE stream, SERVE_NEW tokens each. Each answer's text must be the
    decode of its request's tokens in the engine's results (the waves the
    scheduler ran, recorded), the stream's deltas must add up to its final
    text, and each wave replayed through ServingEngine.run must give the
    same tokens and the same launches (replay_waves). Launches counted
    over the traffic: B1 in every tree, B2 / B5 and B3 in the quantized
    ones. Returns requests/s, TTFT p50 from each request's send (its
    wave's start plus the engine's ttft_s, less the time its POST was
    sent, on this process's clock), the stream's first event and the
    phase's seconds. Five requests in two or three waves: smoke figures,
    not a serving metric."""
    from libra_tpu_torch.serve import ServeApp, make_server
    from libra_tpu_torch.training.fused import maybe_normalize_pixels
    t_phase = time.perf_counter()
    quant = mode != "bf16"
    qkw = dict(kv_quant=True, a8_prefill=True, decode_modality="text") if quant else {}
    app = ServeApp(pipe, max_batch=B, max_len=ENGINE_MAX_LEN, prompt_bucket=ENGINE_BUCKET,
                   decode_chunk=ENGINE_CHUNK, max_new_default=SERVE_NEW, **qkw)
    starts = {}
    waves = recorded_waves(app, starts)
    srv = make_server(app, "127.0.0.1", 0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    pixels = [maybe_normalize_pixels(vq_cfg, im).cpu().numpy().tolist() for im in images[:2]]
    payloads = [{"prompt": QUESTIONS[0]}, {"prompt": QUESTIONS[1], "pixels": pixels[0]},
                {"prompt": QUESTIONS[2]}, {"prompt": QUESTIONS[3], "pixels": pixels[1]},
                {"prompt": FOLLOW_UPS[0][0], "stream": True}]
    bodies = [json.dumps(dict(p, max_new_tokens=SERVE_NEW)).encode() for p in payloads]
    replies, sent = [None] * len(bodies), [None] * len(bodies)

    def post(i):
        sent[i] = time.perf_counter()
        try:
            replies[i] = http(url + "/v1/generate", bodies[i], stream=i == SERVE_POSTS)
        except Exception as e:            # noqa: BLE001 -- reported below
            replies[i] = (None, repr(e), None)

    try:
        health = http(url + "/healthz")
        bad = http(url + "/v1/generate", b"{not json")
        zero_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        got = read_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
    main.update(got)
    if health[0] != 200 or health[1].get("ok") is not True:
        raise AssertionError(f"{mode} serve /healthz: {health}")
    if bad[0] != 400:
        raise AssertionError(f"{mode} serve malformed body: {bad[0]} {bad[1]}, expected 400")
    failed = [(i, r[:2]) for i, r in enumerate(replies) if r[0] != 200]
    if failed:
        raise AssertionError(f"{mode} serve: requests failed {failed}")
    results = {r.request_id: r for _, res in waves for r in res}
    post_ids = [replies[i][1]["id"] for i in range(SERVE_POSTS)]
    stream_ids = sorted(set(results) - set(post_ids))
    if len(results) != len(bodies) or len(stream_ids) != 1:
        raise AssertionError(f"{mode} serve: engine results {sorted(results)} for POSTs "
                             f"{post_ids} and one stream")
    for i, rid in enumerate(post_ids):
        ans, res = replies[i][1], results[rid]
        if (ans["text"], ans["finish_reason"]) != (app.text(res), res.finish_reason):
            raise AssertionError(f"{mode} serve: request {rid} answered {ans}, the engine "
                                 f"gave {res.finish_reason} {res.tokens[0].tolist()}")
    events, first_event = replies[SERVE_POSTS][1:]
    res = results[stream_ids[0]]
    final = events[-1]
    if (final.get("finish_reason") != res.finish_reason
            or final["text"] != app.text(res)
            or "".join(e.get("delta", "") for e in events[:-1]) != final["text"]):
        raise AssertionError(f"{mode} serve: stream events {events} against the engine's "
                             f"{res.finish_reason} {res.tokens[0].tolist()}")
    if any(r.tokens.shape[-1] > SERVE_NEW or r.finish_reason not in ("eos", "length")
           for r in results.values()):
        raise AssertionError(f"{mode} serve: finish "
                             f"{[(r.finish_reason, r.tokens.shape) for r in results.values()]}")
    want = {"flash_bridged_attention"} | ({MATMUL_KERNEL[mode], "int8_decode_attention"}
                                          if quant else set())
    if not all(got[k] > 0 for k in want):
        raise AssertionError(f"{mode} serve: launches {dict(got)}; each of {sorted(want)} "
                             "must launch")
    again = replay_waves(f"{mode} serve replay", app, waves, card)
    if again != got:
        raise AssertionError(f"{mode} serve: the replay launched {dict(again)}, the served "
                             f"waves {dict(got)}")
    sent_at = dict(zip(post_ids + stream_ids, sent))
    ttft = [(starts[rid] + r.ttft_s - sent_at[rid]) * 1e3 for rid, r in results.items()
            if r.ttft_s is not None]
    out = dict(req_s=len(bodies) / wall, ttft_p50_ms=statistics.median(ttft),
               first_event_ms=first_event * 1e3, wall_s=wall,
               waves=[[r.request_id for r in reqs] for reqs, _ in waves],
               phase_s=time.perf_counter() - t_phase)
    print(f"{mode} serve: /healthz {health[1]}, malformed body {bad[0]}; {SERVE_POSTS} POSTs "
          f"(2 text, 2 pixels) and one SSE stream at once, {SERVE_NEW} tokens each, in "
          f"{wall:.3f} s: {out['req_s']:.4f} requests/s, TTFT p50 {out['ttft_p50_ms']:.3f} ms "
          f"(from each request's send: its wave's start + the engine's ttft_s), the "
          f"stream's first event at "
          f"{out['first_event_ms']:.3f} ms from its POST; waves {out['waves']}; answers equal "
          f"to the engine's results, the replay's tokens and launches equal to the served "
          f"waves'; launches {dict(got)}; {out['phase_s']:.1f} s [{card}]")
    return out


def noised(tree, g: torch.Generator):
    """A copy of a parameter tree with N(0, 0.02) added to every leaf (in
    its dtype), so that no two leaves a mapping could swap are equal
    (zero biases, unit norm scales)."""
    if isinstance(tree, dict):
        return {k: noised(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [noised(v, g) for v in tree]
    return tree + (torch.randn(tree.shape, generator=g, device=tree.device) * 0.02).to(tree.dtype)


def host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of t (a view saves alone, not its storage)."""
    return t.detach().contiguous().cpu()


def export_decoder(p, cfg) -> dict:
    """The decoder tree under the reference LibraForCausalLM's names, the
    inverse of checkpoint.convert_libra_state_dict: x @ W weights back to
    torch's (out, in), layers unstacked."""
    sd, lay = {}, p["layers"]
    lows = {f"vision_{n}": f"vision_{n}_proj" for n in "qkvo"}
    lows |= {f"{n}_bridge_{s}": f"vision_{n}_bridge_on_{w}" for n in "kv"
             for s, w in (("lang", "language"), ("vis", "vision"))}
    for i in range(cfg.num_hidden_layers):
        for part, names, low in (
                ("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj"), lows),
                ("mlp", ("gate_proj", "up_proj", "down_proj"),
                 {f"vision_{n}": f"vision_{n}_proj" for n in ("gate", "up", "down")})):
            src = lay["attn" if part == "self_attn" else "mlp"]
            pre = f"model.layers.{i}.{part}"
            for n in names:
                sd[f"{pre}.{n}.weight"] = host(src[n][i].T)
            for n, ref in low.items():
                if n in src:
                    sd[f"{pre}.{ref}.weight_A"] = host(src[n]["wa"][i].T)
                    sd[f"{pre}.{ref}.weight_B"] = host(src[n]["wb"][i].T)
        for n in ("input_layernorm", "post_attention_layernorm", "vision_input_layernorm",
                  "vision_post_attention_layernorm"):
            sd[f"model.layers.{i}.{n}.weight"] = host(lay[n][i])
    sd["model.embed_tokens.weight"] = host(p["embed_tokens"])
    for q in range(cfg.vision_codebook_num):
        sd[f"model.vision_embed_tokens.{q}.weight"] = host(p["vision_embed_tokens"][q])
        sd[f"vision_lm_head.heads.{q}.weight"] = host(p["vision_lm_head"][q].T)
    sd["model.norm.weight"] = host(p["norm"])
    sd["model.vision_norm.weight"] = host(p["vision_norm"])
    sd["lm_head.weight"] = host(p["lm_head"].T)
    sd["model.vision_contiguous_signal_processor.weight"] = host(p["signal_proj"].T)
    if "signal_norm" in p:
        sd["model.vision_signal_norm.weight"] = host(p["signal_norm"])
    return sd


def export_clip(c, ccfg) -> dict:
    """The CLIP tree under HF CLIPVisionModel's names (vision_model.*)."""
    pre, P, D = "vision_model.", ccfg.patch_size, ccfg.hidden_size
    sd = {pre + "embeddings.class_embedding": host(c["class_embedding"]),
          pre + "embeddings.patch_embedding.weight": host(
              c["patch_embedding"].reshape(P, P, 3, D).permute(3, 2, 0, 1)),
          pre + "embeddings.position_embedding.weight": host(c["position_embedding"])}
    for ours, theirs in (("pre_layernorm", "pre_layrnorm"), ("post_layernorm", "post_layernorm")):
        sd[f"{pre}{theirs}.weight"] = host(c[ours]["scale"])
        sd[f"{pre}{theirs}.bias"] = host(c[ours]["bias"])
    lay = c["layers"]
    for i in range(ccfg.num_hidden_layers):
        b = f"{pre}encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{b}.{theirs}.weight"] = host(lay[ours]["scale"][i])
            sd[f"{b}.{theirs}.bias"] = host(lay[ours]["bias"][i])
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            sd[f"{b}.{theirs}.weight"] = host(lay[ours]["w"][i].T)
            sd[f"{b}.{theirs}.bias"] = host(lay[ours]["b"][i])
    return sd


def export_vqgan(tree, vq_cfg) -> dict:
    """quant_conv, post_quant_conv and the conv decoder under the
    reference VQModel's names (HWIO -> OIHW), with a loss.* key that the
    loader must drop."""
    from libra_tpu_torch.models.vqgan import decoder_plan
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = host(p["w"].permute(3, 2, 0, 1))
        sd[f"{name}.bias"] = host(p["b"])

    def gn(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = host(p["scale"]), host(p["bias"])

    def block(name, p):
        for n, v in p.items():
            (gn if n.startswith("norm") else conv)(f"{name}.{n}", v)

    conv("quant_conv", tree["quant_conv"])
    conv("post_quant_conv", tree["post_quant_conv"])
    dec = tree["decoder"]
    for n in ("conv_in", "conv_out"):
        conv(f"decoder.{n}", dec[n])
    for n in ("norm_out", "first_norm"):
        if n in dec:
            gn(f"decoder.{n}", dec[n])
    for n in ("block_1", "attn_1", "block_2"):
        block(f"decoder.mid.{n}", dec[f"mid_{n}"])
    levels, _ = decoder_plan(vq_cfg)
    for lev, entry in zip(levels, dec["up"]):
        i = lev["i_level"]
        for kind in ("block", "attn"):
            for j, p in enumerate(entry[kind]):
                block(f"decoder.up.{i}.{kind}.{j}", p)
        if "upsample_conv" in entry:
            conv(f"decoder.up.{i}.upsample.conv", entry["upsample_conv"])
    sd["loss.discriminator.main.0.weight"] = torch.zeros(64, 3, 4, 4)
    return sd


def widened(tree):
    """A copy of a parameter tree with every leaf in fp32."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [widened(v) for v in tree]
    return tree.float()


def same_tree(label: str, got, want, dtype) -> int:
    """got's structure equal to want's and every leaf of got of `dtype` and
    bit for bit want's leaf in that dtype (an exact cast: bf16 sources).
    Returns the leaves compared."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(got)} != {sorted(want)}")
        return sum(same_tree(f"{label}/{k}", got[k], want[k], dtype) for k in want)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{label}: {len(got)} entries, {len(want)} written")
        return sum(same_tree(f"{label}[{i}]", g, w, dtype)
                   for i, (g, w) in enumerate(zip(got, want)))
    if got.dtype != dtype or got.device != want.device or not torch.equal(got, want.to(dtype)):
        raise AssertionError(f"{label}: loaded {got.dtype} {tuple(got.shape)} on {got.device} "
                             f"differs from the {want.dtype} {tuple(want.shape)} written")
    return 1


def checkpoint_path(card: str, dev, cfg, vq_cfg, vq_params, main: Counter) -> dict:
    """LibraPipeline.from_pretrained's loading, once in bf16: a checkpoint
    dir in the reference layout written to a temporary dir at full width
    and CKPT_LAYERS layers, from seeded trees on the card (noised, so no
    two leaves a mapping could swap are equal) through this script's
    inverse mappings: config.json, the decoder's state dict in two
    pytorch_model-*.bin shards, vqgan.ckpt (quant and post-quant convs and
    the conv decoder at the default VQGANConfig's shapes, from the
    package's init_params, and a loss.* key), the nested CLIP ViT-L/14-336 dir
    (config.json + weights); no YAML (the card has no PyYAML): the YAML
    loader is patched to give the spec the YAML would (the two-tap
    select_layer, the nested dir). Loaded through
    pipeline._load_pretrained (what from_pretrained calls, with a
    SimpleTextTokenizer: the card has no transformers): every decoder
    leaf bit for bit its source in bf16, every CLIP and VQGAN leaf its
    source widened to fp32 (libra_tpu's dtypes). Then a ServeApp over the
    loaded trees answers one text and one pixels request (the fp32 CLIP
    tree beside the bf16 decoder): each request's tokens equal to a
    ServingEngine's over the source trees (CLIP and VQGAN widened to
    fp32), each wave's equal to its replay; launches counted (B1). Last,
    generate_image (greedy) on the loaded trees: tokens equal to the same
    call on the source trees, pixels bit for bit. Returns the load's
    seconds, the checkpoint's bytes and the phase's seconds."""
    import tempfile
    from libra_tpu_torch.config import VisionTokenizerSpec
    from libra_tpu_torch.pipeline import LibraPipeline, _load_pretrained
    from libra_tpu_torch.serve import ServeApp
    from libra_tpu_torch.serving import ServingEngine
    from libra_tpu_torch.tokenization import SimpleTextTokenizer
    from libra_tpu_torch.training.fused import maybe_normalize_pixels
    t_phase = time.perf_counter()
    small = cfg.replace(num_hidden_layers=CKPT_LAYERS)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    with torch.no_grad():
        src = noised(decoder_params(small, dev), g)
        clip_src = noised(vq_params["clip"], g)
        # the quant convs and the conv decoder of the package's init_params
        vq_src = noised({k: vq_params[k] for k in ("quant_conv", "post_quant_conv",
                                                   "decoder")}, g)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        (d / "config.json").write_text(json.dumps(small.to_dict()))
        sd = export_decoder(src, small)
        keys = sorted(sd)
        for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
            torch.save({k: sd[k] for k in part}, str(d / f"pytorch_model-0000{i + 1}-of-00002.bin"))
        del sd
        torch.save({"state_dict": export_vqgan(vq_src, vq_cfg), "epoch": 0},
                   str(d / "vqgan.ckpt"))
        (d / CLIP_DIR).mkdir()
        (d / CLIP_DIR / "config.json").write_text(json.dumps(
            {"model_type": "clip", "vision_config": dataclasses.asdict(vq_cfg.clip)}))
        torch.save(export_clip(clip_src, vq_cfg.clip), str(d / CLIP_DIR / "pytorch_model.bin"))
        write_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        spec = VisionTokenizerSpec(vq_cfg, str(d / "vqgan.ckpt"), None, str(d / CLIP_DIR))
        t0 = time.perf_counter()
        with mock.patch("libra_tpu_torch.config.load_vision_tokenizer_config",
                        return_value=spec):
            lcfg, params, tok = _load_pretrained(str(d), SimpleTextTokenizer(cfg.vocab_size),
                                                 device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    img = tok.image_tokenizer
    if lcfg != small or img.cfg != vq_cfg or img.downsample_ratio is not None:
        raise AssertionError(f"loaded configs {lcfg}, {img.cfg} differ from those written")
    n = same_tree("decoder", params, src, torch.bfloat16)
    n += same_tree("vqgan", img.params, dict(vq_src, clip=clip_src), torch.float32)
    print(f"checkpoint: {n_bytes / 1e9:.3f} GB written in {write_s:.2f} s (config.json, "
          f"2 .bin shards of the {CKPT_LAYERS}-layer decoder, vqgan.ckpt with the "
          f"decoder at the default VQGANConfig and a loss.* key, the nested CLIP dir), "
          f"loaded in {load_s:.2f} s (warm page cache) through _load_pretrained: {n} "
          f"leaves bit for bit their sources (decoder bf16, CLIP and VQGAN fp32) [{card}]")

    pipe = LibraPipeline(lcfg, params, tok, functools.partial(maybe_normalize_pixels, vq_cfg))
    app = ServeApp(pipe, max_batch=B, max_len=ENGINE_MAX_LEN, prompt_bucket=ENGINE_BUCKET,
                   decode_chunk=ENGINE_CHUNK, max_new_default=SERVE_NEW)
    waves = recorded_waves(app)
    pixels = maybe_normalize_pixels(vq_cfg, torch.randint(
        0, 256, (vq_cfg.clip.image_size,) * 2 + (3,), generator=g, device=dev,
        dtype=torch.uint8)).cpu().numpy()
    try:
        zero_counts()
        answers = [app.handle({"prompt": QUESTIONS[0]}), app.handle(
            {"prompt": QUESTIONS[1], "pixels": pixels})]
        torch.cuda.synchronize()
        got = read_counts()
        main.update(got)
        replay_waves("checkpoint serve replay", app, waves, card)
    finally:
        app.close()
    # the source trees' engine, CLIP and VQGAN widened to fp32 as the loader
    # widens them (bit for bit the loaded leaves): each wave's tokens equal
    ref = ServingEngine(src, small, max_batch=B, max_len=ENGINE_MAX_LEN,
                        prompt_bucket=ENGINE_BUCKET, decode_chunk=ENGINE_CHUNK,
                        gen=app.gen, vq_params=widened(dict(vq_src, clip=clip_src)),
                        vq_cfg=vq_cfg)
    import numpy as np
    for kind, ((req,), (res,)) in zip(("text", "pixels"), waves):
        want = ref.run([req])[0]
        if not np.array_equal(want.tokens, res.tokens):
            raise AssertionError(f"checkpoint: the loaded trees answered the {kind} request "
                                 f"{res.tokens[0]}, the source trees {want.tokens[0]}")
    del ref
    if got["flash_bridged_attention"] != 2 * CKPT_LAYERS or len(waves) != 2 or any(
            a["text"] != app.text(res[0]) for a, (_, res) in zip(answers, waves)):
        raise AssertionError(f"checkpoint serve: launches {dict(got)}, waves "
                             f"{len(waves)}, answers {answers}")
    # text-to-image on the loaded trees against the source trees (one text
    # tokenizer, so the caption's ids agree): equal tokens, pixels bit for bit
    zero_counts()
    pixels, res, n = image_call(pipe, temperature=0.0)
    torch.cuda.synchronize()
    got_t2i = read_counts()
    main.update(got_t2i)
    assert_counts("checkpoint t2i", got_t2i,
                  t2i_counts(small, params, n, small.max_vision_token_length - 1), card)
    src_pipe = t2i_pipeline(small, src, vq_cfg, widened(dict(vq_src, clip=clip_src)),
                            tok.text_tokenizer)
    want_px, want, _ = image_call(src_pipe, temperature=0.0)
    del src_pipe
    if not (torch.equal(res.sequences, want.sequences) and np_finite(pixels)
            and (pixels == want_px).all()):
        raise AssertionError(f"checkpoint t2i: the loaded trees' image differs from the "
                             f"source trees': tokens equal "
                             f"{torch.equal(res.sequences, want.sequences)}, pixels "
                             f"max abs diff {abs(pixels - want_px).max()}")
    print(f"checkpoint t2i: generate_image (greedy) on the loaded trees: "
          f"{res.sequences.shape[-1] - n} tokens equal to the source trees', pixels "
          f"{pixels.shape} bit for bit; launches {dict(got_t2i)} [{card}]")
    out = dict(load_s=load_s, write_s=write_s, gb=n_bytes / 1e9,
               phase_s=time.perf_counter() - t_phase)
    print(f"checkpoint serve: a text and a pixels request through ServeApp over the "
          f"loaded trees ({[a['finish_reason'] for a in answers]}, "
          f"{[len(a['text'].split()) for a in answers]} words); both requests' tokens "
          f"equal to the source trees' engine, each wave equal to its replay; launches "
          f"{dict(got)}; phase {out['phase_s']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------

def train_batch(cfg, dev, image_size: int):
    """bench.py:607-627's batch: B=8, N=120+578, one image block at 8,
    random text ids and labels from numpy's RandomState(0), the image
    tokens' labels copied from the on-device encode (BOI's masked), every
    row unpadded; random uint8 images (336x336 for CLIP ViT-L/14-336). The first text label after
    the image is also masked, as the data layer masks it: the EOI position
    (vision) would predict it across modalities, a BIG_NEG logit that
    swamps the loss."""
    import numpy as np
    from libra_tpu_torch.training.fused import FusedBatch
    Mv, Q, V = cfg.max_vision_token_length, cfg.vision_codebook_num, cfg.vocab_size
    Bt, N = TRAIN_B, TRAIN_TEXT + cfg.max_vision_token_length
    rng = np.random.RandomState(0)
    vi = np.full((Bt, N), Mv, np.int64)
    vi[:, IMG_T:IMG_T + Mv] = np.arange(Mv)
    labels = rng.randint(3, V, size=(Q, Bt, N)).astype(np.int64)
    copy_mask = np.zeros((Bt, N), bool)
    copy_mask[:, IMG_T + 1:IMG_T + Mv] = True
    labels[:, :, IMG_T:IMG_T + Mv + 1] = -100
    text_ids = rng.randint(3, V, (Bt, N))
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    S = image_size

    def t(x):
        return torch.as_tensor(x, device=dev)

    return FusedBatch(
        pixels=torch.randint(0, 256, (Bt, S, S, 3), generator=g, device=dev,
                             dtype=torch.uint8),
        text_ids=t(text_ids), img_start=t(np.full((Bt,), IMG_T)),
        attention_mask=torch.ones((Bt, N), dtype=torch.int64, device=dev),
        vision_indices=t(vi), labels_static=t(labels), label_copy_mask=t(copy_mask),
        signal_ignore=torch.zeros((Bt,), dtype=torch.bool, device=dev))


def flops_per_token(params, mask) -> int:
    """bench.py:658-673's MFU convention: 6 P for trainable and 4 P for
    frozen matmul leaves (ndim >= 2; frozen leaves skip dL/dW), the
    embeddings left out."""
    from libra_tpu_torch.training.optimizer import leaves_with_paths
    train = dict(leaves_with_paths(mask))
    return sum((6 if train[p] else 4) * t.numel()
               for p, t in leaves_with_paths(params)
               if t.dim() >= 2 and "embed" not in p)


def train_policy(card: str, dev, cfg, vq_cfg, vq_params, batch, remat: str,
                 main_counts: Counter) -> dict:
    """One remat policy: a fresh state, a warm-up step, TRAIN_STEPS timed
    steps with every kernel count at zero before them; the checks."""
    from libra_tpu_torch.training.fused import make_fused_train_step
    from libra_tpu_torch.training.optimizer import (OptimizerConfig, leaves_with_paths,
                                                    make_optimizer, trainable_mask)
    from libra_tpu_torch.training.trainer import init_state
    opt_cfg = OptimizerConfig(frozen_language=True, total_steps=1000)
    params = decoder_params(cfg, dev)
    mask = trainable_mask(params, opt_cfg)
    opt = make_optimizer(opt_cfg, params)
    state = init_state(params, opt)
    step = make_fused_train_step(cfg, vq_cfg, opt, grad_mask=mask, remat=remat)
    leaves = dict(leaves_with_paths(params))
    train = dict(leaves_with_paths(mask))
    frozen0 = {p: t.clone() for p, t in leaves.items() if not train[p]}

    t0 = time.perf_counter()
    state, m = step(state, vq_params, batch)       # the warm-up: lr 0
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    train0 = {p: t.clone() for p, t in leaves.items() if train[p]}

    L = cfg.num_hidden_layers
    snapshots = nbytes(*frozen0.values(), *train0.values())
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, vq_params, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    got = read_counts()
    main_counts.update(got)
    want = Counter({k["name"]: 0 for k in KERNELS})
    want["flash_bridged_attention"] = TRAIN_STEPS * 2 * L     # forward + remat recompute
    want["flash_bridged_attention_bwd"] = TRAIN_STEPS * L
    assert_counts(f"train remat={remat} ({TRAIN_STEPS} steps, {L} layers)", got,
                  want, card)
    # the steps' peak, without this script's snapshots of the leaves
    peak_gb = (torch.cuda.max_memory_allocated() - snapshots) / 1e9

    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    changed = [p for p, t in frozen0.items() if not torch.equal(leaves[p], t)]
    # a bf16 leaf moves where an update exceeds half its ulp: the warm-up's
    # learning rates (2e-6 to 8e-6 a step here) cannot move a norm scale
    # of 1.0 (half an ulp: 2^-8), so an unmoved leaf must be a norm scale
    # whose first moment is nonzero (the gradient reached it)
    still = [p for p, t in train0.items() if torch.equal(leaves[p], t)]
    bad = [p for p in still if "norm" not in p.split("/")[-1]
           or not bool(state.opt_state.mu[p].abs().sum() > 0)]
    n_tok = batch.text_ids.numel()
    fpt = flops_per_token(params, mask)
    mfu = fpt * n_tok / dt / PEAK["bf16"]
    print(f"train remat={remat} L={L} B={TRAIN_B} N={batch.text_ids.shape[1]}: "
          f"{dt * 1e3:.3f} ms/step, {n_tok / dt:.1f} tokens/s, MFU {mfu:.4f} "
          f"({fpt / 1e9:.4f} GFLOP/token, against the dense bf16 peak 989 TFLOP/s), "
          f"peak memory {peak_gb:.3f} GB, "
          f"warm-up step {warm_s:.3f} s, loss {losses}, grad_norm {norms}; "
          f"{len(frozen0) - len(changed)} of {len(frozen0)} frozen leaves bitwise "
          f"unchanged, {len(train0) - len(still)} of {len(train0)} trainable "
          f"leaves moved, unmoved norm scales with live moments: "
          f"{[p for p in still if p not in bad]} [{card}]")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses}, {norms}")
    if changed:
        raise AssertionError(f"frozen leaves changed: {changed}")
    if bad:
        raise AssertionError(f"trainable leaves did not move: {bad}")
    if remat == "big_dots":
        profiled(card, f"train step remat={remat}",
                 lambda: step(state, vq_params, batch), rows=20)
    return dict(ms=dt * 1e3, tok_s=n_tok / dt, mfu=mfu, peak_gb=peak_gb,
                loss=losses, grad_norm=norms)


def train_vs_plain(card: str, dev, vq_cfg, vq_params) -> None:
    """Two layers at full width: loss and trainable gradients of one fused
    step's backward with the kernels against the same with every plain
    version patched in, without dropout and with dropout on every site but
    the attention probabilities (the same dropout key both ways, so the
    same masks); then with attn_pdrop on too, which must take the plain
    attention: no flash launch, a finite loss."""
    from libra_tpu_torch.config import LibraConfig
    from libra_tpu_torch.training.fused import fused_loss_fn
    from libra_tpu_torch.training.optimizer import OptimizerConfig, trainable_mask
    from libra_tpu_torch.training.trainer import masked_value_and_grad
    cfg = LibraConfig(num_hidden_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    params = decoder_params(cfg, dev)
    mask = trainable_mask(params, OptimizerConfig(frozen_language=True))
    batch = train_batch(cfg, dev, vq_cfg.clip.image_size)
    rates = dict(embd_pdrop=HARNESS_RATE, resid_pdrop=HARNESS_RATE,
                 vision_embd_pdrop=HARNESS_RATE, vision_resid_pdrop=HARNESS_RATE)

    def run(c, key):
        loss, grads = masked_value_and_grad(
            lambda p: fused_loss_fn(p, vq_params, c, vq_cfg, batch, remat="big_dots",
                                    dropout_key=key),
            params, mask)
        return loss.float(), {p: g.float() for p, g in grads.items()}

    for label, c, key in (("", cfg, None),
                          (f" with dropout {HARNESS_RATE}", cfg.replace(**rates),
                           (SEED, 0))):
        zero_counts()
        loss_k, g_k = run(c, key)
        got = read_counts()
        with plain_kernels():
            loss_p, g_p = run(c, key)
        torch.cuda.synchronize()
        if got["flash_bridged_attention_bwd"] != 2 or read_counts() != got:
            raise AssertionError("the kernel run must launch the kernels, the plain "
                                 "run none")
        rel_loss = abs((loss_k - loss_p).item()) / abs(loss_p.item())
        # per trainable leaf; a leaf whose reference gradient is exactly zero
        # (a low-rank A under a zero B) must be exactly zero with the kernels
        rel_g = {}
        for p, want in g_p.items():
            diff, ref = (g_k[p] - want).norm().item(), want.norm().item()
            rel_g[p] = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
        worst = sorted(rel_g.items(), key=lambda kv: -kv[1])
        print(f"train 2-layer step{label} vs the plain versions: loss "
              f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {rel_loss:.6g}, tol "
              f"{TRAIN_LOSS_TOL}); trainable gradients, relative L2 per leaf, worst "
              f"{worst[0][1]:.6g} (tol {TRAIN_GRAD_TOL}), {len(rel_g)} leaves: "
              + ", ".join(f"{p} {v:.4g}" for p, v in worst) + f" [{card}]")
        if not (rel_loss < TRAIN_LOSS_TOL and worst[0][1] < TRAIN_GRAD_TOL):
            raise AssertionError(f"the 2-layer training step{label} differs from the "
                                 "plain path")
    zero_counts()
    loss, _ = run(cfg.replace(attn_pdrop=HARNESS_RATE, **rates), (SEED, 0))
    got = read_counts()
    print(f"train 2-layer step with attn_pdrop {HARNESS_RATE} too: loss "
          f"{loss.item():.6f}, launches {dict(got)} (the plain attention: no flash "
          f"launch expected) [{card}]")
    if sum(got.values()) != 0 or not math.isfinite(loss.item()):
        raise AssertionError("attention dropout must take the plain attention")


def train_path(card: str, dev, vq_cfg, vq_params, main_counts: Counter) -> dict:
    from libra_tpu_torch.config import LibraConfig
    cfg = LibraConfig(num_hidden_layers=TRAIN_LAYERS, dtype="bfloat16",
                      param_dtype="bfloat16")
    batch = train_batch(cfg, dev, vq_cfg.clip.image_size)
    out = {}
    for remat in ("big_dots", "full"):
        out[remat] = train_policy(card, dev, cfg, vq_cfg, vq_params, batch, remat,
                                  main_counts)
        gc.collect()
        torch.cuda.empty_cache()
    train_vs_plain(card, dev, vq_cfg, vq_params)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The training entry point (phase 7b): train.run -> TrainHarness -> Trainer
# ---------------------------------------------------------------------------

class ChipPairs:
    """A map-style dataset of LAION-format pair samples without the JPEG
    decode: seeded uint8 336x336 images, CLIP-normalized in numpy, and
    seeded captions, each sample i2t or t2i by a seeded coin as
    LaionDataset's, its caption and label spans through caption_format
    (which tokenizes the caption with the run's text tokenizer, so word ids
    follow the sample order)."""

    def __init__(self, tokenizer, n: int, seed: int, num_img_tokens: int,
                 image_size: int, mean, std):
        import numpy as np
        self.tok, self.n, self.seed = tokenizer, n, seed
        self.num_img_tokens, self.size = num_img_tokens, image_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        import numpy as np
        from libra_tpu_torch.data import caption_format as cf
        rs = np.random.RandomState(self.seed * 1000 + i)
        img = rs.randint(0, 256, (self.size, self.size, 3), np.uint8)
        pixels = (img.astype(np.float32) / 255.0 - self.mean) / self.std
        caption_ = " ".join(HARNESS_WORDS[j] for j in rs.randint(
            0, len(HARNESS_WORDS), 8 + i % 9))
        ph = (" " + cf.IMG_PH) * self.num_img_tokens
        if rs.rand() < 0.5:
            bg, resp, kind = ph.strip(), caption_, "background"
            ins = cf.I2T_INSTRUCTION_LIST[rs.randint(len(cf.I2T_INSTRUCTION_LIST))]
        else:
            bg, resp, kind = caption_, ph.strip(), "respond"
            ins = cf.T2I_INSTRUCTION_LIST[rs.randint(len(cf.T2I_INSTRUCTION_LIST))]
        caption, ins_ = cf.build_caption(bg, resp, ins, kind)
        spans = cf.label_mask_spans(self.tok, caption, bg.strip(), ins_, kind)
        return {"vision": pixels, "language": caption,
                "label_mask_position_map": spans,
                "contiguous_ignore_sign": kind == "respond"}

    def collater(self, samples):
        from libra_tpu_torch.data.pair_samples import pair_collater
        return pair_collater(samples, with_return_loss=True)


def register_chip_pairs() -> None:
    """The "chip_pairs" builder: {"train": ChipPairs(...)} from its config's
    kwargs (n, seed; num_img_tokens and image_size default to libra-11b's
    578 and CLIP's 336)."""
    from libra_tpu_torch.config import CLIPVisionConfig
    from libra_tpu_torch.data.builders import BaseDatasetBuilder
    from libra_tpu_torch.registry import registry
    if "chip_pairs" in registry.list("builder"):
        return

    @registry.register_builder("chip_pairs")
    class ChipPairsBuilder(BaseDatasetBuilder):
        def build(self):
            clip = CLIPVisionConfig()
            kw = self.config.get("kwargs", {})
            return {"train": ChipPairs(self.tokenizer, kw["n"], kw["seed"],
                                       kw.get("num_img_tokens", 578),
                                       kw.get("image_size", clip.image_size),
                                       clip.image_mean, clip.image_std)}


def harness_config(out: str, layers: int, steps: int, rates: bool = True,
                   **run) -> dict:
    """The run config (the dict a YAML file would hold): libra-11b at
    full width and `layers` layers in bf16, frozen language, the CLIP
    ViT-L/14-336 tokenizer with its two taps (the 2048-wide signal), the
    chip_pairs dataset, libra_pretrain.yaml's run section cut to size."""
    drop = dict(embd_pdrop=HARNESS_RATE, resid_pdrop=HARNESS_RATE,
                vision_embd_pdrop=HARNESS_RATE, vision_resid_pdrop=HARNESS_RATE,
                attn_pdrop=0.0) if rates else {}
    return {
        "model": {"arch": "libra_train_wrapper",
                  "config": dict(num_hidden_layers=layers, dtype="bfloat16",
                                 param_dtype="bfloat16", **drop),
                  "model_kwargs": {"frozen_language": True},
                  "vqgan": {"select_layer": [-2, -1]}},
        "datasets": {"chip_pairs": {"kwargs": {"n": 64, "seed": SEED}}},
        "run": dict(dict(output_dir=out, max_steps=steps, learning_rate=1e-4,
                         warmup_ratio=0.05, weight_decay=0.01, max_grad_norm=1.0,
                         per_device_train_batch_size=HARNESS_B,
                         gradient_accumulation_steps=HARNESS_ACCUM,
                         logging_steps=1, eval_steps=0, save_steps=0,
                         save_total_limit=1, model_max_length=HARNESS_MAX_LEN,
                         seed=42, remat="full",
                         mesh={"data": 1, "fsdp": 1, "model": 1}), **run),
    }


@contextlib.contextmanager
def captured_steps(sink: list):
    """Record each Trainer.step_accum call's trainer and micro-batches."""
    from libra_tpu_torch.training.trainer import Trainer
    step_accum = Trainer.step_accum

    def wrapped(self, micros):
        sink.append((self, micros))
        return step_accum(self, micros)
    with mock.patch.object(Trainer, "step_accum", wrapped):
        yield


def train_run(cfg: dict, sink: list) -> dict:
    """train.run on the card, the steps recorded into `sink`; the logged
    metrics (metrics.jsonl) returned."""
    from libra_tpu_torch import train
    from libra_tpu_torch.run_config import RunConfig
    with captured_steps(sink):
        train.run(RunConfig.from_dict(cfg), device="cuda")
    torch.cuda.synchronize()
    out = Path(cfg["run"]["output_dir"]) / "metrics.jsonl"
    return [json.loads(line) for line in out.read_text().splitlines()]


def leaf_diffs(a, b) -> dict:
    """Relative L2 of every leaf of two trees (dicts of tensors)."""
    from libra_tpu_torch.training.optimizer import leaves_with_paths
    bl = dict(leaves_with_paths(b))
    return {p: ((t.float() - bl[p].float()).norm() / bl[p].float().norm().clamp_min(
        1e-30)).item() for p, t in leaves_with_paths(a)}


def same_state(label: str, a, b, card: str) -> bool:
    """Parameters and moments of two TrainStates bit for bit; else every
    leaf within TRAIN_GRAD_TOL, the differences printed."""
    from libra_tpu_torch.training.optimizer import leaves_with_paths
    trees = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    pairs = [(t, ys[p]) for x, ys in ((x, dict(leaves_with_paths(y)))
                                      for x, y in trees)
             for p, t in leaves_with_paths(x)]
    n = len(pairs)
    if a.step == b.step and all(torch.equal(t, u) for t, u in pairs):
        print(f"{label}: {n} leaves (parameters and moments) bit for bit equal, "
              f"step {a.step} [{card}]")
        return True
    worst = max(max(leaf_diffs(x, y).values()) for x, y in trees)
    print(f"{label}: NOT bit for bit; worst leaf relative L2 {worst:.6g} (tol "
          f"{TRAIN_GRAD_TOL}) [{card}]")
    if not (worst < TRAIN_GRAD_TOL and a.step == b.step):
        raise AssertionError(f"{label}: the states differ")
    return False


def harness_resume(card: str, tmp: str) -> dict:
    """CKPT_LAYERS layers at full width, dropout on: HARNESS_STEPS steps
    straight against HARNESS_STEPS / 2 steps, a save, and a fresh run that
    resumes and takes the rest; losses and leaves bit for bit. Then the
    checkpoint's bytes and a timed save and restore of the state."""
    from libra_tpu_torch import checkpoint as ckpt
    half = HARNESS_STEPS // 2
    straight, first, resumed = [], [], []
    want = train_run(harness_config(f"{tmp}/straight", CKPT_LAYERS, HARNESS_STEPS),
                     straight)
    train_run(harness_config(f"{tmp}/resume", CKPT_LAYERS, half, save_steps=half),
              first)
    got = train_run(harness_config(f"{tmp}/resume", CKPT_LAYERS, HARNESS_STEPS,
                                   resume_from_checkpoint=True), resumed)
    del first[:]
    if len(resumed) != HARNESS_STEPS - half:
        raise AssertionError(f"the resumed run took {len(resumed)} steps")
    losses = [(r["loss"], r["grad_norm"]) for r in want if "loss" in r]
    losses_r = [(r["loss"], r["grad_norm"]) for r in got if "loss" in r]
    print(f"harness resume, {CKPT_LAYERS} layers: losses and grad norms straight "
          f"{losses}, saved at {half} then resumed {losses_r} [{card}]")
    a, b = straight[-1][0].state, resumed[-1][0].state
    bitwise = same_state("harness resume state", b, a, card)
    if losses_r != losses:
        rel = max(abs(x - y) / abs(y) for (x, _), (y, _) in zip(losses_r, losses))
        print(f"harness resume: losses not bit for bit, worst relative {rel:.6g} "
              f"(tol {TRAIN_LOSS_TOL}) [{card}]")
        if rel >= TRAIN_LOSS_TOL or len(losses_r) != len(losses):
            raise AssertionError("the resumed run's losses differ")
        bitwise = False
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(f"{tmp}/timed", a, step=HARNESS_STEPS)
    write_s = time.perf_counter() - t0
    n_bytes = (path / ckpt.STATE_FILE).stat().st_size
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(f"{tmp}/timed", b, step=HARNESS_STEPS)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same_state("harness restore into the resumed state", b, a, card)
    print(f"harness checkpoint, {CKPT_LAYERS} layers: {n_bytes / 1e9:.4f} GB "
          f"(parameters, moments, counts, step), written in {write_s:.3f} s, read "
          f"into the state's tensors in {read_s:.3f} s (the file cache warm) [{card}]")
    return dict(bitwise=bitwise, gb=n_bytes / 1e9, write_s=write_s, read_s=read_s)


def harness_path(card: str, main_counts: Counter) -> dict:
    """train.run at full width, HARNESS_LAYERS layers, dropout on, with
    accumulation: launches against the config's, timing, tokens/s, peak
    memory, a profiled step; then the resume check, one update_ema over
    the tree, and a debug_model run."""
    import tempfile
    from libra_tpu_torch import train
    from libra_tpu_torch.run_config import RunConfig
    from libra_tpu_torch.training.ema import init_ema, update_ema
    t_phase = time.perf_counter()
    register_chip_pairs()
    L, A, n = HARNESS_LAYERS, HARNESS_ACCUM, HARNESS_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        steps = []
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        log = train_run(harness_config(f"{tmp}/main", L, n), steps)
        run_s = time.perf_counter() - t0
        got = read_counts()
        main_counts.update(got)
        want = Counter({k["name"]: 0 for k in KERNELS})
        want["flash_bridged_attention"] = n * L * A * 2        # forward + remat recompute
        want["flash_bridged_attention_bwd"] = n * L * A
        assert_counts(f"harness train.run ({n} steps, {L} layers, {A} micro-batches "
                      f"of {HARNESS_B})", got, want, card)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [r for r in log if "loss" in r]
        losses = [r["loss"] for r in rows]
        if len(rows) != n or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"harness: logged {rows}")
        # steps after the first (its cuBLAS and allocator warm-up)
        step_s = [1.0 / r["steps_per_sec"] for r in rows[1:]]
        tokens = [sum(int(mb["attention_mask"].sum()) for mb in micros)
                  for _, micros in steps]
        tok_s = sum(tokens[1:]) / sum(step_s)
        trainer, micros = steps[-1]
        prof = {}
        profiled(card, f"harness step ({L} layers, {A} x {HARNESS_B} samples)",
                 lambda: trainer.step_accum(micros), rows=12, out=prof)
        widths = sorted({tuple(mb["input_ids"].shape) for _, ms in steps for mb in ms})
        print(f"harness train.run, {L} layers at full width, dropout {HARNESS_RATE} "
              f"(embd, resid, vision_*), accumulation {A} x {HARNESS_B}: run "
              f"{run_s:.3f} s (model build, data, {n} steps), ms/step "
              f"{[f'{x * 1e3:.3f}' for x in step_s]} (steps 2-{n}: wall between "
              f"logging steps, the micro-batches' CLIP + LFQ included), training "
              f"tokens/s {tok_s:.1f} ({tokens} unpadded tokens a step), peak memory "
              f"{peak_gb:.3f} GB, losses {losses}, micro-batch ids {widths} "
              f"[{card}]")
        ema = init_ema(trainer.state.params)
        ema = update_ema(ema, trainer.state.params)
        torch.cuda.synchronize()
        if ema.count != 1:
            raise AssertionError("update_ema")
        del steps, trainer, micros, ema
        gc.collect()
        torch.cuda.empty_cache()
        resume = harness_resume(card, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        dbg = harness_config(f"{tmp}/debug", 1, 2)
        dbg["model"] = {"arch": "debug_model"}
        train.run(RunConfig.from_dict(dbg), device="cuda")
    phase_s = time.perf_counter() - t_phase
    print(f"harness phase: {phase_s:.1f} s [{card}]")
    return dict(step_ms=statistics.mean(step_s) * 1e3, tok_s=tok_s, peak_gb=peak_gb,
                device_ms=prof["device_ms"], wall_ms=prof["wall_ms"],
                phase_s=phase_s, **resume)


# ---------------------------------------------------------------------------
# The int4 decode-matvec experiment (B6)
# ---------------------------------------------------------------------------

def exp_int4_modes():
    """Phase 8's cases: (kernel name, tag, kernel, plain version, bp, the
    template it takes, its chunked template alone). A kernel's first case
    gives its times in the report."""
    from libra_tpu_torch.ops import int4_exp as E
    P = functools.partial
    modes = [("int4_exp_d", " wdt=int32", P(E.int4_exp_d, wdt=torch.int32),
              E.int4_exp_d_plain, EXP_BP, E.int4_exp_template,
              P(int4_exp_chunked, mode=0, w16=0)),
             ("int4_exp_d", " wdt=int16", P(E.int4_exp_d, wdt=torch.int16),
              E.int4_exp_d_plain, EXP_BP, E.int4_exp_template,
              P(int4_exp_chunked, mode=0, w16=1)),
             ("int4_exp_c", "", E.int4_exp_c, E.int4_exp_c_plain, EXP_BP,
              E.int4_exp_template, P(int4_exp_chunked, mode=1, w16=0)),
             ("int4_exp_e", "", E.int4_exp_e, E.int4_exp_a8_plain, EXP_BP,
              E.int4_exp_a8_template, P(int4_exp_a8_chunked, bp=EXP_BP, i8mask=1,
                                        low_only=0))]
    for body, bp, i8mask in (("h", 8, False), ("h", 8, True), ("f", 8, False),
                             ("f", 8, True), ("f", 32, False)):
        modes.append(("int4_exp_a8", f" body={body} bp={bp} i8mask={i8mask}",
                      P(E.int4_exp_a8, body=body, bp=bp, i8mask=i8mask),
                      P(E.int4_exp_a8_plain, bp=bp), bp, P(E.int4_exp_a8_template, bp=bp),
                      P(int4_exp_a8_chunked, bp=bp, i8mask=int(i8mask),
                        low_only=int(body == "f"))))
    return modes


def int4_exp_chunked(x, packed, scales, li, group, mode, w16):
    """D (mode 0; w16: the int16 unpack) or C (mode 1) on the chunked
    template alone: the C function int4_exp_chunked, with int4_exp's
    arguments (the parent's kernel)."""
    from libra_tpu_torch.ops import int4_exp as E
    return E._run("int4_exp_chunked", E.SOURCE, "int4_exp_chunked", E._ARGTYPES, x,
                  packed, scales, li, group, E.BP, mode, w16)


def int4_exp_a8_chunked(x, packed, scales, li, group, bp, i8mask, low_only):
    """The W4A8 function on the chunked template alone (i8mask: the unpack
    on whole words; low_only: F's low-nibble sums): the C function
    int4_exp_a8_chunked, with int4_exp_a8's arguments (the parent's
    kernel)."""
    from libra_tpu_torch.ops import int4_exp as E
    return E._run("int4_exp_a8_chunked", E.SOURCE, "int4_exp_a8_chunked", E._ARGTYPES_A8,
                  x, packed, scales, li, group, bp, bp, i8mask, low_only)


def check_exp_int4(card: str, dev) -> dict:
    """D (both unpack widths), C and the W4A8 kernels (every unpack mode)
    against their plain versions in fp32 (TF32 off) on random bytes and
    scales, at layers 0 and L - 1 of the stacked buffer, on 7 rows of x
    with an all-zero third row (the kernels' 8-row path) at layer L // 2,
    and on its first 1 and 2 rows at layers 1 and L - 2, then at M = 1 and
    2 on K = 2816 and 11008 (an odd count of units a block's K slice); rows
    >= M and the zero row exactly 0. Every kernel takes its decode
    template there (the script raises otherwise), and its chunked template
    is checked alone in the same way. Timed at M = 4 on layers rotating
    over the 8 (8 x 23.9 MB exceed the 50 MB L2), beside the library's
    weight-only int4 call; each chunked template timed beside its decode
    one; B5's W4A8 decode template at the same shape beside the W4A8
    rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    K, O, L, G, M = EXP_K, EXP_O, EXP_L, EXP_G, EXP_M
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    packed = torch.randint(-128, 128, (L, K // 2, O), generator=g, device=dev,
                           dtype=torch.int8)
    scales = torch.rand((L, K // G, O), generator=g, device=dev) * 2e-2
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    x7 = torch.randn((7, K), generator=g, device=dev).to(torch.bfloat16)
    x7[2] = 0
    cases = [(packed, scales, li, xx, zero_rows)
             for li, xx, zero_rows in ((0, x, []), (L - 1, x, []), (L // 2, x7, [2]),
                                       (1, x[:1], []), (L - 2, x[:2], []))]
    for k in EXP_ODD_K:   # an odd count of units a K slice, at M = 1 and 2
        po = torch.randint(-128, 128, (1, k // 2, EXP_ODD_O), generator=g, device=dev,
                           dtype=torch.int8)
        so = torch.rand((1, k // G, EXP_ODD_O), generator=g, device=dev) * 2e-2
        xo = torch.randn((2, k), generator=g, device=dev).to(torch.bfloat16)
        cases += [(po, so, 0, xo[:1], []), (po, so, 0, xo, [])]
    lib_ms = int4_library_ms(x, packed, scales, G, card)
    report = {}
    b5_ms = b5_w4a8(x, packed, scales, card)
    for name, tag, kernel, plain, bp, template_of, chunked in exp_int4_modes():
        errs = []
        for pk, sc, li, xx, zero_rows in cases:
            want = plain(xx, pk, sc, li, G)
            tol = EXP_TOL * want.abs().max().item()
            rows, k, o = xx.shape[0], xx.shape[1], pk.shape[2]
            template = template_of(xx, pk, sc, li, G)
            if template != "decode":
                raise AssertionError(f"{name}{tag} M={rows} K={k}: took the {template} "
                                     f"template")
            for fn, which in ((kernel, f" [{template}]"), (chunked, " [chunked alone]")):
                got = fn(xx, pk, sc, li, G)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                print(f"{name}{tag}{which} layer {li} M={rows} K={k} O={o}: max_abs_err "
                      f"{err:.6g} (tol {tol:.6g}: 1e-4 of max|ref|, fp32 sums in another "
                      f"order) [{card}]")
                zero = got[[*zero_rows, *range(rows, bp)]]
                if not (bool(torch.isfinite(got).all()) and err <= tol
                        and tuple(got.shape) == (bp, o) and bool((zero == 0).all())):
                    raise AssertionError(f"{name}{tag}{which}: the kernel disagrees with "
                                         f"its plain version")
                errs.append(err)
        turn = itertools.cycle(range(L))
        ms = cuda_ms(lambda: kernel(x, packed, scales, next(turn), G))
        plain_ms = cuda_ms(lambda: plain(x, packed, scales, next(turn), G))
        chunked_ms = cuda_ms(lambda: chunked(x, packed, scales, next(turn), G))
        # the packed bytes, the scales, x and the (bp, O) fp32 result; the
        # products of the bp rows the function computes (W4A8: int8 ones)
        a8 = name in ("int4_exp_e", "int4_exp_a8")
        bnd = bound(nbytes(x, packed[0], scales[0], got), 2 * bp * K * O,
                    "int8" if a8 else "bf16")
        # no library call computes W4A8 with group scales; the nearest,
        # weight-only one is printed beside it
        lib = (f"no library call computes W4A8; nearest, weight-only "
               f"torch._weight_int4pack_mm {lib_ms} ms; B5's W4A8 decode template "
               f"{b5_ms:.4f} ms" if a8 else f"library {lib_ms} ms")
        extra = (f", chunked template {chunked_ms:.4f} ms "
                 f"({bnd['bound_ms'] / chunked_ms:.1%} of the bound)")
        print(f"{name}{tag}: kernel {ms:.4f} ms "
              f"({nbytes(packed[0]) / ms / 1e6:.0f} GB/s over the packed bytes, "
              f"{bnd['bound_ms'] / ms:.1%} of the bound){extra}, plain {plain_ms:.4f} ms, "
              f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}; the weights and "
              f"scales alone {nbytes(packed[0], scales[0]) / HBM_BPS * 1e3:.5f} ms), "
              f"{lib} [{card}]")
        row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                   library_ms=None if a8 else lib_ms, **bnd)
        if name in report:    # the first case's times, the largest error
            row = dict(report[name], max_abs_err=max(report[name]["max_abs_err"],
                                                     row["max_abs_err"]))
        report[name] = row
    return report


def b5_w4a8(x, packed, scales, card) -> float:
    """B5 (int4_matmul, a8=True) on the experiment's weights, which share
    its byte layout: the same W4A8 function with a bf16 result, on its
    decode template (the script raises otherwise), held to
    int4_exp_a8_plain's live rows within bf16 rounding, and timed on the
    layers rotated as the experiment's kernels are."""
    from libra_tpu_torch.ops.int4_exp import int4_exp_a8_plain
    from libra_tpu_torch.ops.int4_matmul import int4_matmul
    L, G, M = packed.shape[0], EXP_G, x.shape[0]
    template = int4_template(x, packed[0], scales[0], G)
    if template != "decode":
        raise AssertionError(f"int4_matmul a8 M={M}: took the {template} template")
    got = int4_matmul(x, packed[0], scales[0], group=G, a8=True)
    torch.cuda.synchronize()
    check(f"int4_matmul a8=True [{template}] at the experiment's shape, M={M}", got,
          int4_exp_a8_plain(x, packed, scales, 0, G)[:M], card)
    turn = itertools.cycle(range(L))

    def call():
        i = next(turn)
        return int4_matmul(x, packed[i], scales[i], group=G, a8=True)
    ms = cuda_ms(call)
    print(f"int4_matmul a8=True (B5's W4A8 decode template) at K={EXP_K} O={EXP_O} "
          f"M={M}: {ms:.4f} ms [{card}]")
    return ms


def int4_library_ms(x, packed, scales, group, card):
    """torch._weight_int4pack_mm, x @ ((u - 8) * scale + zero) with its
    own packing of the unsigned nibbles u = q + 8 (high nibble first) and
    bf16 scales, zero points 0: the weight-only function with the scales
    rounded to bf16, on the layers rotated as the kernels' are. None, with
    the reason printed, where this build has no such call on the card or
    it disagrees."""
    from libra_tpu_torch.ops.int4_matmul import unpack_int4
    L = packed.shape[0]
    try:
        ws, szs = [], []
        for l in range(L):
            u = (unpack_int4(packed[l]) + 8).t().contiguous()         # (O, K)
            ws.append(torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8))
            s = scales[l].to(torch.bfloat16)
            szs.append(torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous())
            del u
        got = torch._weight_int4pack_mm(x, ws[0], group, szs[0])
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError, TypeError) as e:
        print(f"torch._weight_int4pack_mm unavailable on the card: "
              f"{str(e).splitlines()[0][:160]} [{card}]")
        return None
    w = unpack_int4(packed[0]).float() * torch.repeat_interleave(
        scales[0].to(torch.bfloat16).float(), group, dim=0)
    want = x.float() @ w
    err = (got.float() - want).abs().max().item()
    if not err <= bf16_tol(want) * 4:
        print(f"torch._weight_int4pack_mm disagrees (max_abs_err {err:.6g}); "
              f"not timed [{card}]")
        return None
    print(f"torch._weight_int4pack_mm: max_abs_err {err:.6g} against x @ the "
          f"weights with bf16 scales [{card}]")
    turn = itertools.cycle(range(L))

    def call():
        i = next(turn)
        return torch._weight_int4pack_mm(x, ws[i], group, szs[i])
    return cuda_ms(call)


def exp_int4_path(card: str, main_counts: Counter) -> None:
    """The experiment's entry point with all 21 rows, each kernel's count
    at zero before it; each of the experiment's kernels must have
    launched."""
    from libra_tpu_torch.tools import exp_int4
    zero_counts()
    t0 = time.perf_counter()
    rows = exp_int4.main([])
    torch.cuda.synchronize()
    got = read_counts()
    main_counts.update(got)
    nbytes_int4 = EXP_K * EXP_O // 2
    print(f"exp_int4 main([]): {len(rows)} rows in {time.perf_counter() - t0:.1f} s, "
          f"launches {dict(got)} [{card}]")
    print("exp_int4 rows (rel err, ms, GB/s over the packed int4 bytes; int8 over "
          "its int8 bytes): " + "; ".join(
              f"{r} {v['err']:.3g} {v['ms']:.4f} ms "
              f"{(2 if r == 'int8' else 1) * nbytes_int4 / v['ms'] / 1e6:.0f} GB/s"
              for r, v in rows.items()) + f" [{card}]")
    if set(rows) != set(exp_int4.ROWS) or len(rows) != 21:
        raise AssertionError(f"exp_int4 ran {sorted(rows)}, not all 21 rows")
    idle = [k["name"] for k in KERNELS
            if k["module"] == "libra_tpu_torch.ops.int4_exp" and got[k["name"]] == 0]
    if idle:
        raise AssertionError(f"the experiment did not launch {idle}")


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
    # and at a chat turn's text delta: 64 query rows at slot 672 of 1024
    delta = check_flash_delta(card, dev)
    report["flash_bridged_attention"].update(
        {f"delta_{k}": delta[True][k] for k in ("ms", "plain_ms", "bound_ms")},
        delta_library_ms=delta[False]["library_ms"], delta_unbridged_ms=delta[False]["ms"],
        max_abs_err=max(report["flash_bridged_attention"]["max_abs_err"],
                        *(r["max_abs_err"] for r in delta.values())))
    # and at the t2i prompt pass: B = 1, Nq = 13, its cache of Nq + 578 keys
    t2i = check_flash_t2i(card, dev)
    main_t2i = t2i[max(t2i)]
    report["flash_bridged_attention"].update(
        {f"t2i_{k}": main_t2i[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        max_abs_err=max(report["flash_bridged_attention"]["max_abs_err"],
                        *(r["max_abs_err"] for r in t2i.values())))
    report["flash_bridged_attention_bwd"] = check_flash_bwd(card, dev)
    mm = check_matmuls(card, dev)
    da = check_decode_attention(card, dev)
    chat_da = check_decode_delta(card, dev)
    da += chat_da
    # the JSON line's times: the decode shapes (M = 4, 4096 -> 11008; N = 1
    # with the bridge, S = 674); its error: the largest over every case
    for name, rows, pick in (
            ("int8_matmul", mm["int8_matmul"], dict(M=4, F=11008, tag="")),
            ("int4_matmul", mm["int4_matmul"], dict(M=4, F=11008, tag=" a8=True")),
            ("int8_decode_attention", da, dict(N=1, bridge=True, S=S_DECODE))):
        row = next(r for r in rows if all(r[k] == v for k, v in pick.items()))
        report[name] = dict(
            {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            max_abs_err=max(r["max_abs_err"] for r in rows))
        if name != "int8_decode_attention":
            # and the split prompt pass's rows: M = 128, 4096 -> 11008, the
            # rows template beside the chunked one (the parent's kernel)
            split = next(r for r in rows if all(
                r[k] == v for k, v in dict(pick, M=M_SPLIT).items()))
            report[name].update({f"rows_{k}": split[k] for k in (
                "ms", "chunked_ms", "plain_ms", "bound_ms", "library_ms")})
            # and the merged chunk's packed rows, M = 68, and a spec verify
            # pass's, M = 16, in the main path's mode (int4: W4A8, which no
            # library call computes)
            for key, m in (("packed", M_PACKED), ("verify", M_VERIFY)):
                row = next(r for r in rows if all(r[k] == v for k, v in dict(
                    pick, M=m).items()))
                report[name].update({f"{key}_{k}": row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms")})
    # and the chat deltas' wide template: N = 64 at slot 672 of S = 1024;
    # and a spec verify pass's decode template, N = SPEC_GAMMA + 1
    verify = next(r for r in da if all(r.get(k) == v for k, v in dict(
        N=SPEC_GAMMA + 1, bridge=True, S=S_DECODE).items()))
    report["int8_decode_attention"].update(
        {f"chat_{k}": chat_da[0][k] for k in ("ms", "plain_ms", "bound_ms")},
        **{f"verify_{k}": verify[k] for k in ("ms", "bound_ms")})

    from libra_tpu_torch.config import LibraConfig, VQGANConfig
    from libra_tpu_torch.models import vqgan
    cfg = LibraConfig(dtype="bfloat16", param_dtype="bfloat16")
    vq_cfg = VQGANConfig(select_layer=(-2, -1))
    if vq_cfg.clip_feature_dim != cfg.contiguous_signal_size:
        raise ValueError("the CLIP taps must give contiguous_signal_size channels")
    with torch.no_grad():
        vq_params = vqgan.init_params(torch.Generator(device=dev).manual_seed(SEED),
                                      vq_cfg, dev, torch.bfloat16)
    # the encode side in bf16 (the fused prompt pass's CLIP), the decode
    # side (post_quant_conv, the conv decoder) in fp32, as libra_tpu's
    vq_params.update({k: widened(vq_params[k]) for k in ("post_quant_conv", "decoder")})
    L = cfg.num_hidden_layers
    print(f"launches per text decode step in a quantized tree: 7 projections x "
          f"{L} layers + lm_head = {7 * L + 1} matmul launches; with the int8 "
          f"cache, {L} decode-attention launches (1 a layer) [{card}]")
    main_counts = Counter()
    fused, chat, engine, spec, serve, t2i = {}, {}, {}, {}, {}, {}
    for mode in ("bf16", "int8", "int4"):
        (n_prompt, fused[mode], chat[mode], engine[mode], spec[mode], serve[mode],
         t2i[mode]) = full_path(card, dev, cfg, vq_cfg, vq_params, mode, main_counts)
        if n_prompt != NQ:
            raise AssertionError(f"prompt length {n_prompt}, expected {NQ}")
        torch.cuda.empty_cache()
    print(f"spec summary (gamma {SPEC_GAMMA}; decode tok/s standard, bigram, oracle "
          "drafts; tokens a row a verify iteration, bigram and oracle; a verify "
          "iteration's device / wall ms; phase s): " + "; ".join(
              f"{mode} {v['std_tok_s']:.3f}, {v['bigram']['tok_s']:.3f}, "
              f"{v['oracle']['tok_s']:.3f}; {v['bigram']['tok_per_iter']:.4f}, "
              f"{v['oracle']['tok_per_iter']:.4f}; {v['verify_device_ms']:.3f} / "
              f"{v['verify_wall_ms']:.3f}; {v['phase_s']:.1f}" for mode, v in spec.items())
          + f" [{card}]")
    img = t2i["bf16"]
    print(f"t2i summary: bf16 {T2I_IMAGE_LAYERS} layers, one image (top-k 100, "
          f"temperature 1): TTFT {img['ttft_ms']:.3f} ms, image tokens/s "
          f"{img['tok_s']:.3f} ({cfg.max_vision_token_length - 1} / (wall - TTFT)), VQGAN "
          f"decode {img['decode_ms']:.3f} ms (TF32 vs off {img['tf32_rel']:.3g}), call wall "
          f"{img['wall_s']:.3f} s, peak {img['peak_gb']:.3f} GB, {T2I_PROFILED} dual steps "
          f"{img['steps_device_ms']:.3f} ms device / {img['steps_wall_ms']:.3f} ms wall; "
          f"{T2I_LAYERS}-layer greedy: " + "; ".join(
              f"{mode} {v['same']} tokens before the first difference with the plain "
              f"versions, {v['ties']} near ties, logits "
              + ", ".join(f"{r:.4g}" for r in v['rel'].values()) + f", {v['call_s']:.2f} s a "
              f"call, phase {v['phase_s']:.1f} s" for mode, v in t2i.items()) + f" [{card}]")
    img2 = t2i["bf16"]["2d"]
    print(f"2d summary: bf16 {TWOD_IMAGE_LAYERS}-layer image (2D prediction + 2D RoPE, "
          f"greedy): TTFT {img2['image']['ttft_ms']:.3f} ms, image tokens/s "
          f"{img2['image']['tok_s']:.3f}, call wall {img2['image']['wall_s']:.3f} s, a dual "
          f"step {img2['image']['step_device_ms']:.3f} ms device / "
          f"{img2['image']['step_wall_ms']:.3f} ms wall, {img2['image']['same']} tokens "
          f"before the first difference with the plain versions; bf16 "
          f"{cfg.num_hidden_layers}-layer 2D-RoPE fused VQA: TTFT "
          f"{img2['vqa']['ttft_ms']:.3f} ms, decode {img2['vqa']['tok_s']:.3f} tok/s; "
          "2 layers (VQA rows, chat rows equal; image tokens before a difference, near "
          "ties; phase s): " + "; ".join(
              f"{mode} {v['2d']['small']['vqa_rows_equal']}, "
              f"{v['2d']['small']['chat_rows_equal']}; {v['2d']['small']['image_same']}, "
              f"{v['2d']['small']['image_ties']}; {v['2d']['phase_s']:.1f}"
              for mode, v in t2i.items()) + f" [{card}]")
    print("fused summary (TTFT ms, decode tok/s): " + "; ".join(
        f"{mode} split {k} {v['ttft_ms']:.3f} / {v['tok_s']:.3f}"
        for mode, runs in fused.items() for k, v in runs.items()) + f" [{card}]")
    print("chat summary (TTFT ms turns 1, 2, 3; the Generator re-prefilling turn 2's "
          "history; turn-2 decode tok/s; turn-2 delta pass device ms; peak GB; phase s): "
          + "; ".join(f"{mode} {', '.join(f'{t:.3f}' for t in v['ttft_ms'])}; "
                      f"{v['reprefill_ms']:.3f}; {v['tok_s']:.3f}; {v['delta_device_ms']:.3f}; "
                      f"{v['peak_gb']:.3f}; {v['phase_s']:.1f}" for mode, v in chat.items())
          + f" [{card}]")
    print("engine summary (open loop: TTFT p50 / p95 ms, tokens/s, requests/s; "
          "chunk wall / device ms; refill; phase s): " + "; ".join(
              f"{mode} {v['ttft_p50_ms']:.3f} / {v['ttft_p95_ms']:.3f}, "
              f"{v['tok_s']:.3f}, {v['req_s']:.4f}; {v['chunk_wall_ms']:.3f} / "
              f"{v['chunk_device_ms']:.3f}; k = 1 refill {v['refill_device_ms']:.3f} ms "
              f"device; {v['phase_s']:.1f}"
              for mode, v in engine.items()) + f" [{card}]")
    print("merged summary (merged chunk device ms / iterations; installs; installed "
          "requests' TTFT p50 / p95 ms, merged then dedicated; generated tokens/s, "
          "merged then dedicated): " + "; ".join(
              f"{mode} {m['chunk_device_ms']:.3f} / {m['km']}, "
              f"{m['installs']}; {m['ttft_ms'][0]:.3f} / {m['ttft_ms'][1]:.3f} vs "
              f"{m['ded_ttft_ms'][0]:.3f} / {m['ded_ttft_ms'][1]:.3f}; {m['tok_s']:.3f} vs "
              f"{m['ded_tok_s']:.3f}"
              for mode, m in ((mode, v["merged"]) for mode, v in engine.items()))
          + f" [{card}]")
    print("serve summary, smoke figures of 5 requests (requests/s; TTFT p50 ms from each "
          "request's send; the SSE stream's first event ms; phase s): " + "; ".join(
              f"{mode} {v['req_s']:.4f}; {v['ttft_p50_ms']:.3f}; {v['first_event_ms']:.3f}; "
              f"{v['phase_s']:.1f}" for mode, v in serve.items()) + f" [{card}]")
    ckpt = checkpoint_path(card, dev, cfg, vq_cfg, vq_params, main_counts)
    print(f"checkpoint summary: {ckpt['gb']:.3f} GB written in {ckpt['write_s']:.2f} s, "
          f"loaded in {ckpt['load_s']:.2f} s; phase {ckpt['phase_s']:.1f} s [{card}]")
    torch.cuda.empty_cache()
    train = train_path(card, dev, vq_cfg, vq_params, main_counts)
    print("train summary: " + "; ".join(
        f"remat={r}: {v['ms']:.3f} ms/step, {v['tok_s']:.1f} tokens/s, MFU "
        f"{v['mfu']:.4f}, peak {v['peak_gb']:.3f} GB" for r, v in train.items())
          + f" [{card}]")
    harness = harness_path(card, main_counts)
    print(f"harness summary: train.run {HARNESS_LAYERS} layers, {HARNESS_ACCUM} x "
          f"{HARNESS_B} samples a step, dropout {HARNESS_RATE}: {harness['step_ms']:.3f} "
          f"ms/step wall, a profiled step {harness['wall_ms']:.3f} ms wall / "
          f"{harness['device_ms']:.3f} ms device, {harness['tok_s']:.1f} training "
          f"tokens/s, peak {harness['peak_gb']:.3f} GB; {CKPT_LAYERS}-layer resume "
          f"{'bit for bit' if harness['bitwise'] else 'within tolerance'}, checkpoint "
          f"{harness['gb']:.4f} GB written in {harness['write_s']:.3f} s, read in "
          f"{harness['read_s']:.3f} s; phase {harness['phase_s']:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    report.update(check_exp_int4(card, dev))
    exp_int4_path(card, main_counts)
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
