"""Profile the fused-pixels VQA prompt pass (the TTFT hot path).

    python -m libra_tpu_torch.tools.profile_prefill OUT_DIR [--no-a8]
        [--device cuda]

libra-11b at full width and depth, the tree quantized to int8 on the
card, B = 4 rows of 32 text ids with one 336 x 336 uint8 image each at
position 8 (CLIP + LFQ inside the prompt pass), the int8 KV cache and the
w8a8 prompt pass (bf16 activations with --no-a8), max_new_tokens = 1.
Prints the steady TTFT, then writes one profiled run's chrome trace to
OUT_DIR/prefill.json (``python -m libra_tpu_torch.tools.parse_trace
OUT_DIR``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from libra_tpu_torch.tools.profiling import (decoder_params, example_batch,
                                             flagship_cfg, timed, trace, vq_tree)

B, TEXT_LEN, IMG_START, LAYERS, BITS = 4, 32, 8, 32, 8


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("profile the fused VQA prompt pass")
    parser.add_argument("out_dir")
    parser.add_argument("--no-a8", dest="a8", action="store_false",
                        help="a bf16-activation prompt pass")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from libra_tpu_torch.generation import GenerationConfig, Generator
    dev = torch.device(args.device)
    cfg = flagship_cfg(LAYERS)
    params = decoder_params(cfg, dev, BITS)
    vq_cfg, vq_params = vq_tree(dev)
    print("params ready", flush=True)
    ids, mask, vi, _ = example_batch(cfg, B=B, text_len=TEXT_LEN)
    pixels = np.random.RandomState(0).randint(
        0, 256, size=(B, 336, 336, 3)).astype(np.uint8)
    inputs = {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
              "pixels": pixels, "img_start": np.full((B,), IMG_START)}
    g = Generator(params, cfg, vq_params=vq_params, vq_cfg=vq_cfg)
    gen1 = GenerationConfig(max_new_tokens=1, eos_token_id=-1, kv_quant=True,
                            a8_prefill=args.a8)
    with torch.inference_mode():
        run = lambda: g(inputs, gen1).sequences    # noqa: E731
        timed(run, dev)
        print("warm", flush=True)
        print(f"steady TTFT: {timed(run, dev) * 1e3:.1f} ms", flush=True)
        path = trace(run, args.out_dir, "prefill", dev)
    print(f"trace -> {path}", flush=True)


if __name__ == "__main__":
    main()
