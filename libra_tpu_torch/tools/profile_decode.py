"""Profile the cached greedy decode: 64 new tokens at B = 4.

    python -m libra_tpu_torch.tools.profile_decode OUT_DIR [--device cuda]

libra-11b at full width and depth, the tree quantized to int8 on the card
with the int8 KV cache, the pre-encoded single-image VQA batch
(32 text ids and a 578-token image, a seeded signal). Prints the steady
ms a step, then writes one profiled run's chrome trace to
OUT_DIR/decode.json (``python -m libra_tpu_torch.tools.parse_trace
OUT_DIR``).
"""

from __future__ import annotations

import argparse

import torch

from libra_tpu_torch.tools.profiling import (decoder_params, example_batch,
                                             flagship_cfg, timed, trace)

B, TEXT_LEN, LAYERS, BITS, NEW = 4, 32, 32, 8, 64


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("profile the cached decode")
    parser.add_argument("out_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from libra_tpu_torch.generation import GenerationConfig, Generator
    dev = torch.device(args.device)
    cfg = flagship_cfg(LAYERS)
    params = decoder_params(cfg, dev, BITS)
    print("params ready", flush=True)
    ids, mask, vi, sig = example_batch(cfg, B=B, text_len=TEXT_LEN)
    inputs = {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
              "coninous_signal": sig}
    gen = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, kv_quant=True)
    g = Generator(params, cfg)
    with torch.inference_mode():
        run = lambda: g(inputs, gen).sequences    # noqa: E731
        timed(run, dev)
        print("warm", flush=True)
        print(f"steady: {timed(run, dev) / NEW * 1e3:.2f} ms/step "
              f"(prompt pass included)", flush=True)
        path = trace(run, args.out_dir, "decode", dev)
    print(f"trace -> {path}", flush=True)


if __name__ == "__main__":
    main()
