"""Profile the fused train step (CLIP + LFQ inside, frozen language).

    python -m libra_tpu_torch.tools.profile_train OUT_DIR
        [--attn auto|flash|plain] [--remat full big_dots] [--device cuda]

libra-11b at full width cut to 4 layers, B = 8 rows of 120 text ids and
one 336 x 336 uint8 image each at position 8 (N = 698), AdamW on the
trainable (vision) leaves. For each remat policy: a warm-up step, the
steady ms a step over 4 steps, then one profiled step's chrome trace in
OUT_DIR/train_<policy>.json (``python -m libra_tpu_torch.tools.parse_trace
OUT_DIR``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from libra_tpu_torch.tools.profiling import (decoder_params, flagship_cfg, timed,
                                             trace, vq_tree)

B, TEXT_LEN, IMG_START, STEPS, LAYERS = 8, 120, 8, 4, 4


def train_batch(cfg, dev):
    """B rows of N = TEXT_LEN + 578: one image block at IMG_START, text ids
    and labels from RandomState(0), the image tokens' labels copied from
    the on-device encode (BOI's and the first text label after the block
    masked: EOI would predict it across modalities), uint8 images."""
    from libra_tpu_torch.training.fused import FusedBatch
    Mv, Q, V = cfg.max_vision_token_length, cfg.vision_codebook_num, cfg.vocab_size
    N = TEXT_LEN + Mv
    rng = np.random.RandomState(0)
    vi = np.full((B, N), Mv, np.int64)
    vi[:, IMG_START:IMG_START + Mv] = np.arange(Mv)
    labels = rng.randint(3, V, size=(Q, B, N)).astype(np.int64)
    copy_mask = np.zeros((B, N), bool)
    copy_mask[:, IMG_START + 1:IMG_START + Mv] = True
    labels[:, :, IMG_START:IMG_START + Mv + 1] = -100
    text_ids = rng.randint(3, V, (B, N))
    pixels = rng.randint(0, 256, (B, 336, 336, 3)).astype(np.uint8)

    def t(x):
        return torch.as_tensor(x, device=dev)

    return FusedBatch(pixels=t(pixels), text_ids=t(text_ids),
                      img_start=t(np.full((B,), IMG_START)),
                      attention_mask=t(np.ones((B, N), np.int64)),
                      vision_indices=t(vi), labels_static=t(labels),
                      label_copy_mask=t(copy_mask),
                      signal_ignore=t(np.zeros((B,), bool)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("profile the fused train step")
    parser.add_argument("out_dir")
    parser.add_argument("--attn", default="auto", choices=("auto", "flash", "plain"))
    parser.add_argument("--remat", nargs="+", default=["full", "big_dots"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from libra_tpu_torch.training.fused import make_fused_train_step
    from libra_tpu_torch.training.optimizer import (OptimizerConfig, make_optimizer,
                                                    trainable_mask)
    from libra_tpu_torch.training.trainer import init_state
    dev = torch.device(args.device)
    cfg = flagship_cfg(LAYERS)
    vq_cfg, vq_params = vq_tree(dev)
    batch = train_batch(cfg, dev)
    opt_cfg = OptimizerConfig(frozen_language=True, total_steps=1000)
    for remat in args.remat:
        params = decoder_params(cfg, dev)
        opt = make_optimizer(opt_cfg, params)
        state = [init_state(params, opt)]
        step = make_fused_train_step(cfg, vq_cfg, opt,
                                     grad_mask=trainable_mask(params, opt_cfg),
                                     attn_impl=args.attn, remat=remat)

        def one():
            state[0], m = step(state[0], vq_params, batch)
            return m

        timed(one, dev)
        loss = float(one()["loss"])
        dt = timed(lambda: [one() for _ in range(STEPS)], dev) / STEPS
        print(f"remat={remat}: steady {dt * 1e3:.1f} ms/step ({args.attn}), "
              f"loss {loss:.4f}", flush=True)
        path = trace(one, args.out_dir, f"train_{remat}", dev)
        print(f"trace -> {path}", flush=True)
        del params, opt, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
