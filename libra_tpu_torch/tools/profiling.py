"""What the profiling scripts share (``profile_prefill``, ``profile_decode``,
``profile_train``): libra-11b's decoder config cut to a depth, seeded
random trees built by the port's own ``init_params`` on the device, the
single-image VQA batch, and a torch.profiler trace written as a chrome
trace JSON into a directory (read it with ``parse_trace``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig, VQGANConfig

SEED = 0


def flagship_cfg(num_layers: int = 32) -> LibraConfig:
    """libra-11b's widths in bf16 at `num_layers` layers."""
    return LibraConfig(num_hidden_layers=num_layers, dtype="bfloat16",
                       param_dtype="bfloat16")


def decoder_params(cfg: LibraConfig, device, bits: int = 0):
    """The decoder tree from a generator seeded with SEED on `device`,
    quantized on the device with quantize_params(bits=) when bits is 8
    or 4."""
    from libra_tpu_torch.models import libra as M
    from libra_tpu_torch.quantization import quantize_params
    with torch.no_grad():
        params = M.init_params(torch.Generator(device=device).manual_seed(SEED),
                               cfg, device)
        return quantize_params(params, bits=bits) if bits else params


def vq_tree(device, dtype=torch.bfloat16):
    """libra-11b's two-tap CLIP ViT-L/14-336 + LFQ tokenizer, seeded, in
    `dtype`: (vq_cfg, vq_params)."""
    from libra_tpu_torch.models import vqgan
    vq_cfg = VQGANConfig(select_layer=(-2, -1))
    with torch.no_grad():
        params = vqgan.init_params(torch.Generator(device=device).manual_seed(SEED),
                                   vq_cfg, device, dtype)
    return vq_cfg, params


def example_batch(cfg: LibraConfig, B: int = 1, text_len: int = 32,
                  seed: int = 0):
    """A single-image VQA-shaped batch, [text][578-token image][text]:
    (ids (Q, B, N), mask (B, N), vision_indices (B, N), signal (B, N, C))
    numpy arrays from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    N = text_len + Mv
    ids = rng.randint(3, cfg.vocab_size, size=(Q, B, N)).astype(np.int64)
    ids[1:] = ids[0]
    img = rng.randint(0, cfg.vision_vocab_size - 2, size=(Q, B, Mv)) + cfg.vocab_size
    img[:, :, 0] = cfg.vocab_size + cfg.vision_vocab_size - 2      # BOI
    img[:, :, -1] = cfg.vocab_size + cfg.vision_vocab_size - 1     # EOI
    ids[:, :, 8:8 + Mv] = img
    vi = np.full((B, N), Mv, np.int64)
    vi[:, 8:8 + Mv] = np.arange(Mv)
    mask = np.ones((B, N), np.int64)
    sig = rng.randn(B, N, cfg.contiguous_signal_size).astype(np.float32) * 0.02
    return ids, mask, vi, sig


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn: Callable, device) -> float:
    """fn's wall seconds, ending in a synchronize."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def trace(fn: Callable, out_dir, name: str, device) -> Path:
    """Run fn under torch.profiler (the host's operators, and the card's
    kernels on a CUDA device) and write the chrome trace to
    out_dir/name.json. Returns its path."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sync(device)
    with profile(activities=activities) as prof:
        fn()
        sync(device)
    path = out / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return path
