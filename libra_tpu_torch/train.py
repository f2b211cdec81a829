"""Training CLI: `python -m libra_tpu_torch.train --cfg-path cfg.yaml
[--options k=v ...] [--device cuda|cpu]`.

The PyTorch counterpart of ``libra_tpu/train.py``: load and validate the
three-section config, build the model and tokenizer through the
registry, build the datasets through their builders, make the optimizer
from the run section, train. `main` parses the arguments and reads the
YAML; `run(RunConfig, device=)` does the rest, so a caller without
PyYAML (the card) passes ``RunConfig.from_dict``.

Importing this module registers the model arches and dataset builders
that a config names (a RunConfig validates against them).

The port trains on one device: the run section's mesh must multiply to
1, and there is no multi-process launch yet (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict

import torch

import libra_tpu_torch.data.builders  # noqa: F401  (registrations)
import libra_tpu_torch.data.processors  # noqa: F401
import libra_tpu_torch.train_wrapper  # noqa: F401


def build_model_and_tokenizer(model_cfg: Dict[str, Any], device="cuda"):
    """(LibraConfig, params, LibraTokenizer) from a pretrained reference
    checkpoint dir (model.pretrained, with model.pretrained_weight
    overriding its decoder weights) or from scratch off the config's dims
    (seeded: generator seeds 0 for the decoder, 1 for the VQGAN).

    From scratch the VQGAN is VQGANConfig.tiny() under a hidden size of
    512, else VQGANConfig(), as in libra_tpu; model.vqgan, a dict of
    VQGANConfig fields, overrides it (libra_tpu reserves the key): the
    full-width tree's 2048-wide signal needs CLIP's two taps,
    {select_layer: [-2, -1]}."""
    from libra_tpu_torch import checkpoint as ckpt
    from libra_tpu_torch.config import (LibraConfig, VQGANConfig,
                                        load_vision_tokenizer_config)
    from libra_tpu_torch.models import libra as M, vqgan as vqgan_model
    from libra_tpu_torch.tokenization import (HFTextTokenizer, ImageTokenizer,
                                              LibraTokenizer, SimpleTextTokenizer)

    device = torch.device(device)
    pretrained = model_cfg.get("pretrained")
    if pretrained:
        cfg = LibraConfig.from_pretrained(pretrained)
        sd = ckpt.load_torch_state_dict(
            model_cfg.get("pretrained_weight") or pretrained)
        params = ckpt.convert_libra_state_dict(sd, cfg, device)
        text_tok = HFTextTokenizer(pretrained)
        vq_cfg, vq_ckpt, max_vt, clip_dir = load_vision_tokenizer_config(pretrained)
        clip_params = None
        if vq_cfg.encoder_name == "clip" and clip_dir is not None:
            vq_cfg, clip_params = ckpt.load_nested_clip(clip_dir, vq_cfg, device)
        vq_params = ckpt.convert_vqgan_state_dict(
            ckpt.load_torch_state_dict(vq_ckpt), vq_cfg, clip_params, device)
        img_tok = ImageTokenizer(
            vq_cfg, vq_params, token_offset=cfg.vocab_size,
            max_vision_token_length=max_vt or cfg.max_vision_token_length,
            downsample_ratio=ImageTokenizer.infer_downsample_ratio(vq_ckpt))
    else:
        cfg = LibraConfig.from_dict(model_cfg.get("config", {}) | {
            k: v for k, v in model_cfg.items()
            if k not in ("arch", "config", "vqgan")})
        params = M.init_params(torch.Generator(device=device).manual_seed(0),
                               cfg, device)
        vq_kw = dict(model_cfg.get("vqgan") or {})
        if isinstance(vq_kw.get("select_layer"), list):
            vq_kw["select_layer"] = tuple(vq_kw["select_layer"])
        vq_cfg = (VQGANConfig.tiny(**vq_kw) if cfg.hidden_size < 512
                  else VQGANConfig(**vq_kw))
        vq_params = vqgan_model.init_params(
            torch.Generator(device=device).manual_seed(1), vq_cfg, device)
        text_tok = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
        img_tok = ImageTokenizer(vq_cfg, vq_params, token_offset=cfg.vocab_size,
                                 max_vision_token_length=cfg.max_vision_token_length)
    return cfg, params, LibraTokenizer(text_tok, img_tok)


def build_datasets(cfg, tokenizer):
    """(train, eval or None) from the config's datasets section."""
    from libra_tpu_torch.data.base import concat_datasets, reorg_datasets_by_split
    from libra_tpu_torch.registry import registry

    datasets = {}
    for name, ds_cfg in cfg.datasets_cfg.items():
        builder = registry.get_builder_class(name)(ds_cfg, tokenizer=tokenizer)
        datasets[name] = builder.build_datasets()
    by_split = concat_datasets(reorg_datasets_by_split(datasets))
    return by_split["train"], by_split.get("val") or by_split.get("eval")


def optimizer_config(model_cfg: Dict[str, Any], run: Dict[str, Any]):
    from libra_tpu_torch.training.optimizer import OptimizerConfig
    kw = model_cfg.get("model_kwargs", {})
    return OptimizerConfig(
        learning_rate=run.get("learning_rate", 1e-4),
        warmup_ratio=run.get("warmup_ratio", 0.05),
        total_steps=run.get("max_steps", 1000),
        weight_decay=run.get("weight_decay", 0.01),
        max_grad_norm=run.get("max_grad_norm", 1.0),
        frozen_language=kw.get("frozen_language", False),
        freeze_vision_value=kw.get("freeze_vision_value", False),
        freeze_text_embedding=kw.get("freeze_text_embedding", False),
        freeze_vision_embedding=kw.get("freeze_vision_embedding", False))


def run(cfg, device="cuda") -> Dict[str, Any]:
    """Train as the config says, on `device`; returns the last logged
    metrics ({} for the debug model)."""
    import libra_tpu_torch.train_wrapper as tw
    from libra_tpu_torch.training.harness import HarnessConfig, TrainHarness
    from libra_tpu_torch.training.trainer import Trainer

    model_cfg, run_cfg = cfg.model_cfg, cfg.run_cfg
    if model_cfg.get("arch") == "debug_model":
        # data-pipeline smoke mode (the reference's build_model(no_model=True))
        _run_debug_model(cfg, device)
        return {}

    libra_cfg, params, tokenizer = build_model_and_tokenizer(model_cfg, device)
    wrapper = tw.LibraTrainWrapper(libra_cfg, tokenizer)
    params = wrapper.change_pad_token_to_eos(params)
    train_ds, eval_ds = build_datasets(cfg, tokenizer.text_tokenizer)
    # run.remat: "full" (the default), "big_dots" or "names:..."
    # (models.libra.forward); run.mesh must span one device (A13)
    trainer = Trainer(libra_cfg, params, optimizer_config(model_cfg, run_cfg),
                      remat=run_cfg.get("remat", True), device=device,
                      mesh=run_cfg.get("mesh"))
    harness = TrainHarness(trainer, wrapper, HarnessConfig.from_run_cfg(run_cfg),
                           train_ds, eval_ds,
                           max_length=run_cfg.get("model_max_length"))
    try:
        return harness.train()
    finally:
        harness.close()


def _run_debug_model(cfg, device="cuda") -> None:
    from libra_tpu_torch.tokenization import SimpleTextTokenizer
    from libra_tpu_torch.train_wrapper import DebugModel
    from libra_tpu_torch.training.harness import Prefetcher, batched

    train_ds, _ = build_datasets(cfg, SimpleTextTokenizer())
    model = DebugModel(device)
    bs = cfg.run_cfg.get("per_device_train_batch_size", 4)
    steps = cfg.run_cfg.get("max_steps", 5)
    it = batched(Prefetcher(train_ds), bs, train_ds.collater)
    for step in range(steps):
        batch = next(it)
        loss = model.forward(batch)
        print({"step": step, "debug_loss": round(loss, 5),
               "batch": len(batch["samples"]["language"])})


def main(argv=None):
    parser = argparse.ArgumentParser("libra_tpu_torch training")
    parser.add_argument("--cfg-path", required=True)
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotlist overrides: run.max_steps=100")
    parser.add_argument("--device", default="cuda",
                        help="the device to train on (cpu for a test run)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from libra_tpu_torch.run_config import RunConfig

    final = run(RunConfig(args.cfg_path, args.options), device=args.device)
    print(final)


if __name__ == "__main__":
    main()
