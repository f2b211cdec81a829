"""Evaluation CLI: the loss, captioning or VQA over a karpathy-style split.

    python -m libra_tpu_torch.evaluate --cfg-path cfg.yaml [--options k=v ...]
        [--mode loss|caption|vqa] [--max-samples N] [--output preds.json]
        [--device cuda|cpu]

The PyTorch counterpart of ``libra_tpu/evaluate.py``, covering the
reference's eval surfaces: the loss-only regression eval (COCO val,
prediction_loss_only) and a generation eval that writes {image_id,
caption} or {question_id, answer} predictions and scores them in-repo
(``metrics``: CIDEr-D and BLEU-4 against the split's own captions, VQA
accuracy against each row's human answers).

`main` parses the arguments and reads the YAML; `run(RunConfig, mode,
device=)` does the rest and returns the result dict, so a caller without
PyYAML passes ``RunConfig.from_dict``. The loss mode runs the one-device
``Trainer.eval_step`` (libra_tpu builds a data mesh there). The caption
and VQA modes open the split's images with PIL.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List

import libra_tpu_torch.data.builders  # noqa: F401  (registrations)
import libra_tpu_torch.data.processors  # noqa: F401
import libra_tpu_torch.train_wrapper  # noqa: F401


def _images(dataset, anns) -> list:
    from PIL import Image
    return [Image.open(os.path.join(dataset.vis_root, a["image"])).convert("RGB")
            for a in anns]


def generate_captions(pipeline, dataset, max_samples: int = 100,
                      question: str = "Describe the image concisely.",
                      max_new_tokens: int = 64,
                      batch_size: int = 8) -> List[Dict[str, Any]]:
    """Greedy captioning over a map-style caption dataset; images are read
    through the dataset's vis_root annotations."""
    preds = []
    annotations = dataset.annotation[:max_samples]
    for lo in range(0, len(annotations), batch_size):
        anns = annotations[lo:lo + batch_size]
        images = _images(dataset, anns)
        outs = pipeline.chat([question] * len(images), images=images,
                             max_new_tokens=max_new_tokens)
        for a, cap in zip(anns, outs):
            preds.append({"image_id": a.get("image_id", a["image"]),
                          "caption": cap})
    return preds


def generate_vqa_answers(pipeline, dataset, max_samples: int = 100,
                         max_new_tokens: int = 16,
                         batch_size: int = 8) -> List[Dict[str, Any]]:
    """Open-ended VQA over annotation rows carrying a "question" field
    (LLaVA/VQAv2 format: each row has image, question and the human
    "answers" list), through the v1 chat template as the reference demo's
    VQA turns."""
    preds = []
    annotations = [a for a in dataset.annotation if "question" in a][:max_samples]
    for lo in range(0, len(annotations), batch_size):
        anns = annotations[lo:lo + batch_size]
        outs = pipeline.chat([a["question"] for a in anns],
                             images=_images(dataset, anns),
                             max_new_tokens=max_new_tokens)
        for a, ans in zip(anns, outs):
            preds.append({"question_id": a.get("question_id",
                                               a.get("image_id", a["image"])),
                          "answer": ans})
    return preds


def score_vqa(preds: List[Dict[str, Any]],
              annotations: List[Dict[str, Any]]) -> Dict[str, Any]:
    """min(1, #matching-humans/3) accuracy (metrics.vqa_accuracy) against
    each row's "answers" list (or single "answer")."""
    from libra_tpu_torch.metrics import vqa_accuracy
    answers = {}
    for a in annotations:
        if "question" not in a:
            continue
        key = str(a.get("question_id", a.get("image_id", a.get("image"))))
        ans = a.get("answers", a.get("answer"))
        if isinstance(ans, str):
            ans = [ans]
        if ans:
            answers[key] = ans
    cands = {str(p["question_id"]): p["answer"] for p in preds}
    return {"vqa_accuracy": round(vqa_accuracy(cands, answers), 4),
            "scored": len([q for q in cands if q in answers])}


def eval_dataset(cfg, text_tokenizer):
    """The split to evaluate: val, else eval, test or train."""
    from libra_tpu_torch.data.base import concat_datasets, reorg_datasets_by_split
    from libra_tpu_torch.registry import registry

    datasets = {}
    for name, ds_cfg in cfg.datasets_cfg.items():
        builder = registry.get_builder_class(name)(ds_cfg, tokenizer=text_tokenizer)
        datasets[name] = builder.build_datasets()
    by_split = concat_datasets(reorg_datasets_by_split(datasets))
    return (by_split.get("val") or by_split.get("eval")
            or by_split.get("test") or by_split.get("train"))


def run(cfg, mode: str = "loss", max_samples: int = 100,
        output: str = "predictions.json", device="cuda") -> Dict[str, Any]:
    """Evaluate as the config says, on `device`. mode "loss": the mean
    eval loss over batches of run.per_device_train_batch_size until
    max_samples; "caption" / "vqa": greedy answers written to `output`
    and scored. Returns the result dict."""
    from libra_tpu_torch.train import build_model_and_tokenizer
    from libra_tpu_torch.train_wrapper import LibraTrainWrapper

    libra_cfg, params, tokenizer = build_model_and_tokenizer(cfg.model_cfg, device)
    eval_ds = eval_dataset(cfg, tokenizer.text_tokenizer)

    if mode == "loss":
        from libra_tpu_torch.training.harness import batched
        from libra_tpu_torch.training.optimizer import OptimizerConfig
        from libra_tpu_torch.training.trainer import Trainer
        bs = cfg.run_cfg.get("per_device_train_batch_size", 8)
        trainer = Trainer(libra_cfg, params, OptimizerConfig(), device=device)
        wrapper = LibraTrainWrapper(libra_cfg, tokenizer)
        losses = []
        it = (eval_ds[i] for i in range(len(eval_ds)))
        for batch in batched(it, bs, eval_ds.collater):
            losses.append(float(trainer.eval_step(wrapper.prepare_batch(batch))))
            if len(losses) * bs >= max_samples:
                break
        return {"eval_loss": sum(losses) / max(1, len(losses)),
                "batches": len(losses)}
    if mode not in ("caption", "vqa"):
        raise ValueError(f"mode must be 'loss', 'caption' or 'vqa', not {mode!r}")

    from libra_tpu_torch.data.processors import LibraEvalImageProcessor
    from libra_tpu_torch.pipeline import LibraPipeline
    pipe = LibraPipeline(libra_cfg, params, tokenizer,
                         image_processor=LibraEvalImageProcessor(
                             tokenizer.image_tokenizer.cfg.clip))
    if mode == "vqa":
        preds = generate_vqa_answers(pipe, eval_ds, max_samples=max_samples)
    else:
        preds = generate_captions(pipe, eval_ds, max_samples=max_samples)
    Path(output).write_text(json.dumps(preds, indent=1))
    result = {"predictions": len(preds), "output": output}
    if mode == "vqa":
        result.update(score_vqa(preds, eval_ds.annotation))
    else:
        # scored in-repo against the split's own reference captions
        from libra_tpu_torch.metrics import score_captions
        result.update(score_captions(preds, eval_ds.annotation))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser("libra_tpu_torch evaluation")
    parser.add_argument("--cfg-path", required=True)
    parser.add_argument("--options", nargs="*", default=None)
    parser.add_argument("--mode", choices=["loss", "caption", "vqa"],
                        default="loss")
    parser.add_argument("--max-samples", type=int, default=100)
    parser.add_argument("--output", default="predictions.json")
    parser.add_argument("--device", default="cuda",
                        help="the device to evaluate on (cpu for a test run)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from libra_tpu_torch.run_config import RunConfig

    result = run(RunConfig(args.cfg_path, args.options), mode=args.mode,
                 max_samples=args.max_samples, output=args.output,
                 device=args.device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
