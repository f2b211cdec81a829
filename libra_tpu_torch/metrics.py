"""Caption/VQA scoring: CIDEr-D, BLEU-4 and the VQA accuracy metric.

The PyTorch port's copy of ``libra_tpu/metrics.py`` (pure Python, no
torch): the same formulas, rounding and results. The reference writes
predictions json and defers scoring to the paper's external harness;
formulas follow the standard implementations:

* CIDEr-D (Vedantam et al. 2015, the "-D" variant of the official
  coco-caption code): per-n-gram TF*IDF vectors, candidate counts clipped
  to the reference's, cosine similarity with a gaussian length penalty
  (sigma 6), averaged over n in 1..4 and over references, scaled by 10.
* BLEU-4: smoothed=False corpus BLEU with brevity penalty.
* VQA accuracy: min(1, matching_human_answers / 3) after the usual light
  normalization (lowercase, strip punctuation and articles).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

_PUNCT = re.compile(r"[^\w\s]")
_ARTICLES = {"a", "an", "the"}


def tokenize(s: str) -> List[str]:
    return _PUNCT.sub(" ", s.lower()).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(candidates: Dict[str, str],
            references: Dict[str, List[str]],
            n_max: int = 4, sigma: float = 6.0,
            df_corpus: Optional[Dict[str, List[str]]] = None) -> float:
    """Corpus CIDEr-D. candidates: image_id -> caption;
    references: image_id -> list of reference captions.

    IDF document frequencies are computed over `df_corpus` when given
    (pass the FULL split's references to match official coco-caption
    numbers); otherwise over the scored subset only -- scores from
    partial runs (evaluate --max-samples) are then internally consistent
    but NOT comparable with full-corpus numbers.
    """
    ids = [i for i in candidates if i in references and references[i]]
    if not ids:
        return 0.0

    # document frequency corpus: full split if provided, scored subset else
    df_refs = df_corpus if df_corpus is not None else references
    df_ids = ([i for i in df_refs if df_refs[i]]
              if df_corpus is not None else ids)
    df: List[Dict] = [defaultdict(float) for _ in range(n_max)]
    for i in df_ids:
        seen = [set() for _ in range(n_max)]
        for r in df_refs[i]:
            toks = tokenize(r)
            for n in range(n_max):
                seen[n].update(_ngrams(toks, n + 1))
        for n in range(n_max):
            for g in seen[n]:
                df[n][g] += 1.0
    ref_grams = {}
    for i in ids:
        ref_grams[i] = []
        for r in references[i]:
            toks = tokenize(r)
            grams = [_ngrams(toks, n + 1) for n in range(n_max)]
            ref_grams[i].append((grams, len(toks)))
    log_n = math.log(max(len(df_ids), 1))

    def vec(grams: Counter, n: int):
        v = {}
        norm = 0.0
        for g, cnt in grams.items():
            idf = log_n - math.log(max(df[n][g], 1.0))
            v[g] = cnt * idf
            norm += v[g] ** 2
        return v, math.sqrt(norm)

    total = 0.0
    for i in ids:
        c_toks = tokenize(candidates[i])
        c_grams = [_ngrams(c_toks, n + 1) for n in range(n_max)]
        c_vecs = [vec(c_grams[n], n) for n in range(n_max)]
        score_n = [0.0] * n_max
        for r_gramsets, r_len in ref_grams[i]:
            delta = len(c_toks) - r_len
            penalty = math.exp(-delta ** 2 / (2 * sigma ** 2))
            for n in range(n_max):
                rv, rnorm = vec(r_gramsets[n], n)
                cv, cnorm = c_vecs[n]
                # candidate counts clipped to the reference's (the -D fix)
                s = sum(min(cv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                        for g in cv)
                if cnorm and rnorm:
                    s /= cnorm * rnorm
                score_n[n] += penalty * s
        n_ref = len(ref_grams[i])
        total += 10.0 * sum(s / n_ref for s in score_n) / n_max
    return total / len(ids)


# ---------------------------------------------------------------------------
# BLEU-4
# ---------------------------------------------------------------------------

def bleu4(candidates: Dict[str, str],
          references: Dict[str, List[str]]) -> float:
    """Corpus BLEU-4 with brevity penalty (uniform weights, no smoothing)."""
    ids = [i for i in candidates if i in references and references[i]]
    if not ids:
        return 0.0
    match = [0] * 4
    guess = [0] * 4
    c_len = r_len = 0
    for i in ids:
        c = tokenize(candidates[i])
        refs = [tokenize(r) for r in references[i]]
        c_len += len(c)
        r_len += min((abs(len(r) - len(c)), len(r)) for r in refs)[1]
        for n in range(4):
            cg = _ngrams(c, n + 1)
            max_ref = Counter()
            for r in refs:
                rg = _ngrams(r, n + 1)
                for g, cnt in rg.items():
                    max_ref[g] = max(max_ref[g], cnt)
            guess[n] += sum(cg.values())
            match[n] += sum(min(cnt, max_ref[g]) for g, cnt in cg.items())
    if any(m == 0 for m in match):
        return 0.0
    log_p = sum(math.log(m / g) for m, g in zip(match, guess)) / 4
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return bp * math.exp(log_p)


# ---------------------------------------------------------------------------
# VQA accuracy
# ---------------------------------------------------------------------------

def _vqa_norm(s: str) -> str:
    toks = [t for t in tokenize(s) if t not in _ARTICLES]
    return " ".join(toks)


def vqa_accuracy(predictions: Dict[str, str],
                 answers: Dict[str, List[str]]) -> float:
    """Standard VQA metric: acc = min(1, #humans-with-this-answer / 3),
    averaged over questions."""
    ids = [i for i in predictions if i in answers and answers[i]]
    if not ids:
        return 0.0
    total = 0.0
    for i in ids:
        pred = _vqa_norm(predictions[i])
        human = Counter(_vqa_norm(a) for a in answers[i])
        total += min(1.0, human.get(pred, 0) / 3.0)
    return total / len(ids)


def score_captions(preds: Iterable[Dict], annotations: Iterable[Dict]) -> Dict:
    """Score a predictions list [{image_id, caption}] against karpathy-style
    annotations [{image_id?, image, caption}] (multiple rows per image)."""
    refs: Dict[str, List[str]] = defaultdict(list)
    for a in annotations:
        key = str(a.get("image_id", a.get("image")))
        cap = a.get("caption")
        if isinstance(cap, list):
            refs[key].extend(cap)
        elif cap:
            refs[key].append(cap)
    cands = {str(p["image_id"]): p["caption"] for p in preds}
    # df_corpus=refs: IDF over every annotation row given, not just the
    # predicted subset, so partial-run scores use the split's DF table
    return {"cider_d": round(cider_d(cands, refs, df_corpus=refs), 4),
            "bleu4": round(bleu4(cands, refs), 4),
            "scored": len([i for i in cands if i in refs])}
