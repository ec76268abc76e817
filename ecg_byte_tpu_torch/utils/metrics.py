"""Text-generation metrics and the 5-seed statistical analysis.

The port's copy of ``ecg_byte_tpu/utils/metrics.py``: corpus BLEU
(smoothing method1), METEOR, ROUGE-1/2/L F, BERTScore, early stopping and
the mean/std/95% t-CI summary.  BERTScore reads the HF ``evaluate`` scorer
or zero-fills; the JAX package's local-BERT scorer is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def early_stopping(validation_losses, patience: int = 5, delta: float = 0.0) -> bool:
    """Stop when the latest loss exceeds the best loss observed at least
    ``patience`` epochs ago by ``delta``."""
    if len(validation_losses) < patience + 1:
        return False
    best_loss = min(validation_losses[:-patience])
    return validation_losses[-1] > best_loss + delta


def calculate_bleu(references, hypotheses) -> float:
    from nltk.translate.bleu_score import SmoothingFunction, corpus_bleu

    return corpus_bleu(
        [[r.split()] for r in references],
        [h.split() for h in hypotheses],
        smoothing_function=SmoothingFunction().method1,
    )


def _meteor_exact(ref: List[str], hyp: List[str]) -> float:
    """METEOR with exact unigram matching only (no wordnet): F(alpha=0.9)
    with the standard fragmentation penalty."""
    if not hyp or not ref:
        return 0.0
    ref_avail = list(ref)
    pairs = []  # (hyp_idx, ref_idx)
    for i, h in enumerate(hyp):
        if h in ref_avail:
            ref_avail[ref_avail.index(h)] = None
            pairs.append((i, ref.index(h)))
    m = len(pairs)
    if m == 0:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = precision * recall / (0.9 * precision + 0.1 * recall)
    pairs.sort()  # chunks: contiguous in both hyp and ref order
    chunks = 1 + sum(
        1 for (i1, j1), (i2, j2) in zip(pairs, pairs[1:])
        if not (i2 == i1 + 1 and j2 == j1 + 1)
    )
    return fmean * (1.0 - 0.5 * (chunks / m) ** 3)


def meteor_with_mode(references, hypotheses):
    """Returns (score, mode): "wordnet" (NLTK's METEOR, where its wordnet is
    installed) or "exact" (:func:`_meteor_exact`).  Never downloads."""
    try:
        import nltk
        from nltk.translate.meteor_score import meteor_score

        nltk.data.find("corpora/wordnet")
        scores = [meteor_score([r.split()], h.split()) for r, h in zip(references, hypotheses)]
        return float(np.mean(scores)), "wordnet"
    except LookupError:
        scores = [_meteor_exact(r.split(), h.split()) for r, h in zip(references, hypotheses)]
        return float(np.mean(scores)), "exact"


def calculate_rouge(references, hypotheses) -> Dict[str, float]:
    from rouge import Rouge

    scores = Rouge().get_scores(hypotheses, references, avg=True)
    return {k: scores[k]["f"] for k in ("rouge-1", "rouge-2", "rouge-l")}


def bertscore_with_mode(references, hypotheses):
    """Returns (P/R/F1 dict, mode): "hf" (HF ``evaluate``) or "zero-fill"
    (no scorer available offline)."""
    try:
        from evaluate import load  # optional, absent offline

        results = load("bertscore").compute(
            predictions=hypotheses, references=references, lang="en"
        )
        return {"hf-prec": results["precision"], "hf-rec": results["recall"],
                "hf-f1": results["f1"]}, "hf"
    except Exception:
        n = len(hypotheses)
        return {"hf-prec": [0.0] * n, "hf-rec": [0.0] * n, "hf-f1": [0.0] * n}, "zero-fill"


def run_statistical_analysis(all_seeds_results: Sequence[Dict]) -> Dict:
    """Per metric over seeds: mean, std, 95% t confidence interval (x100)."""
    from scipy import stats

    out = {}
    for metric in all_seeds_results[0]["metrics"]:
        values = [r["metrics"][metric] * 100 for r in all_seeds_results]
        mean = float(np.mean(values))
        dof = len(values) - 1
        std = float(np.std(values, ddof=1)) if dof > 0 else 0.0
        margin = stats.t.ppf(0.975, dof) * (std / np.sqrt(len(values))) if dof > 0 else 0.0
        out[metric] = {
            "mean": mean,
            "std": std,
            "conf_interval": (mean - margin, mean + margin),
            "raw_values": values,
        }
    return out
