"""Test runner: greedy generation + per-sample metrics.

The port of ``ecg_byte_tpu/infer/evaluate.py``, with one deliberate
difference: an exception from ``generate_fn`` propagates.  The JAX runner
zero-fills the sample's metrics on any exception, so a failing kernel
there would end a run with exit code 0 and zero scores.  Here only metric
scoring may fail soft (a metric package missing offline), and it is
zero-filled as before.

Scoring never downloads: METEOR uses NLTK's wordnet only where it is
already installed and otherwise the exact-match METEOR of
``ecg_byte_tpu.utils.metrics``, labelled ``exact``.
"""

from __future__ import annotations

from typing import Callable, Dict

from ecg_byte_tpu.utils import metrics

ZERO_RESULT = {
    "BLEU": 0,
    "METEOR": 0.0,
    "ROUGE": {"rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0},
    "BERTSCORE": {"hf-prec": [0.0], "hf-rec": [0.0], "hf-f1": [0.0]},
}


def _meteor(reference: str, hypothesis: str):
    import nltk

    try:
        nltk.data.find("corpora/wordnet")
    except LookupError:
        return metrics._meteor_exact(reference.split(), hypothesis.split()), "exact"
    return metrics.meteor_with_mode([reference], [hypothesis])


def evaluate_strings(reference: str, hypothesis: str) -> Dict:
    """The metric dict of ``metrics.evaluate_strings`` for one sample."""
    meteor, meteor_mode = _meteor(reference, hypothesis)
    bert, bert_mode = metrics.bertscore_with_mode([reference], [hypothesis])
    return {
        "BLEU": metrics.calculate_bleu([reference], [hypothesis]),
        "METEOR": meteor,
        "ROUGE": metrics.calculate_rouge([reference], [hypothesis]),
        "BERTSCORE": bert,
        "MODES": {"meteor": meteor_mode, "bertscore": bert_mode},
    }


def _score(reference: str, hypothesis: str) -> Dict:
    try:
        return evaluate_strings(reference, hypothesis)
    except Exception as e:  # a metric that cannot run here scores zero
        print(f"could not score a sample ({type(e).__name__}: {e})")
        return dict(ZERO_RESULT)


def tester(
    generate_fn: Callable[[Dict], object],
    dataloader,
    *,
    dev: bool = False,
):
    """Evaluate generation over a loader of inference batches.

    ``generate_fn(batch)`` returns one string, or a list with one string
    per row, with the prompt already sliced off.
    """
    all_results, gt_answers, gen_answers, questions = [], [], [], []
    dev_count = 0
    for batch in dataloader:
        if batch is None:
            print("Skipping invalid batch")
            continue
        answers = batch["answer"]
        text = generate_fn(batch)
        texts = text if isinstance(text, list) else [text]
        for i, t in enumerate(texts):
            all_results.append(_score(answers[i], t))
            gt_answers.append(answers[i])
            gen_answers.append(t)
            questions.append(batch["question"][i])
        if dev:
            dev_count += 1
            if dev_count == 10:
                break

    metric_sums = {
        "BLEU": 0.0, "METEOR": 0.0,
        "rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0,
        "hf-prec": 0.0, "hf-rec": 0.0, "hf-f1": 0.0,
    }
    metric_counts = {k: 0 for k in metric_sums}
    metric_modes: Dict[str, set] = {}
    for entry in all_results:
        for key, value in entry.items():
            if key == "MODES":
                for m, mode in value.items():
                    metric_modes.setdefault(m, set()).add(mode)
            elif key in ("ROUGE", "BERTSCORE"):
                for sub_key, sub_value in value.items():
                    metric_sums[sub_key] += sub_value[0] if key == "BERTSCORE" else sub_value
                    metric_counts[sub_key] += 1
            else:
                metric_sums[key] += value
                metric_counts[key] += 1
    seed_averages = {
        k: (metric_sums[k] / metric_counts[k] if metric_counts[k] else 0.0)
        for k in metric_sums
    }
    return {
        "metrics": seed_averages,
        "metric_modes": {k: sorted(v) for k, v in metric_modes.items()},
        "qa_results": {
            "questions": questions,
            "gt_answers": gt_answers,
            "gen_answers": gen_answers,
        },
    }
