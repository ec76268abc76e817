"""Test runner: greedy generation + per-sample metrics.

The port of ``ecg_byte_tpu/infer/evaluate.py``, with one deliberate
difference: an exception from ``generate_fn`` propagates.  The JAX runner
zero-fills the sample's metrics on any exception, so a failing kernel
there would end a run with exit code 0 and zero scores.  Here only metric
scoring may fail soft (a metric package missing offline), and it is
zero-filled as before, except BERTScore, which needs none of those
packages: it is scored on its own (the JAX runner zero-fills it too).

Scoring never downloads: METEOR uses NLTK's wordnet only where it is
already installed and otherwise the exact-match METEOR of
``utils.metrics``, labelled ``exact``; BERTScore runs a local BERT on the
run's ``device`` where ``$ECG_BYTE_BERTSCORE_MODEL`` names one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ecg_byte_tpu_torch.utils import metrics

ZERO_RESULT = {
    "BLEU": 0,
    "METEOR": 0.0,
    "ROUGE": {"rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0},
    "BERTSCORE": {"hf-prec": [0.0], "hf-rec": [0.0], "hf-f1": [0.0]},
}


def evaluate_strings(reference: str, hypothesis: str, device=None) -> Dict:
    """The metric dict of ``metrics.evaluate_strings`` for one sample;
    BERTScore's local BERT runs on ``device``, after the metrics that may
    be missing here."""
    meteor, meteor_mode = metrics.meteor_with_mode([reference], [hypothesis])
    bleu = metrics.calculate_bleu([reference], [hypothesis])
    rouge = metrics.calculate_rouge([reference], [hypothesis])
    bert, bert_mode = metrics.bertscore_with_mode([reference], [hypothesis], device)
    return {
        "BLEU": bleu,
        "METEOR": meteor,
        "ROUGE": rouge,
        "BERTSCORE": bert,
        "MODES": {"meteor": meteor_mode, "bertscore": bert_mode},
    }


def _score(reference: str, hypothesis: str, device=None) -> Dict:
    try:
        return evaluate_strings(reference, hypothesis, device)
    except Exception as e:  # a metric that cannot run here scores zero
        print(f"could not score a sample ({type(e).__name__}: {e})")
    # BERTScore needs neither nltk nor rouge: it still scores, with its mode
    result = dict(ZERO_RESULT)
    result["BERTSCORE"], mode = metrics.bertscore_with_mode([reference], [hypothesis], device)
    result["MODES"] = {"bertscore": mode}
    return result


def tester(
    generate_fn: Callable[[Dict], object],
    dataloader,
    *,
    two_stage: bool = False,
    dev: bool = False,
    device: Optional[object] = None,
):
    """Evaluate generation over a loader of inference batches.

    ``generate_fn(batch)`` returns one string, or a list with one string
    per row, with the prompt already sliced off.  ``two_stage`` keeps what
    follows the last ``"?"`` of each text, as the reference's two-stage
    runner does.  ``device`` is where BERTScore's local BERT runs: the
    model's device.
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
        if two_stage:
            texts = [t.split("?")[-1] for t in texts]
        for i, t in enumerate(texts):
            all_results.append(_score(answers[i], t, device))
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
