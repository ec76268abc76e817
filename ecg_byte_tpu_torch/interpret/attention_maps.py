"""Interpret runner: attention capture, region slicing, signal attribution.

The port of ``ecg_byte_tpu/interpret/attention_maps.py``, host code over
the forward's (B, S, S) attention.  It locates the signal, question and
answer spans by the special tokens and the first real label, takes each
region's mean attention row, expands token weights to per-sample weights
by each token's symbol count, reshapes them to (12, seg_len) and draws the
overlays where matplotlib is installed.  No progress bar (the machine with
the card has no ``tqdm``).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from ecg_byte_tpu_torch.tokenizer import decode_text
from ecg_byte_tpu_torch.utils.viz_utils import (
    plot_attention_on_signal,
    plot_text_attention_weights,
)


def get_component_indices(tokenized_seq, labels, tokenizer):
    """(signal_start, question_start, answer_start) of one sequence."""
    sig_start_id = tokenizer.convert_tokens_to_ids("<sig_start>")
    sig_end_id = tokenizer.convert_tokens_to_ids("<sig_end>")
    pad_id = tokenizer.pad_token_id

    signal_start = 0
    for i, t in enumerate(tokenized_seq):
        if t == sig_start_id:
            signal_start = i + 1
            break
    question_start = signal_start
    for i in range(signal_start, len(tokenized_seq)):
        if tokenized_seq[i] == sig_end_id:
            question_start = i + 1
            break
    answer_start = len(tokenized_seq)
    if labels is not None:
        for i in range(question_start, len(labels)):
            if labels[i] != -100 and labels[i] != pad_id:
                answer_start = i
                break
    return signal_start, question_start, answer_start


def expand_attention(encoded_ids, attention_sequence, vocab) -> List[float]:
    """Each token's weight repeated ``len(vocab[id])`` times."""
    expanded: List[float] = []
    for token_id, att in zip(encoded_ids, attention_sequence):
        expanded.extend([float(att)] * len(vocab[int(token_id)]))
    return expanded


def _host(attn) -> np.ndarray:
    if isinstance(attn, torch.Tensor):
        return attn.detach().float().cpu().numpy()
    return np.asarray(attn, np.float32)


def interpreter(
    forward_fn,
    dataloader,
    tokenizer,
    vocab,
    percentiles: Dict[str, float],
    *,
    signal_shape=(12, 500),
    dev: bool = False,
    max_plots: int = 20,
    out_dir: str = "./pngs/attention",
) -> Dict:
    """Attention attribution over a loader of training-format batches.

    ``forward_fn(batch)`` returns the layer- and head-averaged (B, S, S)
    attention (``models/transformer.mean_attention``) or the eager
    (L, B, H, S, S) stack (averaged here), as a tensor on any device or an
    array.
    """
    signal_seqs, signal_attentions, signal_decodes = [], [], []
    question_seqs, question_attentions = [], []
    answer_seqs, answer_attentions = [], []
    count = 0

    for batch in dataloader:
        if batch is None:
            continue
        seq = np.asarray(batch["tokenized_signal"][0])
        labels = np.asarray(batch["quantized_signal_ids_input"][0]) \
            if "quantized_signal_ids_input" in batch else None
        signal_start, question_start, answer_start = get_component_indices(
            seq, labels, tokenizer
        )
        attn = _host(forward_fn(batch))
        if attn.ndim == 5:  # (L, B, H, S, S) eager stack -> mean over layers and heads
            attn = attn.mean(axis=(0, 2))
        attention = attn[0]  # (S, S)
        seq_len = len(seq)

        signal_seq = seq[signal_start:question_start]
        signal_att = attention[
            signal_start:question_start, signal_start:question_start
        ].mean(axis=0)
        question_seq = seq[question_start:answer_start]
        if len(question_seq) == 0:
            continue
        question_att = attention[
            question_start:answer_start, question_start:answer_start
        ].mean(axis=0)
        answer_seq = seq[answer_start: seq_len - 1]
        if len(answer_seq) == 0:
            continue
        answer_att = attention[
            answer_start: seq_len - 1, answer_start: seq_len - 1
        ].mean(axis=0)

        signal_seqs.append(signal_seq)
        signal_attentions.append(signal_att)
        question_seqs.append(question_seq)
        question_attentions.append(question_att)
        answer_seqs.append(answer_seq)
        answer_attentions.append(answer_att)

        # the signal tokens back to BPE ids through their signal_{id} names
        decoded = tokenizer.decode(signal_seq, skip_special_tokens=True)
        bpe_ids = [int(i) for i in re.findall(r"signal_(\d+)", decoded)]
        expanded = expand_attention(bpe_ids, signal_att, vocab)
        n_samples = int(np.prod(signal_shape))
        arr = np.zeros(n_samples, np.float32)
        arr[: min(len(expanded), n_samples)] = expanded[:n_samples]
        attention_array = arr.reshape(signal_shape)

        signal_decodes.append(decode_text(bpe_ids, vocab))
        answer_tokens = [tokenizer.decode([t]) for t in answer_seq]
        question_tokens = [tokenizer.decode([t]) for t in question_seq]

        if count <= max_plots and "signal" in batch:
            sig = np.asarray(batch["signal"][0])
            for lead in range(signal_shape[0]):
                plot_attention_on_signal(sig, attention_array, lead, count, out_dir)
            plot_text_attention_weights(
                question_tokens + answer_tokens,
                np.concatenate([question_att, answer_att]),
                count,
                out_dir,
            )
        count += 1
        if dev and len(signal_seqs) >= 5:
            break

    return {
        "signal": {
            "sequences": signal_seqs,
            "attentions": signal_attentions,
            "signal": signal_decodes,
        },
        "question": {"sequences": question_seqs, "attentions": question_attentions},
        "answer": {"sequences": answer_seqs, "attentions": answer_attentions},
    }
