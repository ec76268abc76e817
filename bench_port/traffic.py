"""The one traffic generator: ECG-Byte training items and serving prompts
from a workload file's parameters and a seed.

Every batch holds the same set of true lengths, ``lengths.min`` to
``lengths.max`` spread evenly over the batch, in an order drawn from the
seed, so every seed asks the same work of the program and only the token
ids, the order and the question and answer lengths change.

A training item is laid out as ``data/datasets.ECGTokenDataset`` lays it
out: left pads, bos, ``<sig_start>``, signal tokens, ``<sig_end>``, the
question, the answer and eos, ``pad_to_max + 4`` positions in all; the
labels are -100 up to the answer; the position ids count the valid
positions from 0 with pads at 0.  A serving prompt is bos,
``<sig_start>``, signal tokens, ``<sig_end>`` and the question, left-padded
to the longest prompt of its batch and then to a multiple of ``bucket``
positions, as ``cli.main --inference`` pads it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_port.spec import Spec


def _lengths(work: dict, batch: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = work["lengths"]["min"], work["lengths"]["max"]
    return rng.permutation(np.rint(np.linspace(lo, hi, batch)).astype(np.int64))


def _item(s: Spec, rng, n_sig: int, n_q: int, n_a: int):
    sig = rng.integers(s.text_vocab, s.text_vocab + s.signal_tokens, n_sig)
    question = rng.integers(0, s.text_vocab, n_q)
    answer = rng.integers(0, s.text_vocab, n_a)
    head = np.concatenate([[s.bos, s.sig_start], sig, [s.sig_end], question])
    return head, answer


def _between(rng, bounds) -> int:
    return int(rng.integers(bounds[0], bounds[1] + 1))


def train_batches(s: Spec, work: dict, seed: int, count: int) -> List[Dict[str, np.ndarray]]:
    """``count`` training batches (``input_ids``, ``attn_mask``, ``labels``,
    ``position_ids``: (B, pad_to_max + 4) int32), the same for a seed."""
    rng = np.random.default_rng(seed)
    b, width = work["batch"], work["pad_to_max"] + 4
    out = []
    for _ in range(count):
        ids = np.full((b, width), s.pad, np.int32)
        labels = np.full((b, width), -100, np.int32)
        for row, true_len in enumerate(_lengths(work, b, rng)):
            n_q, n_a = _between(rng, work["question"]), _between(rng, work["answer"])
            n_sig = int(true_len) - 4 - n_q - n_a
            if n_sig < 1 or true_len > width:
                raise ValueError(f"true length {true_len} leaves no signal tokens")
            head, answer = _item(s, rng, n_sig, n_q, n_a)
            seq = np.concatenate([head, answer, [s.eos]])
            ids[row, width - len(seq):] = seq
            labels[row, width - n_a - 1:] = np.concatenate([answer, [s.eos]])
        mask = (ids != s.pad).astype(np.int32)
        pos = np.where(mask == 1, np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        out.append({"input_ids": ids, "attn_mask": mask, "labels": labels, "position_ids": pos})
    return out


def serve_batches(s: Spec, work: dict, seed: int, count: int) -> List[Dict[str, np.ndarray]]:
    """``count`` serving batches: ``input_ids`` and ``attn_mask`` (B, S)
    int32, S the bucketed width, and ``lengths`` (B,) the true prompt
    lengths (the prompt is the last ``lengths[i]`` positions of row i)."""
    rng = np.random.default_rng(seed)
    b, bucket = work["batch"], work["bucket"]
    out = []
    for _ in range(count):
        lengths = _lengths(work, b, rng)
        width = -(-int(lengths.max()) // bucket) * bucket
        ids = np.full((b, width), s.pad, np.int32)
        for row, true_len in enumerate(lengths):
            n_q = _between(rng, work["question"])
            head, _ = _item(s, rng, int(true_len) - 3 - n_q, n_q, 0)
            ids[row, width - len(head):] = head
        out.append({"input_ids": ids, "attn_mask": (ids != s.pad).astype(np.int32),
                    "lengths": lengths})
    return out


def causal_pairs(mask: np.ndarray) -> int:
    """Valid causal (query, key) pairs of a (B, S) validity mask, per head:
    each valid query with the valid keys at or before it."""
    m = mask.astype(np.int64)
    return int((m * np.cumsum(m, axis=1)).sum())
