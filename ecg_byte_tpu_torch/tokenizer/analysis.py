"""Token-level analysis on the host: usage distributions and encoding spans.

The port of ``ecg_byte_tpu/tokenizer/analysis.py`` (``quantize_file``,
``analyze_token_distribution``, ``track_encoding``), on the port's own C++
trie encoder, as the JAX package runs them on the host.  Spans come from
the greedy longest-match encoding itself: each token covers
``len(vocab[id])`` symbols.
"""

from __future__ import annotations

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from ecg_byte_tpu_torch.ops.quantize import quantized_to_string
from ecg_byte_tpu_torch.tokenizer import native
from ecg_byte_tpu_torch.tokenizer.bpe import build_vocab


def quantize_file(path: str, percentiles) -> str:
    """An ECG ``.npy`` file as its a-z symbol string (numpy, float32)."""
    signal = np.load(path)
    lo = percentiles["percentile_1"] - 0.5
    hi = percentiles["percentile_99"] + 0.5
    clipped = np.clip((signal - lo) / (hi - lo + 1e-6), 0.0, 1.0)
    q = np.minimum(np.floor(clipped * 26), 25).astype(np.uint8)
    return quantized_to_string(q)


def analyze_token_distribution(
    paths: Sequence[str], merges, percentiles, num_workers: int = 4
) -> Tuple[Counter, List[int]]:
    """Token counts over all files and each file's encoded length."""
    encoder = native.NativeEncoder(merges)

    def one(path):
        ids = encoder.encode(quantize_file(path, percentiles).encode("ascii"))
        return Counter(ids.tolist()), len(ids)

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        results = list(ex.map(one, paths))
    token_counts: Counter = Counter()
    token_lengths: List[int] = []
    for count, length in results:
        token_counts.update(count)
        token_lengths.append(length)
    return token_counts, token_lengths


def track_encoding(text: str, merges) -> Tuple[List[int], List[Tuple[int, int]]]:
    """The encoding of ``text`` and each token's (start, end) symbol span."""
    encoder = native.NativeEncoder(merges)
    vocab = build_vocab(merges)
    ids = encoder.encode(text.encode("utf-8")).tolist()
    segment_map: List[Tuple[int, int]] = []
    pos = 0
    for token_id in ids:
        length = len(vocab[int(token_id)])
        segment_map.append((pos, pos + length))
        pos += length
    return ids, segment_map
