"""Tokenizer training CLI: the port of ``ecg_byte_tpu/cli/train_tokenizer.py``,
with its flags and flow.

Builds the corpus (the sampled files' symbol strings concatenated, no
separators), learns BPE merges in the native C++ core, reports the
compression ratio, pickles ``(vocab, merges)`` to
``<out_dir>/tokenizer_<num_merges>.pkl``, and runs the round-trip check on
``--check_file`` (encode then decode must give the symbol string back; the
largest signal reconstruction error is printed, and the lead plotted where
matplotlib is installed).  It runs on the host.

  python -m ecg_byte_tpu_torch.cli.train_tokenizer --train --num_merges 3500 \\
      --sampled_files ./data/sampled_ecg_files_160.txt \\
      --percentiles ./data/ptb_500_dataset_stats.npy --out_dir ./data
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ecg_byte_tpu_torch.ops.quantize import quantized_to_string, string_to_quantized
from ecg_byte_tpu_torch.tokenizer import (
    byte_pair_encoding,
    decode_text,
    encode_text,
    load_vocab_and_merges,
    save_vocab_and_merges,
)
from ecg_byte_tpu_torch.utils.viz_utils import plot_original_vs_decoded


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--num_merges', type=int, default=3500)
    parser.add_argument('--sampled_files', type=str, default=None,
                        help='path to .txt list of sampled ecg .npy files')
    parser.add_argument('--num_processes', type=int, default=2)
    parser.add_argument('--percentiles', type=str, default=None)
    parser.add_argument('--train', action='store_true', default=None)
    parser.add_argument('--loaded', type=str, default=None)
    parser.add_argument('--check_file', type=str, default=None,
                        help='ECG .npy used for the round-trip check')
    parser.add_argument('--out_dir', type=str, default='./data')
    return parser.parse_args(argv)


def process_ecg_to_string(path: str, percentiles) -> str:
    """Quantize one ECG file to its symbol string, in numpy as the JAX CLI
    does (tokenizer_utils.py:56-59)."""
    signal = np.load(path)
    lo = percentiles["percentile_1"] - 0.5
    hi = percentiles["percentile_99"] + 0.5
    clipped = np.clip((signal - lo) / (hi - lo + 1e-6), 0.0, 1.0)
    q = np.minimum(np.floor(clipped * 26), 25).astype(np.uint8)
    return quantized_to_string(q)


def build_corpus(sampled_files: str, percentiles, num_workers: int, n=None) -> str:
    with open(sampled_files) as f:
        paths = [line.strip() for line in f if line.strip()]
    if n is not None:
        paths = paths[:n]
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        strings = list(ex.map(lambda p: process_ecg_to_string(p, percentiles), paths))
    return "".join(strings)


def main(argv=None):
    """Run the CLI; returns the path of the tokenizer it trained or loaded."""
    args = get_args(argv)
    percentiles = np.load(args.percentiles, allow_pickle=True).item()
    tokenizer_file_name = None

    if args.train:
        corpus = build_corpus(args.sampled_files, percentiles, args.num_processes)
        print(f"Total symbols: {len(corpus)}")
        start = time.time()
        ids, vocab, merges = byte_pair_encoding(corpus, args.num_merges)
        print(f"Byte pair encoding executed in {time.time()-start:.2f} seconds")
        print(f"Original length: {len(corpus)}")
        print(f"Encoded length: {len(ids)}")
        print(f"Compression ratio: {len(corpus) / max(len(ids), 1):.2f}X")
        print(f"Vocabulary size: {len(vocab)}")
        os.makedirs(args.out_dir, exist_ok=True)
        tokenizer_file_name = os.path.join(args.out_dir, f"tokenizer_{args.num_merges}.pkl")
        save_vocab_and_merges(vocab, merges, tokenizer_file_name)
        print(f"Vocabulary and merges saved to {tokenizer_file_name}")

    if args.loaded is None:
        args.loaded = tokenizer_file_name
    loaded_vocab, loaded_merges = load_vocab_and_merges(args.loaded)
    print(f"Loaded vocabulary and merges from {args.loaded}")

    if args.check_file:
        new_ecg_signal = np.load(args.check_file)
        new_ecg_text = process_ecg_to_string(args.check_file, percentiles)
        encoded = encode_text(new_ecg_text, loaded_merges)
        print(f"Tokens: {len(encoded)}; compression "
              f"{len(new_ecg_text) / max(len(encoded), 1):.2f}X")
        decoded = decode_text(encoded, loaded_vocab)
        print(f"Round-trip exact: {decoded == new_ecg_text}")
        lo = percentiles["percentile_1"] - 0.5
        hi = percentiles["percentile_99"] + 0.5
        q = string_to_quantized(decoded, new_ecg_signal.shape)
        decoded_signal = q / 25.0 * (hi - lo) + lo
        max_diff = np.max(np.abs(new_ecg_signal - decoded_signal))
        print(f"Maximum difference between original and decoded: {max_diff}")
        plot_original_vs_decoded(decoded_signal, new_ecg_signal, lead_index=5)
    return args.loaded


if __name__ == "__main__":
    main()
