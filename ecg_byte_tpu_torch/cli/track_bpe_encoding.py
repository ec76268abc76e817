"""BPE token spans over one ECG file, lead by lead, on the host (the port of
``ecg_byte_tpu/cli/track_bpe_encoding.py``, same flags).  The spans come
from the greedy encoding itself; the plots are drawn where matplotlib is
installed.

Example:
  python -m ecg_byte_tpu_torch.cli.track_bpe_encoding --tokenizer data/tokenizer_3500.pkl \
      --ecg_file data/ptb_500/ecg/test/ecg_0_0.npy --percentiles data/ptb_500_dataset_stats.npy
"""

from __future__ import annotations

import argparse

import numpy as np

from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
from ecg_byte_tpu_torch.tokenizer.analysis import quantize_file, track_encoding
from ecg_byte_tpu_torch.utils.viz_utils import plot_bpe_segments


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--tokenizer', type=str, required=True)
    parser.add_argument('--ecg_file', type=str, required=True)
    parser.add_argument('--percentiles', type=str, required=True)
    parser.add_argument('--leads', type=int, nargs='+', default=list(range(12)))
    parser.add_argument('--out_dir', type=str, default='./pngs')
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns ``(ids, segment_map)``."""
    args = get_args(argv)
    _, merges = load_vocab_and_merges(args.tokenizer)
    percentiles = np.load(args.percentiles, allow_pickle=True).item()
    signal = np.load(args.ecg_file)
    text = quantize_file(args.ecg_file, percentiles)
    ids, segment_map = track_encoding(text, merges)
    print(f"{len(text)} symbols -> {len(ids)} tokens "
          f"({len(text) / max(len(ids), 1):.2f}x)")
    seg_len = signal.shape[-1]
    for lead in args.leads:
        plot_bpe_segments(signal, segment_map, lead, seg_len, args.out_dir)
    print(f"Plots written to {args.out_dir}")
    return ids, segment_map


if __name__ == "__main__":
    main()
