"""Token usage and encoded-length distribution of a set of ECG files, on the
host (the port of ``ecg_byte_tpu/cli/token_distribution.py``, same flags).
The plots are drawn where matplotlib is installed.

Example:
  python -m ecg_byte_tpu_torch.cli.token_distribution --tokenizer data/tokenizer_3500.pkl \
      --ecg_glob 'data/ptb_500/ecg/train/*.npy' --percentiles data/ptb_500_dataset_stats.npy
"""

from __future__ import annotations

import argparse
import glob

import numpy as np

from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
from ecg_byte_tpu_torch.tokenizer.analysis import analyze_token_distribution
from ecg_byte_tpu_torch.utils.viz_utils import (
    plot_token_length_distribution,
    plot_token_rank_frequency,
)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--tokenizer', type=str, required=True,
                        help='path to tokenizer .pkl')
    parser.add_argument('--ecg_glob', type=str, required=True,
                        help='glob of ECG .npy files')
    parser.add_argument('--percentiles', type=str, required=True)
    parser.add_argument('--num_workers', type=int, default=4)
    parser.add_argument('--limit', type=int, default=None)
    parser.add_argument('--out_dir', type=str, default='./pngs')
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns ``(token counts, encoded lengths)``."""
    args = get_args(argv)
    _, merges = load_vocab_and_merges(args.tokenizer)
    percentiles = np.load(args.percentiles, allow_pickle=True).item()
    paths = sorted(glob.glob(args.ecg_glob))
    if args.limit:
        paths = paths[: args.limit]
    print(f"Analyzing {len(paths)} ECGs")
    counts, lengths = analyze_token_distribution(
        paths, merges, percentiles, args.num_workers
    )
    print(f"Distinct tokens used: {len(counts)}")
    print(f"Mean encoded length: {np.mean(lengths):.1f} "
          f"(min {min(lengths)}, max {max(lengths)})")
    plot_token_rank_frequency(counts, args.out_dir)
    plot_token_length_distribution(lengths, args.out_dir)
    print(f"Plots written to {args.out_dir}")
    return counts, lengths


if __name__ == "__main__":
    main()
