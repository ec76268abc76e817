"""Preprocess CLI: the port of ``ecg_byte_tpu/cli/preprocess_ecg.py``, with
its flags and flow (mimic / ptb / ecg_qa_*), and ``--device``.

Raw WFDB records -> ``{data_root}/{data}_{seg_len}/{ecg,text}/{split}``
segment archives, and for seg_len 2500 ``{data}_dataset_stats.npy`` (the
percentiles the tokenizer and the datasets read).  Splits as the reference:
70/12/18 by two seeded splits (preprocess_ecg.py:38-40; ``utils/sk``'s
exact copy of scikit-learn's); the records are filtered, denoised and
resampled in batches on the device (the CUDA card by default; ``--device
cpu`` for the CPU).

  python -m ecg_byte_tpu_torch.cli.preprocess_ecg --data mimic \\
      --instances_json ./data/mimic/conversations.json --seg_len 2500
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ecg_byte_tpu_torch.data.preprocess import (
    PreprocessArgs,
    compute_global_stats,
    preprocess_ptb,
    process_and_save_split,
    setup_ecg_qa,
)
from ecg_byte_tpu_torch.utils.sk import train_test_split


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--data', type=str, required=True,
                        choices=['mimic', 'ptb', 'ecg_qa_mimic', 'ecg_qa_ptb'])
    parser.add_argument('--seg_len', type=int, default=2500)
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--instances_json', type=str, default=None,
                        help='mimic: path to the conversations JSON')
    parser.add_argument('--ecg_qa_glob', type=str, default=None,
                        help='ecg_qa_*: glob of template JSON files')
    parser.add_argument('--ptb_folder', type=str, default=None)
    parser.add_argument('--ptb_task', type=str, default='superdiagnostic',
                        choices=['all', 'diagnostic', 'subdiagnostic',
                                 'superdiagnostic', 'form', 'rhythm'],
                        help='PTB-XL label aggregation task '
                             '(preprocess_utils.py:519-593)')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default the CUDA card (no CPU '
                             'fallback), "cpu" for the CPU')
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    pargs = PreprocessArgs(data=args.data, seg_len=args.seg_len, data_root=args.data_root,
                           batch_size=args.batch_size, device=args.device)

    if args.data == 'ptb':
        preprocess_ptb(args.ptb_folder, pargs, task=args.ptb_task)
        return

    if args.data == 'mimic':
        with open(args.instances_json) as f:
            instances = json.load(f)
    else:  # ecg_qa_*
        instances = setup_ecg_qa(glob.glob(args.ecg_qa_glob))
    print(f"{len(instances)} instances")

    # 70/12/18 split, seed 42 (preprocess_ecg.py:38-40)
    train, rest = train_test_split(instances, test_size=0.3, random_state=42)
    if len(rest) >= 3:
        val, test = train_test_split(rest, test_size=0.6, random_state=42)
    else:  # degenerate tiny datasets
        val, test = rest[:1], rest[1:]
    print(f"train {len(train)} val {len(val)} test {len(test)}")

    if args.seg_len == 2500:
        stats = compute_global_stats(train, pargs)
        np.save(os.path.join(args.data_root, f"{args.data}_dataset_stats.npy"), stats)
        print(f"stats: {stats}")

    for split_name, split in (("train", train), ("val", val), ("test", test)):
        process_and_save_split(split, split_name, pargs)


if __name__ == "__main__":
    main()
