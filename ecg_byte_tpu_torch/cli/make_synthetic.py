"""Synthetic dataset generator: the port's copy of ``ecg_byte_tpu/cli/make_synthetic.py``.

Builds a reference-layout dataset tree (``{name}/{ecg,text}/{split}/`` with
``ecg_i_j.npy`` + ``text_i_j.json``), the dataset stats and a sampled-file
list from synthetic 12-lead ECG-like signals with class-dependent reports.
For the same arguments it writes the same bytes as the JAX package's
generator.

  python -m ecg_byte_tpu_torch.cli.make_synthetic --data_root ./data --n_train 24
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--name', type=str, default='ptb_500')
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--n_train', type=int, default=160)
    parser.add_argument('--n_val', type=int, default=24)
    parser.add_argument('--n_test', type=int, default=24)
    parser.add_argument('--seg_len', type=int, default=500)
    parser.add_argument('--seed', type=int, default=0)
    return parser.parse_args(argv)


def make_signal(rng, fast: bool, seg_len: int) -> np.ndarray:
    """12-lead ECG-like segment: baseline wander + QRS-ish spikes + noise."""
    t = np.arange(seg_len)
    period = max(seg_len // 10, 4) if fast else max(seg_len // 3, 8)
    spikes = ((t % period) == 0).astype(np.float32) * 2.0
    base = 0.4 * np.sin(2 * np.pi * t / max(seg_len // 2, 2))
    sig = base + spikes
    return (sig[None] + 0.03 * rng.normal(size=(12, seg_len))).astype(np.float32)


def main(argv=None):
    args = get_args(argv)
    rng = np.random.default_rng(args.seed)
    root = os.path.join(args.data_root, args.name)
    train_paths = []
    for split, n in (("train", args.n_train), ("val", args.n_val), ("test", args.n_test)):
        os.makedirs(os.path.join(root, "ecg", split), exist_ok=True)
        os.makedirs(os.path.join(root, "text", split), exist_ok=True)
        for i in range(n):
            fast = i % 2 == 0
            sig = make_signal(rng, fast, args.seg_len)
            p = os.path.join(root, "ecg", split, f"ecg_{i}_0.npy")
            np.save(p, sig)
            report = "The heart rate is fast." if fast else "The heart rate is slow."
            with open(os.path.join(root, "text", split, f"text_{i}_0.json"), "w") as f:
                json.dump(report, f)
            if split == "train":
                train_paths.append(p)

    allsig = np.stack([np.load(p) for p in train_paths])
    stats = {
        "global_min": float(allsig.min()),
        "global_max": float(allsig.max()),
        "percentile_1": float(np.percentile(allsig, 1)),
        "percentile_99": float(np.percentile(allsig, 99)),
        "skipped_instances": 0,
    }
    np.save(os.path.join(args.data_root, f"{args.name}_dataset_stats.npy"), stats)
    with open(os.path.join(args.data_root, f"sampled_ecg_files_{len(train_paths)}.txt"), "w") as f:
        f.write("\n".join(train_paths))
    print(f"Wrote {args.n_train}/{args.n_val}/{args.n_test} train/val/test "
          f"records under {root}")
    print(f"Stats: {stats}")


if __name__ == "__main__":
    main()
