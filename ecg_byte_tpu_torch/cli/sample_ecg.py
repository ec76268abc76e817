"""Morphology-stratified sampler CLI: the port of
``ecg_byte_tpu/cli/sample_ecg.py``, with its flags, and ``--device`` for
the clustering (the CUDA card by default; ``--device cpu`` for the CPU).

Writes ``{data_root}/sampled_ecg_files_{n}.txt``, one ECG .npy path per
line, for tokenizer training:

  python -m ecg_byte_tpu_torch.cli.sample_ecg --ecg_dir ./data/mimic_2500/ecg/train
"""

from __future__ import annotations

import argparse
import os


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--ecg_dir', type=str, required=True,
                        help='directory of preprocessed ECG .npy files')
    parser.add_argument('--num_samples', type=int, default=100000)
    parser.add_argument('--max_clusters', type=int, default=100)
    parser.add_argument('--subset_size', type=int, default=10000)
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device of the clustering; default the CUDA card '
                             '(no CPU fallback), "cpu" for the CPU')
    return parser.parse_args(argv)


def main(argv=None):
    # BLAS thread caps like the reference (sample_ecg.py:4-7)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ.setdefault(var, "2")
    args = get_args(argv)

    from ecg_byte_tpu_torch.data.sampler import analyze_morphologies, stratified_sampling

    file_paths, clusters, n_clusters = analyze_morphologies(
        args.ecg_dir, args.max_clusters, args.subset_size, device=args.device)
    print(f"{len(file_paths)} files in {n_clusters} clusters")
    sampled = stratified_sampling(file_paths, clusters, args.num_samples)
    out = os.path.join(args.data_root, f"sampled_ecg_files_{len(sampled)}.txt")
    os.makedirs(args.data_root, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(sampled))
    print(f"Wrote {len(sampled)} paths to {out}")
    return out


if __name__ == "__main__":
    main()
