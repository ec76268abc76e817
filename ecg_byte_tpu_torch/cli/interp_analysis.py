"""Interpretability CLI: rebuild the tokenizer and the model, load a port
checkpoint, and attribute each test record's attention to its signal,
question and answer (the port of ``ecg_byte_tpu/cli/interp_analysis.py``,
same flags, and ``--device``).

It loads the weights of ``./runs/{seed}/{checkpoint}/best_model.pt`` (the
port's own checkpoint, LoRA adapters attached), encodes the test split
into the device token cache (the BPE kernels on the card), and runs
``models/transformer.mean_attention``: the layer- and head-averaged
attention, streamed one layer at a time, with the RMSNorm kernel in the
forward and the plain probability path for the attention itself.  The
overlays are drawn under ``./pngs/attention`` where matplotlib is
installed.  ``main()`` returns ``interpreter``'s result with a
``"summary"``: records, forward ms per record (host clock around a
synchronised forward) and the device's peak memory.

Example:
  python -m ecg_byte_tpu_torch.cli.interp_analysis --model llama-3.2-1b --dataset ptb_500 \
      --tokenizer_check tokenizer_3500 --percentiles ./data/ptb_500_dataset_stats.npy \
      --checkpoint <cfg-dir-name>
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ecg_byte_tpu_torch.cli.common import build_model, set_seed
from ecg_byte_tpu_torch.data import DataConfig, DataLoader, ECGTokenDataset
from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.interpret import interpreter
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
from ecg_byte_tpu_torch.train.checkpoint import load_weights
from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default the CUDA card (no CPU '
                             'fallback: pass "cpu" for the plain path)')
    parser.add_argument('--dataset', type=str, default='ptb_500')
    parser.add_argument('--model', type=str, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--dev', action='store_true')
    parser.add_argument('--checkpoint', type=str)
    parser.add_argument('--tokenizer_check', type=str)
    parser.add_argument('--num_merges', type=int, default=3500)
    parser.add_argument('--pad_to_max', type=int, default=1020)
    parser.add_argument('--percentiles', type=str, default=None)
    parser.add_argument('--interpret', action='store_true')
    parser.add_argument('--peft', action='store_true', default=True)
    parser.add_argument('--hf_weights', type=str, default=None)
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--seg_len', type=int, default=500)
    parser.add_argument('--max_plots', type=int, default=20)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    if args.model is None and args.hf_weights:
        args.model = os.path.basename(os.path.normpath(args.hf_weights))
    set_seed(args.seed)
    vocab, merges = load_vocab_and_merges(
        os.path.join(args.data_root, f"{args.tokenizer_check}.pkl")
    )
    params, config, tokenizer = build_model(args.model, vocab, device,
                                            hf_weights=args.hf_weights)
    lora = None
    if args.checkpoint:
        ckpt_dir = f"./runs/{args.seed}/{args.checkpoint}"
        params, lora = load_weights(ckpt_dir, "best_model", params, peft=bool(args.peft))
        print(f"Loaded checkpoint from {ckpt_dir}")

    test_signals, test_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/test",
        f"{args.data_root}/{args.dataset}/text/test",
    )
    data_cfg = DataConfig(
        dataset=args.dataset, pad_to_max=args.pad_to_max,
        percentiles=args.percentiles, inference=False,
    )
    ds = ECGTokenDataset(test_signals, test_texts, vocab, merges, tokenizer=tokenizer,
                         args=data_cfg, cache_tokens=True, device=device)
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    loader = DataLoader(ds, batch_size=1, shuffle=False, pad_id=pad_id)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    forward_s = []

    def forward_fn(batch):
        def field(name):
            return torch.from_numpy(np.asarray(batch[name], np.int32)).to(device)

        t0 = time.perf_counter()
        attn = T.mean_attention(params, config, field("tokenized_signal"), field("attn_mask"),
                                field("position_ids"), lora=lora)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        forward_s.append(time.perf_counter() - t0)
        return attn

    results = interpreter(
        forward_fn, loader, tokenizer, vocab, ds.percentiles,
        signal_shape=(12, args.seg_len), dev=args.dev, max_plots=args.max_plots,
    )
    results["summary"] = {
        "records": len(forward_s),
        "forward_ms_per_record": 1e3 * sum(forward_s) / max(len(forward_s), 1),
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
    }
    print(f"Interpreted {len(results['signal']['sequences'])} samples on {device}: "
          f"{results['summary']}")
    return results


if __name__ == "__main__":
    main()
