"""End-to-end entry point: ECG question answering with a KV-cache LLM.

The port of ``ecg_byte_tpu/cli/main.py`` with the same flags.  The
``--inference`` branch works as there: each test record is packed into a
prompt, left-padded to a multiple of 128 tokens, greedily decoded for up to
128 new tokens, detokenized and scored, over 5 seeds, with the per-seed
and statistical-analysis JSONs written beside the checkpoint.  Options the
port does not have yet exit with the ``ROADMAP.md`` item that brings them.

Example:
  python -m ecg_byte_tpu_torch.cli.main --inference --model llama-3.2-1b \
      --dataset ptb_500 --tokenizer_check tokenizer_3500 \
      --percentiles ./data/ptb_500_dataset_stats.npy --checkpoint <cfg-dir-name>
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ecg_byte_tpu.tokenizer import load_vocab_and_merges
from ecg_byte_tpu.utils.file_utils import (
    align_signal_text_files,
    sample_N_percent_from_lists,
)
from ecg_byte_tpu.utils.metrics import run_statistical_analysis
from ecg_byte_tpu_torch.cli.common import build_model, set_seed
from ecg_byte_tpu_torch.data import DataConfig, DataLoader, ECGTokenDataset
from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.infer.evaluate import tester
from ecg_byte_tpu_torch.train.checkpoint import load_checkpoint

# options the port does not have yet -> the ROADMAP.md item that ports them
_NOT_PORTED = {
    "int8_decode": "int8 serving, ROADMAP.md queue 1, item 10",
    "peft": "LoRA adapters, ROADMAP.md queue 1, item 3",
    "no_merge_lora": "LoRA adapters, ROADMAP.md queue 1, item 3",
    "dis": "multi-GPU (DDP), ROADMAP.md queue 1, item 12",
    "hf_weights": "HF checkpoint ingest, ROADMAP.md queue 1, item 6",
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('--epochs', type=int, default=150)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default the CUDA card (no CPU '
                             'fallback: pass "cpu" for the plain path)')
    parser.add_argument('--dataset', type=str, default='mimic_500')
    parser.add_argument('--model', type=str, default=None)
    parser.add_argument('--beta1', type=float, default=0.9)
    parser.add_argument('--beta2', type=float, default=0.99)
    parser.add_argument('--eps', type=float, default=1e-8)
    parser.add_argument('--warmup', type=int, default=500)
    parser.add_argument('--weight_decay', type=float, default=1e-2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--patience', type=int, default=5)
    parser.add_argument('--dev', action='store_true')
    parser.add_argument('--inference', action='store_true')
    parser.add_argument('--checkpoint', type=str)
    parser.add_argument('--log', action='store_true')
    parser.add_argument('--dis', action='store_true')
    parser.add_argument('--tokenizer_check', type=str)
    parser.add_argument('--num_merges', type=int, default=1000)
    parser.add_argument('--pad_to_max', type=int, default=1000)
    parser.add_argument('--gpus', type=str, default='0')
    parser.add_argument('--ports', type=str, default='12355')
    parser.add_argument('--toy', action='store_true')
    parser.add_argument('--peft', action='store_true', default=None)
    parser.add_argument('--percentiles', type=str, default=None)
    parser.add_argument('--interpret', action='store_true')
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--fsdp', type=int, default=1)
    parser.add_argument('--hf_weights', type=str, default=None)
    parser.add_argument('--profile', type=str, default=None)
    parser.add_argument('--resume', type=str, default=None)
    parser.add_argument('--eval_batch_size', type=int, default=1,
                        help='inference decode batch: rows decode '
                             'independently, identical token streams to '
                             'batch 1')
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--int8_decode', action='store_true')
    parser.add_argument('--no_merge_lora', action='store_true')
    parser.add_argument('--remat', type=str, default='slim',
                        choices=['slim', 'dots', 'full', 'none'])
    parser.add_argument('--online_encode', action='store_true')
    return parser.parse_args(argv)


def _refuse_unported(args) -> None:
    if not args.inference:
        raise SystemExit(
            "training is not ported yet: LoRA, the optimizer and the train "
            "step are ROADMAP.md queue 1, items 3, 4 and 7"
        )
    for flag, where in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet: {where}")


def _summary(records) -> dict:
    """Serving latency over the run, from the host clock."""
    prefill_s = sum(r["prefill_s"] for r in records)
    decode_s = sum(r["decode_s"] for r in records)
    steps = sum(r["decode_steps"] for r in records)
    return {
        "records": len(records),
        "prompt_lens": sorted({r["prompt_len"] for r in records}),
        "prefill_ms_mean": 1e3 * prefill_s / max(len(records), 1),
        "decode_steps": steps,
        "decode_ms_per_step": 1e3 * decode_s / max(steps, 1),
    }


def main(argv=None):
    """Run the CLI.  The inference branch returns the serving summary, the
    per-record timings and generated token ids, and the statistical
    analysis."""
    args = get_args(argv)
    _refuse_unported(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    if args.dev:
        args.epochs = 2
    set_seed(args.seed)

    vocab, merges = load_vocab_and_merges(
        os.path.join(args.data_root, f"{args.tokenizer_check}.pkl")
    )
    t0 = time.perf_counter()
    params, config, tokenizer = build_model(args.model, vocab, device)
    print(f"Model {args.model}: vocab={config.vocab_size} "
          f"hidden={config.hidden_size} layers={config.num_layers} on {device} "
          f"(build {time.perf_counter() - t0:.1f}s)")

    data_cfg = DataConfig(
        dataset=args.dataset, pad_to_max=args.pad_to_max,
        percentiles=args.percentiles, inference=True,
    )
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    test_signals, test_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/test",
        f"{args.data_root}/{args.dataset}/text/test",
    )
    if args.toy:
        test_signals, test_texts = sample_N_percent_from_lists(
            test_signals, test_texts, 0.25
        )
    print(len(test_signals), len(test_texts))
    test_data = ECGTokenDataset(
        test_signals, test_texts, vocab, merges, tokenizer=tokenizer, args=data_cfg
    )
    test_loader = DataLoader(
        test_data, batch_size=args.eval_batch_size, shuffle=False, pad_id=pad_id,
    )

    ckpt_dir = f"./runs/{args.seed}/{args.checkpoint}"
    # the checkpoint is the same for every seed, so it loads once
    params = load_checkpoint(ckpt_dir, "best_model", params, device)
    eos_id = tokenizer.eos_token_id
    records = []

    def generate_fn(batch):
        ids = np.asarray(batch["tokenized_signal"], np.int32)
        mask = np.asarray(batch["attn_mask"], np.int32)
        # bucket prompt lengths to multiples of 128 with left padding, as
        # the JAX CLI does (there to bound recompiles)
        bucket = -(-ids.shape[1] // 128) * 128
        pad = bucket - ids.shape[1]
        if pad:
            ids = np.concatenate(
                [np.full((ids.shape[0], pad), pad_id, np.int32), ids], axis=1
            )
            mask = np.concatenate(
                [np.zeros((mask.shape[0], pad), np.int32), mask], axis=1
            )
        stats = {}
        out = greedy_generate(
            params, config,
            torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device),
            max_new_tokens=128, eos_token_id=eos_id, pad_token_id=pad_id,
            stats=stats,
        )
        stats["tokens"] = out.cpu().numpy()
        records.append(stats)

        def detok(row):
            toks = [int(t) for t in row]
            if eos_id in toks:
                toks = toks[: toks.index(eos_id)]
            toks = [t for t in toks if t != pad_id]
            return tokenizer.decode(toks, skip_special_tokens=True)

        texts = [detok(row) for row in stats["tokens"]]
        return texts if args.eval_batch_size > 1 else texts[0]

    seeds = [0, 42, 123, 456, 789]
    all_seed_results = []
    for seed in seeds:
        print(f"Setting Seed to {seed}")
        set_seed(seed)
        seed_results = tester(generate_fn, test_loader, dev=args.dev)
        all_seed_results.append(seed_results)
        with open(f"{ckpt_dir}/seed_{seed}_results_{args.dataset}.json", "w") as f:
            json.dump({"averages": seed_results["metrics"],
                       "metric_modes": seed_results["metric_modes"],
                       "qa_results": seed_results["qa_results"]}, f)
    stats_results = run_statistical_analysis(all_seed_results)
    with open(f"{ckpt_dir}/statistical_analysis_{args.dataset}.json", "w") as f:
        json.dump(stats_results, f)
    for metric, stats in stats_results.items():
        print(f"\n{metric}: mean {stats['mean']:.2f} std {stats['std']:.2f} "
              f"95% CI [{stats['conf_interval'][0]:.2f}, {stats['conf_interval'][1]:.2f}]")
    summary = _summary(records)
    print(f"Serving on {device}: {json.dumps(summary)}")
    print("Inference Complete")
    return {"serving": summary, "records": records, "statistics": stats_results}


if __name__ == "__main__":
    main()
