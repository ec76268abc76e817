"""End-to-end entry point: ECG-token LLM training and inference.

The port of ``ecg_byte_tpu/cli/main.py`` with the same flags and artifact
layout (``runs/<seed>/<cfg>/``: ``best_model.pt``, ``crash_model.pt``, the
loss record, the per-seed result JSONs).

- Training (the default): LoRA (``--peft``) or full fine-tuning of the
  chosen model on the dataset's train split, a validation pass per epoch,
  early stopping, the best model saved on each improvement and a crash save
  on every exit (SIGTERM included).  ``main()`` returns the training
  summary.
- ``--inference``: each test record is packed into a prompt, left-padded to
  a multiple of 128 tokens, greedily decoded for up to 128 new tokens,
  detokenized and scored, over 5 seeds; LoRA adapters of a ``--peft``
  checkpoint are merged into the base first.  ``main()`` returns the
  serving summary.

Options the port does not have yet exit with the ``ROADMAP.md`` item that
brings them.

Examples:
  python -m ecg_byte_tpu_torch.cli.main --model llama-3.2-1b --dataset ptb_500 \
      --tokenizer_check tokenizer_3500 --percentiles ./data/ptb_500_dataset_stats.npy \
      --peft --online_encode --batch_size 4 --pad_to_max 1020
  python -m ecg_byte_tpu_torch.cli.main --inference --peft --model llama-3.2-1b \
      --dataset ptb_500 --tokenizer_check tokenizer_3500 \
      --percentiles ./data/ptb_500_dataset_stats.npy --checkpoint <cfg-dir-name>
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from ecg_byte_tpu_torch.cli.common import build_model, make_log_fn, make_run_dir, set_seed
from ecg_byte_tpu_torch.data import DataConfig, DataLoader, ECGTokenDataset
from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.infer.evaluate import tester
from ecg_byte_tpu_torch.models.lora import count_params, merge_lora
from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
from ecg_byte_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_weights,
    save_checkpoint,
    save_crash_checkpoint,
    snapshot_state,
)
from ecg_byte_tpu_torch.train.runner import trainer, validater
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step
from ecg_byte_tpu_torch.utils.file_utils import (
    align_signal_text_files,
    ensure_directory_exists,
    sample_N_percent_from_lists,
)
from ecg_byte_tpu_torch.utils.metrics import early_stopping, run_statistical_analysis
from ecg_byte_tpu_torch.utils.viz_utils import plot_train_val_loss

# options the port does not have yet -> the ROADMAP.md item that ports them
_NOT_PORTED = {
    "int8_decode": "int8 serving, ROADMAP.md queue 1, item 10",
    "no_merge_lora": "serving with LoRA adapters attached, ROADMAP.md queue 1, item 3",
    "dis": "multi-GPU (DDP), ROADMAP.md queue 1, item 12",
    "hf_weights": "HF checkpoint ingest, ROADMAP.md queue 1, item 6",
    "profile": "the torch profiler, ROADMAP.md queue 1, item 14",
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
    if not args.inference and not args.online_encode:
        raise SystemExit(
            "training without --online_encode needs the device token cache, whose BPE "
            "kernels (longest_match, greedy_chain) are not ported yet: ROADMAP.md queue 1, "
            "item 9; pass --online_encode to encode each record on the host"
        )
    for flag, where in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet: {where}")


def _install_sigterm_handler():
    """Turn SIGTERM into an exception, so the crash save in ``finally`` runs
    on a preemption too."""

    def handler(signum, frame):
        raise KeyboardInterrupt("SIGTERM")

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread


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
    """Run the CLI.  Training returns ``{"training": summary}``; inference
    returns the serving summary, the per-record timings and generated token
    ids, and the statistical analysis."""
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
        percentiles=args.percentiles, inference=args.inference,
    )
    if args.inference:
        return _serve(args, params, config, tokenizer, vocab, merges, data_cfg, device)
    return _train(args, params, config, tokenizer, vocab, merges, data_cfg, device)


def _serve(args, params, config, tokenizer, vocab, merges, data_cfg, device):
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    test_signals, test_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/test",
        f"{args.data_root}/{args.dataset}/text/test",
    )
    if args.toy:
        test_signals, test_texts = sample_N_percent_from_lists(test_signals, test_texts, 0.25)
    print(len(test_signals), len(test_texts))
    test_data = ECGTokenDataset(
        test_signals, test_texts, vocab, merges, tokenizer=tokenizer, args=data_cfg
    )
    test_loader = DataLoader(
        test_data, batch_size=args.eval_batch_size, shuffle=False, pad_id=pad_id,
    )

    ckpt_dir = f"./runs/{args.seed}/{args.checkpoint}"
    # the checkpoint is the same for every seed, so it loads once
    params, lora = load_weights(ckpt_dir, "best_model", params, peft=bool(args.peft))
    if lora is not None:
        # fold the adapters into the base: decode then reads one weight set
        params = merge_lora(params, lora, config)
        del lora
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


def _train(args, params, config, tokenizer, vocab, merges, data_cfg, device):
    optimizer = make_optimizer(
        config.hidden_size, args.warmup, beta1=args.beta1, beta2=args.beta2,
        eps=args.eps, weight_decay=args.weight_decay,
    )
    lora_generator = torch.Generator(device=device).manual_seed(args.seed)
    state = create_train_state(config, optimizer, lora_generator, peft=bool(args.peft),
                               params=params)
    del params
    print(f"Trainable parameters: {count_params(state.trainable)}")
    _install_sigterm_handler()
    directory_path = make_run_dir(args)
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    train_signals, train_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/train",
        f"{args.data_root}/{args.dataset}/text/train",
    )
    val_signals, val_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/val",
        f"{args.data_root}/{args.dataset}/text/val",
    )
    if args.toy:
        train_signals, train_texts = sample_N_percent_from_lists(train_signals, train_texts, 0.25)
        val_signals, val_texts = sample_N_percent_from_lists(val_signals, val_texts, 0.25)
    print(len(train_signals), len(val_signals))
    training_loader = DataLoader(
        ECGTokenDataset(train_signals, train_texts, vocab, merges, tokenizer=tokenizer,
                        args=data_cfg),
        batch_size=args.batch_size, shuffle=True, seed=args.seed, pad_id=pad_id,
    )
    validation_loader = DataLoader(
        ECGTokenDataset(val_signals, val_texts, vocab, merges, tokenizer=tokenizer,
                        args=data_cfg),
        batch_size=args.batch_size, shuffle=False, pad_id=pad_id,
    )
    step_fn = make_train_step(config, optimizer, remat=args.remat)
    eval_fn = make_eval_step(config)
    log_fn = make_log_fn(args)
    ensure_directory_exists(directory_path)
    # LoRA dropout draws its per-layer seeds from this host generator
    rng = torch.Generator().manual_seed(args.seed)

    start_epoch = 0
    if args.resume:
        state, last_epoch = load_checkpoint(directory_path, args.resume, state)
        start_epoch = last_epoch + 1
        print(f"Resumed {args.resume} at epoch {start_epoch} (step {state.step})")

    train_loss, val_loss = [], []
    steps = tokens = 0
    # a crash save falls back on the host copy of the last epoch boundary
    # when the live state was cut mid-step; its epoch is the last one
    # completed (-1: none), and --resume starts after it
    last_completed = snapshot_state(state)
    last_completed_epoch = start_epoch - 1
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, args.epochs):
            state, train_dic = trainer(
                state, step_fn, training_loader, rng, epoch=epoch,
                directory_path=directory_path, dev=args.dev, toy=args.toy,
                log_fn=log_fn, desc=f"Training {args.model}",
            )
            steps += train_dic["steps"]
            tokens += train_dic["tokens"]
            train_loss.append(train_dic["average_loss"])
            print(f"Training - Epoch: {epoch+1}\nTrain Loss: {train_dic['average_loss']}")
            val_dic = validater(
                state, eval_fn, validation_loader, epoch=epoch, dev=args.dev,
                log_fn=log_fn, desc=f"Validating {args.model}",
            )
            val_loss.append(val_dic["average_loss"])
            print(f"Validating - Epoch: {epoch+1}\nVal Loss: {val_dic['average_loss']}")
            if log_fn:
                log_fn({"train_epoch_loss": train_dic["average_loss"],
                        "val_epoch_loss": val_dic["average_loss"], "epoch": epoch})
            last_completed = snapshot_state(state)
            last_completed_epoch = epoch
            if early_stopping(val_loss, patience=args.patience, delta=0.01):
                print("Validation loss has stopped decreasing. Early stopping...")
                break
            if val_dic["average_loss"] <= min(val_loss):
                save_checkpoint(directory_path, "best_model", state, epoch=epoch)
                print(f"Best model saved at epoch: {epoch+1}")
            print("-----------------------------------------------------------")
    except (Exception, KeyboardInterrupt) as e:
        print(f"An error occurred: {e}")
        raise
    finally:
        source = save_crash_checkpoint(
            directory_path, state, last_completed,
            epoch=start_epoch + len(train_loss) - 1, fallback_epoch=last_completed_epoch,
        )
        if source == "snapshot":
            print("The live state was cut mid-step; crash checkpoint saved from the "
                  f"epoch-{last_completed_epoch} snapshot")
        elif source == "none":
            print("WARNING: no savable state for the crash checkpoint")
        plot_train_val_loss(train_loss, val_loss, directory_path)
        print("Training Finished")
    summary = {
        "steps": steps, "seconds": time.perf_counter() - t0, "tokens": tokens,
        "train_loss": train_loss, "val_loss": val_loss, "start_epoch": start_epoch,
        "directory": directory_path,
    }
    print(f"Training on {device}: {json.dumps(summary)}")
    return {"training": summary}


if __name__ == "__main__":
    main()
