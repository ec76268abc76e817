"""Stage-2 finetuning CLI: a frozen stage-1 backbone + an LLM with LoRA.

The port of ``ecg_byte_tpu/cli/finetune.py``: the stage-1 ``best_model.pt``
of the port's ``cli.pretrain`` (``--first_check``) becomes the frozen
backbone, ``<signal>`` joins the tokenizer, the LLM comes from
``cli/common.build_model`` (``--llm`` presets or ``--hf_weights``), and the
fusion projections and LoRA adapters train on the spliced-embedding LM loss
(``models/fusion.py``), with a validation pass per epoch, early stopping,
``best_model`` on each improvement and ``crash_model`` on every exit.
``--inference`` decodes each test record with its prompt consumed as
spliced embeddings (``fusion_generate``), the adapters attached, or merged
and quantized with ``--int8_decode`` (int8 weights and KV cache), and
scores it over 5 seeds with ``tester(two_stage=True)``.

``--device`` defaults to the CUDA card and raises without one; ``--device
cpu`` runs the plain path.  ``--dis`` trains data-parallel as ``cli.main``
does (``cli/dist.py``; ``--batch_size`` is the global batch); serving
ignores it.

Example:
  python -m ecg_byte_tpu_torch.cli.finetune --model resnet_model --llm llama-3.2-1b \
      --dataset ptb_500 --batch_size 4 --pad_to_max 1022 --first_check <stage-1 run dir>
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ecg_byte_tpu_torch.cli import dist
from ecg_byte_tpu_torch.cli.common import build_model, make_log_fn, set_seed
from ecg_byte_tpu_torch.cli.pretrain import backbone_configs, to_device
from ecg_byte_tpu_torch.data.loader import DataLoader
from ecg_byte_tpu_torch.data.two_stage import ECGCLIPFinetune, TwoStageConfig
from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.infer.evaluate import tester
from ecg_byte_tpu_torch.models import fusion as fus
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import resnet1d, vision
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.quantized import quantize_lm_int8
from ecg_byte_tpu_torch.parallel import batches, distributed
from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
from ecg_byte_tpu_torch.train.checkpoint import load_tree, save_tree
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import apply_step
from ecg_byte_tpu_torch.utils.file_utils import (
    align_signal_text_files,
    ensure_directory_exists,
    sample_N_percent_from_lists,
)
from ecg_byte_tpu_torch.utils.metrics import early_stopping, run_statistical_analysis


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--epochs', type=int, default=150)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default the CUDA card (no CPU '
                             'fallback: pass "cpu" for the plain path)')
    parser.add_argument('--dataset', type=str, default='mimic_500')
    parser.add_argument('--model', type=str, default=None,
                        choices=['clip_model', 'vit_model', 'clip_vit_model', 'resnet_model'])
    parser.add_argument('--llm', type=str, default='tiny-llama',
                        help='LLM preset (cli.main --model equivalent)')
    parser.add_argument('--beta1', type=float, default=0.9)
    parser.add_argument('--beta2', type=float, default=0.99)
    parser.add_argument('--eps', type=float, default=1e-8)
    parser.add_argument('--warmup', type=int, default=500)
    parser.add_argument('--weight_decay', type=float, default=1e-2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--patience', type=int, default=5)
    parser.add_argument('--dev', action='store_true')
    parser.add_argument('--inference', action='store_true')
    parser.add_argument('--checkpoint', type=str,
                        help='the stage-2 run dir under runs/<seed>/ to serve (--inference)')
    parser.add_argument('--first_check', type=str, default=None,
                        help='the stage-1 run dir under runs/<seed>/ (cli.pretrain)')
    parser.add_argument('--log', action='store_true')
    parser.add_argument('--dis', action='store_true')
    parser.add_argument('--gpus', type=str, default='0',
                        help='--dis without torchrun: one rank per device listed')
    parser.add_argument('--ports', type=str, default='12357')
    parser.add_argument('--int8_decode', action='store_true',
                        help='serve an int8 copy of the merged LLM with an int8 KV cache')
    parser.add_argument('--toy', action='store_true')
    parser.add_argument('--pad_to_max', type=int, default=1022)
    parser.add_argument('--num_merges', type=int, default=3500)
    parser.add_argument('--tokenizer_check', type=str, default=None)
    parser.add_argument('--percentiles', type=str, default=None)
    parser.add_argument('--hf_weights', type=str, default=None)
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--image_size', type=int, default=224)
    parser.add_argument('--tiny', action='store_true')
    return parser.parse_args(argv)


def backbone_setup(args, generator: torch.Generator):
    """The frozen backbones ``fusion.encoder_embedding`` takes, their widths
    for ``init_fusion``, and the ViT config."""
    vcfg, ccfg, variant = backbone_configs(args.tiny, args.image_size)
    encoders, dims = {}, {}
    if args.model in ("clip_model", "clip_vit_model"):
        encoders["clip"] = (vision.init_clip(generator, ccfg), ccfg)
        dims["clip_dim"] = ccfg.projection_dim
    if args.model in ("vit_model", "clip_vit_model"):
        encoders["vit"] = (vision.init_vit(generator, vcfg), vcfg)
        dims["vit_dim"] = vcfg.hidden_size
    if args.model == "resnet_model":
        encoders["resnet"] = resnet1d.init_resnet(generator, variant)
        dims["resnet_channels"] = encoders["resnet"][2]["out_channels"]
    return encoders, dims, vcfg


def load_stage1(args, encoders, device):
    """Overlay the stage-1 checkpoint of ``cli.pretrain`` on the backbones."""
    if not args.first_check:
        print("No stage-1 checkpoint given; using fresh backbone weights")
        return encoders
    ckpt_dir = f"./runs/{args.seed}/{args.first_check}"
    loaded, _ = load_tree(ckpt_dir, "best_model", device)
    kind = args.model.replace("_model", "")
    if kind == "resnet":
        meta = encoders["resnet"][2]
        encoders["resnet"] = (loaded["trainable"]["resnet"], loaded["bn_state"], meta)
    elif kind in ("clip", "vit"):
        encoders[kind] = (loaded["trainable"], encoders[kind][1])
    else:
        encoders["clip"] = (loaded["trainable"]["clip"], encoders["clip"][1])
        encoders["vit"] = (loaded["trainable"]["vit"], encoders["vit"][1])
    print(f"Loaded stage-1 checkpoint from {ckpt_dir}")
    return encoders


def pad_prompt(batch, pad_id: int):
    """Left-pad ``tokenized_signal2`` / ``attn_mask2`` to a multiple of 64
    positions, as the JAX CLI buckets its prompts (the spliced prompt is
    one longer, 64k + 1: ``ops/attention.causal_attention`` pads such a
    length for the prefill kernel)."""
    seq, mask = np.asarray(batch["tokenized_signal2"]), np.asarray(batch["attn_mask2"])
    pad = -(-seq.shape[1] // 64) * 64 - seq.shape[1]
    if not pad:
        return batch
    return {**batch,
            "tokenized_signal2": np.concatenate(
                [np.full((seq.shape[0], pad), pad_id, seq.dtype), seq], axis=1),
            "attn_mask2": np.concatenate([np.zeros((mask.shape[0], pad), mask.dtype), mask],
                                         axis=1)}


def main(argv=None):
    """Run the CLI; training returns its summary (under ``--dis`` rank 0's,
    with every rank's in ``"ranks"``: ``cli/dist.launch``), inference the
    serving records and the statistical analysis."""
    args = get_args(argv)
    if args.dis and not args.inference:
        return dist.launch(run, args)
    return run(args)


def run(args):
    """The CLI on parsed arguments, in this process (one rank under
    ``--dis``)."""
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    if args.dev:
        args.epochs = 2
    set_seed(args.seed)
    vocab = {}
    if args.tokenizer_check:
        vocab, _ = load_vocab_and_merges(
            os.path.join(args.data_root, f"{args.tokenizer_check}.pkl"))
    llm_params, llm_config, tokenizer = build_model(args.llm, vocab, device,
                                                    hf_weights=args.hf_weights)
    tokenizer.add_tokens(["<signal>"], special_tokens=True)
    llm_params, llm_config = T.resize_embeddings(llm_params, llm_config, len(tokenizer))
    sig_id = tokenizer.convert_tokens_to_ids("<signal>")
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    eos_id = tokenizer.eos_token_id
    directory_path = (
        f"./runs/{args.seed}/{args.model}_{args.llm.replace('/', '-')}_"
        f"{args.dataset}_{args.lr}_{args.warmup}_{args.batch_size}_{args.epochs}_"
        f"{args.pad_to_max}_{args.toy}"
    )
    encoders, dims, vcfg = backbone_setup(args, torch.Generator(device).manual_seed(args.seed))
    encoders = load_stage1(args, encoders, device)
    for t in lora_lib.leaves([llm_params, encoders]):
        t.requires_grad_(False)
    lora = lora_lib.init_lora(llm_config, torch.Generator(device).manual_seed(args.seed + 1),
                              device)
    fusion = fus.init_fusion(torch.Generator(device).manual_seed(args.seed + 2), args.model,
                             llm_config.hidden_size, **dims)
    trainable = {"lora": lora, "fusion": fusion}
    for t in lora_lib.leaves(trainable):
        t.requires_grad_(True)
    print(f"Trainable parameters: {lora_lib.count_params(trainable)}")
    data_cfg = TwoStageConfig(dataset=args.dataset, pad_to_max=args.pad_to_max,
                              percentiles=args.percentiles, inference=args.inference,
                              model=args.model, num_patches=vcfg.num_patches,
                              image_size=args.image_size, seed=args.seed)
    run = dict(args=args, device=device, llm=(llm_params, llm_config), tokenizer=tokenizer,
               ids=(sig_id, pad_id, eos_id), encoders=encoders, trainable=trainable,
               data_cfg=data_cfg)
    if args.inference:
        return _serve(**run)
    return _train(directory_path=directory_path, **run)


def _serve(args, device, llm, tokenizer, ids, encoders, trainable, data_cfg):
    llm_params, llm_config = llm
    sig_id, pad_id, eos_id = ids
    split = args.dataset
    test_signals, test_texts = align_signal_text_files(
        f"{args.data_root}/{split}/ecg/test", f"{args.data_root}/{split}/text/test")
    if args.toy:
        test_signals, test_texts = sample_N_percent_from_lists(test_signals, test_texts, 0.25)
    loader = DataLoader(ECGCLIPFinetune(test_signals, test_texts, tokenizer=tokenizer,
                                        args=data_cfg),
                        batch_size=1, shuffle=False, pad_id=pad_id)
    ckpt_dir = f"./runs/{args.seed}/{args.checkpoint}"
    # the checkpoint is the same for every seed, so it loads once
    trainable, _ = load_tree(ckpt_dir, "best_model", device)
    params, lora = llm_params, trainable["lora"]
    if args.int8_decode:
        # fold the stage-2 adapters into the base, then serve int8 (the
        # embedding the splice reads stays as it is)
        params, lora = quantize_lm_int8(lora_lib.merge_lora(llm_params, lora, llm_config),
                                        llm_config), None
    records = []

    def generate_fn(batch):
        stats = {}
        out = fus.fusion_generate(
            params, llm_config, trainable["fusion"], args.model,
            to_device(pad_prompt(batch, pad_id), device), sig_id,
            lora=lora, encoders=encoders, max_new_tokens=128, eos_token_id=eos_id,
            pad_token_id=pad_id, int8_kv=args.int8_decode, stats=stats)
        stats["tokens"] = out.cpu().numpy()
        records.append(stats)
        toks = [int(t) for t in stats["tokens"][0]]
        if eos_id in toks:
            toks = toks[: toks.index(eos_id)]
        return tokenizer.decode([t for t in toks if t != pad_id], skip_special_tokens=True)

    all_results = []
    for seed in (0, 42, 123, 456, 789):
        set_seed(seed)
        res = tester(generate_fn, loader, two_stage=True, dev=args.dev, device=device)
        all_results.append(res)
        with open(f"{ckpt_dir}/seed_{seed}_results_{args.dataset}.json", "w") as f:
            json.dump({"averages": res["metrics"], "metric_modes": res["metric_modes"],
                       "qa_results": res["qa_results"]}, f)
    stats = run_statistical_analysis(all_results)
    with open(f"{ckpt_dir}/statistical_analysis_{args.dataset}.json", "w") as f:
        json.dump(stats, f)
    print("Inference Complete")
    return {"records": records, "statistics": stats}


def _train(args, device, llm, tokenizer, ids, encoders, trainable, data_cfg, directory_path):
    llm_params, llm_config = llm
    sig_id, pad_id, _ = ids
    split = args.dataset

    def files(part):
        return align_signal_text_files(f"{args.data_root}/{split}/ecg/{part}",
                                       f"{args.data_root}/{split}/text/{part}")

    (train_signals, train_texts), (val_signals, val_texts) = files("train"), files("val")
    if args.toy:
        train_signals, train_texts = sample_N_percent_from_lists(train_signals, train_texts, 0.25)
        val_signals, val_texts = sample_N_percent_from_lists(val_signals, val_texts, 0.25)
    # under --dis each rank's loader takes its rows of every global batch
    train_loader = batches.make_loader(
        ECGCLIPFinetune(train_signals, train_texts, tokenizer=tokenizer, args=data_cfg),
        args.batch_size, shuffle=True, seed=args.seed, pad_id=pad_id)
    val_loader = batches.make_loader(
        ECGCLIPFinetune(val_signals, val_texts, tokenizer=tokenizer, args=data_cfg),
        args.batch_size, shuffle=False, pad_id=pad_id)
    spec = make_optimizer(llm_config.hidden_size, args.warmup, beta1=args.beta1,
                          beta2=args.beta2, eps=args.eps, weight_decay=args.weight_decay)
    optimizer, scheduler = spec.build(lora_lib.leaves(trainable))
    distributed.broadcast_(lora_lib.leaves(trainable))  # every rank from rank 0's
    # LoRA dropout draws its per-layer seeds from this host generator
    dropout = torch.Generator().manual_seed(args.seed + 3)

    def measure(batch):
        ids = batch["tokenized_signal"]
        return (fus.label_count(ids, batch["quantized_signal_ids_input"], sig_id),
                int(np.asarray(ids).size))

    def loss_fn(step, generator):
        """This rank's loss (its share of the global mean under --dis), or
        zero without rows (the dropout seeds drawn as the others draw them)."""
        if len(step.batch["tokenized_signal"]) == 0:
            T.dropout_seeds(llm_config, llm_config.num_layers, trainable["lora"], generator)
            return None
        return fus.fusion_lm_loss(llm_params, llm_config, trainable["fusion"], args.model,
                                  to_device(step.batch, device), sig_id, lora=trainable["lora"],
                                  dropout_generator=generator, encoders=encoders,
                                  rows=step.rows, count=step.n_valid)

    ensure_directory_exists(directory_path)
    log_fn = make_log_fn(args)
    train_loss, val_loss, steps = [], [], 0
    failed = False
    t0 = time.perf_counter()
    try:
        for epoch in range(args.epochs):
            train_loader.set_epoch(epoch)
            total, n = 0.0, 0
            for step in batches.steps(train_loader, measure):
                if step is None:
                    continue
                loss = apply_step(lora_lib.leaves(trainable), lambda: loss_fn(step, dropout),
                                  optimizer, scheduler, spec.clip_norm)
                total += loss.item()
                n += 1
                if args.dev and n >= 10:
                    break
            steps += n
            train_loss.append(total / max(n, 1))
            if log_fn:
                log_fn({"train_epoch_loss": train_loss[-1], "epoch": epoch})
            print(f"Training - Epoch: {epoch+1}\nTrain Loss: {train_loss[-1]}")
            total, n = 0.0, 0
            with torch.no_grad():
                for step in batches.steps(val_loader, measure):
                    if step is None:
                        continue
                    loss = loss_fn(step, None)
                    if loss is None:
                        loss = torch.zeros((), device=device)
                    total += distributed.sum_over_ranks(loss).item()
                    n += 1
                    if args.dev and n >= 10:
                        break
            val_loss.append(total / max(n, 1))
            if log_fn:
                log_fn({"val_epoch_loss": val_loss[-1], "epoch": epoch})
            print(f"Validating - Epoch: {epoch+1}\nVal Loss: {val_loss[-1]}")
            # the losses are global, so the ranks agree; one all-reduced
            # flag makes sure of it
            if distributed.any_rank(early_stopping(val_loss, patience=args.patience,
                                                   delta=0.01)):
                print("Validation loss has stopped decreasing. Early stopping...")
                break
            if distributed.any_rank(val_loss[-1] <= min(val_loss)):
                save_tree(directory_path, "best_model", trainable, epoch=epoch)
                print(f"Best model saved at epoch: {epoch+1}")
    except BaseException:
        failed = True
        raise
    finally:
        # a failed rank's peers may be gone: no barrier on the way out
        save_tree(directory_path, "crash_model", trainable, epoch=len(train_loss),
                  wait=not failed)
        print("Training Finished")
    summary = {"steps": steps, "seconds": time.perf_counter() - t0, "train_loss": train_loss,
               "val_loss": val_loss, "directory": os.path.normpath(directory_path)}
    print(f"Finetuning on {device}: {json.dumps(summary)}")
    return {"training": summary}


if __name__ == "__main__":
    main()
