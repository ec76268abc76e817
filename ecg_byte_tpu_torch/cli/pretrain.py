"""Stage-1 pretraining CLI: clip | vit | clip_vit | resnet backbones.

The port of ``ecg_byte_tpu/cli/pretrain.py``: the same flags, run-directory
fingerprint (``runs/<seed>/<cfg>``), train-only loop and per-epoch
``best_model`` checkpoint (``best_model.pt``: ``{"trainable", "bn_state"}``).
The backbones are ``models/vision.py`` and ``models/resnet1d.py`` at their
published widths (``--tiny`` for the tests); ``resnet`` trains the MERL
head against a frozen text encoder (``--text_encoder``: a local BERT
checkpoint, else the hash encoder) whose embeddings are computed on the
run's device.  The optimizer is ``train/scheduler``'s.

``--device`` defaults to the CUDA card and raises without one; ``--device
cpu`` runs the plain path.  ``--dis`` trains data-parallel as ``cli.main``
does (``cli/dist.py``; ``--batch_size`` is the global batch): BatchNorm
takes the global batch's statistics and the contrastive losses see the
global batch, so each step is one process's on the same global batch.

Example:
  python -m ecg_byte_tpu_torch.cli.pretrain --model resnet --dataset ptb_500 \
      --batch_size 128 --dev
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ecg_byte_tpu_torch.cli import dist
from ecg_byte_tpu_torch.cli.common import make_log_fn, set_seed
from ecg_byte_tpu_torch.data.text_tokenizer import ByteTextTokenizer
from ecg_byte_tpu_torch.data.two_stage import ECGCLIPPretrain, TwoStageConfig
from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.models import encoders as enc
from ecg_byte_tpu_torch.models import resnet1d, vision
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.parallel import batches, distributed
from ecg_byte_tpu_torch.train.checkpoint import save_tree
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import apply_step
from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files, ensure_directory_exists


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('--epochs', type=int, default=150)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default the CUDA card (no CPU '
                             'fallback: pass "cpu" for the plain path)')
    parser.add_argument('--dataset', type=str, default='mimic_500')
    parser.add_argument('--model', type=str, default=None,
                        choices=['clip', 'vit', 'clip_vit', 'resnet'])
    parser.add_argument('--beta1', type=float, default=0.9)
    parser.add_argument('--beta2', type=float, default=0.99)
    parser.add_argument('--eps', type=float, default=1e-8)
    parser.add_argument('--warmup', type=int, default=500)
    parser.add_argument('--weight_decay', type=float, default=1e-2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--patience', type=int, default=5)
    parser.add_argument('--dev', action='store_true')
    parser.add_argument('--checkpoint', type=str)
    parser.add_argument('--log', action='store_true')
    parser.add_argument('--dis', action='store_true')
    parser.add_argument('--gpus', type=str, default='0')
    parser.add_argument('--ports', type=str, default='12356')
    parser.add_argument('--percentiles', type=str, default=None)
    parser.add_argument('--data_root', type=str, default='./data')
    parser.add_argument('--image_size', type=int, default=224)
    parser.add_argument('--tiny', action='store_true',
                        help='tiny backbone configs for smoke tests')
    parser.add_argument('--text_encoder', type=str, default=None,
                        help='local MedCPT/BERT checkpoint dir for the frozen MERL '
                             'text tower (vocab.txt tokenized by the in-repo WordPiece)')
    parser.add_argument('--allow_hash_text_encoder', action='store_true',
                        help='degrade to the hash text encoder when the --text_encoder '
                             'checkpoint fails to load (default: raise)')
    return parser.parse_args(argv)


def backbone_configs(tiny: bool, image_size: int):
    """(ViT config, CLIP config, ResNet variant) at the published widths, or
    the tiny ones of ``--tiny``."""
    if tiny:
        vcfg = vision.tiny_vision_config(image_size=image_size,
                                         patch_size=max(image_size // 4, 8))
        ccfg = vision.ClipConfig(
            vision=vcfg,
            text=vision.ClipTextConfig(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4,
                                       intermediate_size=64, max_length=77),
            projection_dim=24,
        )
        return vcfg, ccfg, "resnet18"
    vcfg = vision.VisionConfig(image_size=image_size)
    ccfg = vision.ClipConfig(vision=vision.VisionConfig(image_size=image_size, patch_size=32))
    return vcfg, ccfg, "resnet101"


def build_backbone(args, generator: torch.Generator, signal_len: int):
    """(trainable, static, loss_fn, hidden size for the Noam schedule).

    ``loss_fn(trainable, static, batch, dropout_generator, rows=None) ->
    (loss, new_static)``; ``static`` is the ResNet's BatchNorm state (else
    {}); ``rows`` the rank's rows of the global batch (``--dis``).  For
    ``resnet`` the frozen text encoder is ``loss_fn.text_encoder``."""
    device = generator.device
    vcfg, ccfg, variant = backbone_configs(args.tiny, args.image_size)
    if args.model == 'clip':
        params = vision.init_clip(generator, ccfg)

        def loss_fn(p, static, batch, gen, rows=None):
            out = vision.clip_forward(p, ccfg, batch["clip_input_ids"], batch["clip_att_mask"],
                                      batch["clip_pixel"], return_loss=True, rows=rows)
            return out["loss"], static

        return params, {}, loss_fn, 768
    if args.model == 'vit':
        params = vision.init_vit(generator, vcfg)

        def loss_fn(p, static, batch, gen, rows=None):
            return vision.vit_mim_loss(p, vcfg, batch["vit_pixel"], batch["mask"]), static

        return params, {}, loss_fn, vcfg.hidden_size
    if args.model == 'clip_vit':
        params = {"clip": vision.init_clip(generator, ccfg), "vit": vision.init_vit(generator, vcfg)}

        def loss_fn(p, static, batch, gen, rows=None):
            clip = vision.clip_forward(p["clip"], ccfg, batch["clip_input_ids"],
                                       batch["clip_att_mask"], batch["clip_pixel"],
                                       return_loss=True, rows=rows)
            mim = vision.vit_mim_loss(p["vit"], vcfg, batch["vit_pixel"], batch["mask"])
            return clip["loss"] + mim, static

        return params, {}, loss_fn, vcfg.hidden_size
    if args.model == 'resnet':
        rp, rs, meta = resnet1d.init_resnet(generator, variant)
        with torch.no_grad():  # the attention pool's spatial dim: the feature length
            probe, _ = resnet1d.resnet_forward(rp, rs, meta,
                                               torch.zeros(1, 12, signal_len, device=device))
        head = enc.init_merl_head(generator, feature_channels=meta["out_channels"],
                                  spacial_dim=probe.shape[-1])
        text_encoder = enc.load_frozen_text_encoder(
            args.text_encoder, allow_hash_fallback=args.allow_hash_text_encoder, device=device)

        def loss_fn(p, bn_state, batch, gen, rows=None):
            feats, new_bn = resnet1d.resnet_forward(p["resnet"], bn_state, meta,
                                                    batch["norm_signal"], train=True, rows=rows)
            loss, _ = enc.merl_pretrain_loss(p["head"], feats, batch["text_emb"],
                                             dropout_generator=gen, rows=rows)
            return loss, new_bn

        loss_fn.text_encoder = text_encoder
        return {"resnet": rp, "head": head}, rs, loss_fn, 256
    raise ValueError(args.model)


def _no_tokens(batch):
    return 0, 0


def to_device(batch, device):
    """Array and tensor fields of a collated batch as tensors on ``device``:
    float64 as float32 (the JAX package's arrays are 32-bit), lists left
    out."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            continue
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if t.dtype == torch.float64:
            t = t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


def main(argv=None):
    """Run the CLI; returns the training summary (under ``--dis`` rank 0's,
    with every rank's in ``"ranks"``: ``cli/dist.launch``)."""
    args = get_args(argv)
    if args.dis:
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
    directory_path = (
        f"./runs/{args.seed}/{args.model}_{args.dataset}_{args.lr}_{args.beta1}_"
        f"{args.beta2}_{args.eps}_{args.weight_decay}_{args.warmup}_"
        f"{args.batch_size}_{args.epochs}"
    )
    ensure_directory_exists(directory_path)
    train_signals, train_texts = align_signal_text_files(
        f"{args.data_root}/{args.dataset}/ecg/train", f"{args.data_root}/{args.dataset}/text/train")
    print(len(train_signals), len(train_texts))
    signal_len = np.load(train_signals[0]).shape[-1]

    generator = torch.Generator(device=device).manual_seed(args.seed)
    trainable, static, loss_fn, hidden = build_backbone(args, generator, signal_len)
    text_encoder = getattr(loss_fn, "text_encoder", None)
    # a local BERT tokenizes the reports with its own WordPiece vocabulary
    tokenizer = getattr(text_encoder, "tokenizer", None) or ByteTextTokenizer()
    patch = args.image_size // 4 if args.tiny else 16
    data_cfg = TwoStageConfig(dataset=args.dataset, model=args.model, percentiles=args.percentiles,
                              num_patches=(args.image_size // patch) ** 2,
                              image_size=args.image_size, seed=args.seed)
    loader = batches.make_loader(
        ECGCLIPPretrain(train_signals, train_texts, tokenizer=tokenizer, args=data_cfg),
        args.batch_size, shuffle=True, seed=args.seed)
    for t in leaves(trainable):
        t.requires_grad_(True)
    distributed.broadcast_(leaves(trainable))  # every rank from rank 0's
    spec = make_optimizer(hidden, args.warmup, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
                          weight_decay=args.weight_decay)
    optimizer, scheduler = spec.build(leaves(trainable))
    dropout = torch.Generator(device=device).manual_seed(args.seed + 1)
    log_fn = make_log_fn(args)
    train_loss, steps = [], 0
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        total, n = 0.0, 0
        for step in batches.steps(loader, _no_tokens):
            if step is None:
                continue
            batch = step.batch
            if text_encoder is not None:
                batch["text_emb"] = text_encoder(batch.pop("resnet_input_ids"),
                                                 batch.pop("resnet_att_mask")).float()
            batch, out = to_device(batch, device), {}

            def step_loss():
                loss, out["static"] = loss_fn(trainable, static, batch, dropout, step.rows)
                return loss

            loss = apply_step(leaves(trainable), step_loss, optimizer, scheduler, spec.clip_norm)
            static = out["static"]
            total += loss.item()
            n += 1
            if log_fn:
                log_fn({"train_step_loss": loss.item()})
            if args.dev and n >= 10:
                break
        steps += n
        train_loss.append(total / max(n, 1))
        if log_fn:
            log_fn({"train_epoch_loss": train_loss[-1], "epoch": epoch})
        print(f"Training - Epoch: {epoch+1}\nTrain Loss: {train_loss[-1]}")
        save_tree(directory_path, "best_model", {"trainable": trainable, "bn_state": static},
                  epoch=epoch)
        print(f"Model saved at epoch: {epoch+1}")
        print("-----------------------------------------------------------")
    summary = {"steps": steps, "seconds": time.perf_counter() - t0, "train_loss": train_loss,
               "directory": os.path.normpath(directory_path)}
    print(f"Pretraining on {device}: {json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
