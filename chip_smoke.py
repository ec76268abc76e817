#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines, in the order they run:

1. Device: the card, its power limit, TF32 off.
2. Build: the CUDA kernels compile from ``ecg_byte_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and the host BPE library from
   ``ecg_byte_tpu_torch/csrc/host``.  Then, on the host, two synthetic
   datasets and their tokenizers through ``cli.make_synthetic`` and
   ``cli.train_tokenizer``: ``ptb_500`` (12 x 500, 400 merges) for the
   main paths and ``ptb_2500`` (256 records of 12 x 2,500, 3,500 merges);
   and under ``long/`` the long-context data: 12 x 2,500 records (6 train,
   1 val, 2 test) and a 3,500-merge tokenizer of their own, whose prompts
   pass 4,096 tokens.
3. Kernels vs plain: each kernel against its plain PyTorch version at the
   main paths' widths, with the tolerance stated, timed in turns with the
   plain version and one PyTorch library call that computes the same
   function (a yardstick the port never calls), beside the card's bound.
   The flash kernels (forward and backward) at S 4096 and 8192, the
   serving bucket of the long prompts, gpt2's and gemma's heads and a
   ragged S = 4000.  All four attention kernels (tensor-core kernels)
   print each row's rate; the resident ones also run at B4 S1024 with 300
   left-pad positions, at D 128 and with gpt2's heads at S 1040 (rows past
   S), the backward at S 3072 too, and both through the padding of
   ``attention.resident_padded`` at B4 S1004 (cli.main's default
   --pad_to_max 1000) and S504, against plain at the unpadded S.  Both
   forwards are held by
   check_resident_fwd and check_flash_fwd, and at the two training shapes
   a second call of each attention kernel must equal the first
   (torch.equal).  Decode attention (check_decode) also over the long
   serving path's cache (B1 and B4, gemma's heads), there at forced split
   counts too (1, 7 and one range a tile; the B4 cache has range
   boundaries inside its left padding and whole ranges past its filled
   slots), with device times (CUDA graphs) beside the eager ones.  Both
   decode kernels as the decode step calls them, with this token's K/V row
   on a stale cache (check_fused_decode: equal, out and cache bytes, to the
   append followed by the kernel, at every split count and with the row on
   tile and range boundaries, in the last tile and past 5,120), timed
   against that pair.  The int8 kernels: decode attention over the int8
   cache, 1,152 slots and the long one (SDPA on the bf16 cache as yardstick), the int8 weight
   product (cuBLAS on the bf16 weight) on the GEMV kernel and on the
   tensor-core one, each forced at both sides of their threshold and at
   M 1152, up to M 4992 and at gpt2's ragged c_attn (N 4800), and the KV
   quantizer (check_kv_quant: equal to its plain version exactly, at a
   decode step's rows, a prefill's, gemma's D 256 and the long prompt's
   4,992 rows), beside the first design's device times (OLD_KV_QUANT_MS).
   Both RMSNorm kernels at the main paths' rows with llama's stored bf16
   weight and an f32 one (gemma's 1 + w), and at width 1,600 with 1,003
   rows (check_rmsnorm_fwd: 1 bf16 ulp; check_rmsnorm_bwd_dx; dw by
   check_rmsnorm_dw: 1e-3 relative, two calls equal), with device times
   (CUDA graphs) beside the eager ones for kernel, plain and F.rms_norm.
   The two BPE kernels must equal their plain versions exactly, and the
   device encoder's streams the host C++ trie's, at (64, 6,000) and
   (256, 30,000) symbols; the trie is their yardstick.  The match kernel
   there beside the first design's times (OLD_MATCH_MS), and on
   adversarial rows (match_rows: a record that ends inside the longest
   token, runs of one symbol, a 255-symbol token with ids from 8192, a
   table past 65,536 states, compact rows, N not a multiple of 4, 16 or
   the segment) at every (segment, warps) choose_sweep takes and with no
   table rows staged, exactly (check_match).  The chain kernel also on
   adversarial rows (chain_rows: lengths all 1, all 2, all max_len, <= 0
   and past max_len, N = 1, N below the block, a ragged last segment, one
   record past the shared-memory stage), exactly, also at max_len 300 and
   1,024 (its 16-bit stage) and 1,100 (its one-thread walk); and a
   vocabulary whose flat-lead tokens reach a^300 (flat_lead_merges) on
   records with flat runs past 300 symbols: the device encoder equals the
   host trie exactly.
6. Train: ``ecg_byte_tpu_torch.cli.main`` trains a random Llama-3.2-1B at
   full width with LoRA (``--peft --dev``, batch 4 x 1024) on ``ptb_500``,
   its records encoded once into the device token cache; exact launch
   counts of the six training kernels, every cached stream held to the
   host trie's; then the train step timed alone.
4. Serve: ``cli.main --inference --peft --toy`` serves the checkpoint
   phase 6 wrote (one record, 5 seeds), LoRA merged; every serving
   kernel's launch count (none of BPE).
8. Serve int8: ``cli.main --inference --int8_decode --peft --toy`` serves
   the same checkpoint, merged then quantized, with the int8 KV cache;
   every kernel's launch count (each prefill's projections on the
   tensor-core product, each decode step's on the GEMV one).
5. Serving kernel path vs plain path: one prompt plus 32 teacher-forced
   tokens through prefill and decode_step; the logits must agree.
9. The same for the int8 model and cache.  Phases 5, 9 and 12 end with
   the device time and device launches of a decode step
   (``torch.profiler``), and the same with the append run before the
   kernel, as the decode step did before the kernel took the row.
7. Train-step kernel path vs plain path: loss, cross entropy and LoRA
   gradients of 4 items at B1 x 1024 with the kernels, with the plain
   versions and in f32.
10. Long train: ``cli.main --peft --dev --batch_size 1 --pad_to_max 4092``
    on the long data, every step at S = 4096 through the flash kernels;
    exact launch counts (no resident attention), then the train step at
    B1 x 4096 timed alone, its peak memory and its device time by kernel.
11. Long serve: ``cli.main --inference --peft --toy`` on that checkpoint,
    every prompt at least 4,096 tokens, each prefill through the flash
    forward; exact launch counts.
12. The long serving path, kernels vs plain: one long prompt plus 32
    teacher-forced tokens, as phase 5.
13. The long train step, kernels vs plain, as phase 7 at B1 x 4096.  The
    1,024-token paths launch no flash kernel.
14. HF checkpoint: ``cli.make_flagship_fixture`` writes a size-exact
    Llama-3.2-1B directory (2.47 GB of bf16 in one ``model.safetensors``,
    a 128,256-row ``tokenizer.json``); its first tensors read back equal
    (check_readback) and its tokenizer round-trips the dataset's texts
    (check_round_trip).  ``cli.main --hf_weights`` trains with LoRA as
    phase 6 (exact launch counts of both attention and both RMSNorm
    kernels and both BPE kernels), then serves the checkpoint with
    ``--toy`` and BERTScore on a random BERT-base written in the phase
    (exact decode-attention counts; check_bertscore: mode ``local-bert``,
    every F1 in (0, 1]); the BERTScore scorer on the card and on the CPU
    agree within SCORER_TOL (check_scorers).
15. Preprocess: 512 MIMIC-IV-ECG-shaped raw records (WFDB format 16, 12
    leads x 5,000 samples at 500 Hz, 4 bad on purpose) and a PTB-XL folder
    of 32 are written; the chain's operators are built cold (scipy's
    filtfilt and interp1d, the float64 wavelet matrices, their float64
    products on the card); ``preprocess_records`` on a 64-record batch is
    held to float64 scipy (check_rel: FILTER_TOL for the filter and the
    whole chain, RESAMPLE_TOL for the resample), to the port's CPU path
    (CARD_CPU_TOL), its median of |cD4| to numpy's (check_median), and
    timed (CUDA events) beside its bound at the FP32 rate; then
    ``python -m ecg_byte_tpu_torch.cli.preprocess_ecg`` at seg_len 2500
    (stats) and 500, and on the PTB-XL folder, each tree held to its
    expected splits, skip counts, names and texts (check_tree,
    check_skips), ``cli.sample_ecg --max_clusters 100`` on the 2500
    segments, ``cli.train_tokenizer`` (400 merges) on its list with the new
    stats, and the device token cache of ``mimic_500``'s train split, its
    streams equal to the host encoder's (check_token_cache) and its BPE
    launches counted into rows ``bpe_match`` and ``bpe_chain``.
16. Two-stage: ``cli.pretrain --model resnet`` trains ResNet-101 with the
    MERL head and the hash text encoder at batch 128 x (12, 2,500) on
    ``ptb_2500`` (no kernel of the port: the conv is cuDNN's), then
    ``cli.finetune --model resnet_model --llm llama-3.2-1b`` trains LoRA
    and the projection on its frozen backbone at B4 x 1024 (pad_to_max
    1022) and serves the checkpoint (``--inference --toy``) with the bf16
    cache and with ``--int8_decode``; exact launch counts of every kernel
    (rows ``two_stage_train``, ``two_stage_serve``); each step timed alone
    (CUDA events); the fusion train step held to the plain path as phase 7
    holds the main path's (hold_train_paths, the LoRA and projection
    gradients), and its serving, bf16 and int8, as phase 9 holds the main
    path's (hold_logits, teacher-forced logits); ``cli.pretrain
    --model clip_vit`` and a ``cli.finetune --model clip_vit_model`` at the
    published widths (ViT-B/16, CLIP with a ViT-B/32 image tower).
17. ``--dis``: ``cli.main --dis --gpus 0,0`` (two ranks on the card,
    gloo; Llama-3.2-1B with LoRA at a global B4 x 1024, 2 a rank, ``--toy``
    so the second batch of an epoch is one row a rank and the one
    validation record is rank 0's alone) and ``--gpus 0`` (one rank, NCCL,
    this process from torchrun's environment),
    ``cli.pretrain --model resnet --dis`` (ResNet-101 + MERL at a global
    B128 x (12, 2,500)) and ``cli.finetune --dis`` on its checkpoint: each
    rank's exact launch counts (check_dis_ranks, rank_steps: a rank
    without rows runs no forward), the same losses on every rank and every
    checkpoint written by rank 0 alone.  A two-rank harness
    (``parallel.spawn``, ddp_rank) runs the main path's train step on one
    global batch: held with the one-process step (kernels) and the f32
    step by hold_train_paths' rule, the two ranks in the kernel path's
    place; and the pretrain step, held by check_dis_step to the
    one-process step (the loss and the BatchNorm update within
    DDP_F32_TOL: f32 convs with TF32 off on both sides) and to an f64 step
    (each gradient group within DDP_GRAD_RATIO times the one-process
    step's distance from it).  Then each path's step (main, pretrain,
    fusion) and its gradient all-reduce timed with CUDA events, at W = 2
    and (the main path) at W = 1 over NCCL.

18. ``cli.main --peft --dev`` at its default ``--pad_to_max 1000`` (S 1004:
    the resident kernels through the padding) with ``--profile`` and
    ``ECG_BYTE_LOG_MEMORY=1``, exact launch counts, the trace's kernel
    events by wrapper equal to the counters of its epoch loop
    (check_trace_counts: the resident forward and backward and both RMSNorm
    kernels named), its three memory readings in order and within the card's
    memory (check_memory_lines), and its train step held to the plain path
    and f32 as phase 7 holds phase 6's; ``cli.interp_analysis`` on phase 6's
    checkpoint at ``--pad_to_max 1020`` (S 1024) from the device token
    cache, exact launch counts, the streamed layer and head mean held to the
    eager stack's, its rows and pad columns (check_attention_mean) and the
    kernel path's mean to 1.25x the plain path's distance from f32, ms a
    record and peak memory; ``translate_reports`` on 64 German sentences
    with a size-exact random opus-mt-de-en directory (write_random_marian:
    73.9M f32 parameters), held to the port's CPU run of the same directory
    (check_marian_streams: teacher-forced logits within MARIAN_TOL, greedy
    streams equal up to a near tie), sentences/s and ms a decode step;
    ``cli.token_distribution`` and ``cli.track_bpe_encoding`` on the ptb_500
    files, without matplotlib.
19. ``--tp`` and ``--fsdp`` (ranks sharing the card over gloo): ``cli.main
    --dis --gpus 0,0 --tp 2`` and ``--fsdp 2`` at B4 x 1024, exact launch
    counts per rank (under F = 2 each layer's forward runs again in its
    backward), rank 0 alone writing the whole tree, each checkpoint in the
    one-process shapes and served by ``cli.main --inference``; a four-rank
    harness on T = 2 x F = 2 at full width and 2 layers (cut from 4 to make
    room for phase 20) whose steps at B4 x 1024 (resident kernels) and B1 x
    4096 (flash kernels) are held to the one-process step and f32 by
    :func:`hold_train_paths`, with each rank's step ms and the ms of its tp,
    fsdp and data-group collectives (replayed alone); tensor-parallel greedy
    decode at T = 2 on 4 layers (cut from 16), its prefill logits held by
    :func:`hold_logits` and its tokens to one process's
    (:func:`check_tp_stream`).  Phase 3 holds the attention kernels at a
    rank's T = 2 heads (16/4).
20. The norm-folded path (``transformer.fold_norm_scales``) on Llama-3.2-1B
    at full width with its norm weights moved off 1: one LoRA step at B4 x
    1024 on the folded tree and on the classic one, with RMSNorm once a
    forward and once a backward (2L + 1 and 2L on the classic tree) and
    every other kernel as often (check_folded_counts); the folded step held
    by :func:`hold_train_paths` to its plain versions and the folded tree
    in f32, and the folded tree in f32 to the classic tree in f32 beside
    the classic kernel path; both steps timed; greedy decode of the serving
    prompt on both trees in bf16 and with the int8 copy and cache, each
    folded stream held to the classic one by :func:`check_tp_stream`, and
    both trees' logits teacher-forced on the classic stream held by
    :func:`hold_folded_logits` against each tree in f32.

``python3 chip_smoke.py --blame`` runs phases 1 and 2, makes the main and
the long data, and then :func:`blame_phase` alone: a diagnostic that
prints how far each train-path kernel alone, the resident forward's
diagnostic variants and attention witnesses without a kernel move a LoRA
step from f32 under norm weights off 1, the score product's rounding each
way, and the flash path's reading; it holds nothing and prints no result
line.

Every check raises, so any failure exits non-zero.  The next-to-last line
is a JSON object with each kernel's measurements, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Neither JAX nor ``ecg_byte_tpu`` is imported, nor any of
``safetensors``, ``tokenizers``, ``transformers``, ``regex``,
``ml_dtypes``, ``sklearn``, ``pandas``, ``pywt``, ``wfdb``, ``PIL`` and
``optax`` (the end asserts it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "llama-3.2-1b"
NUM_MERGES = 400  # with 500-sample leads: 0.9-1.0k signal tokens, buckets of 1024/1152
SEG_LEN = 500
N_TRAIN = 24  # --dev --batch_size 4: 2 epochs of 6 steps
N_VAL = 2
N_TEST = 2  # --dev decodes 2 records per seed
TEACHER_FORCED = 32
TRAIN_ARGS = ["--peft", "--dev", "--batch_size", "4", "--pad_to_max", "1020"]
# the device BPE encoder's second shape: 256 records of 12 x 2,500, the JAX
# package's preprocessing benchmark (bench.py), with a 3,500-merge tokenizer
BIG = dict(name="ptb_2500", n_train=256, n_val=0, n_test=0, seg_len=2500, num_merges=3500)
# the long-context path: 12 x 2,500 records (the reference preprocessing's
# default segment) with a 3,500-merge tokenizer encode to 4.6-4.9k signal
# tokens, so training items fill --pad_to_max 4092 (S = 4096) and every
# prompt passes 4,096 tokens; the name only selects the Q/A parser
LONG = dict(name="ptb_500", n_train=6, n_val=1, n_test=2, seg_len=2500, num_merges=3500)
LONG_TRAIN_ARGS = ["--peft", "--dev", "--batch_size", "1", "--pad_to_max", "4092"]
CACHE_BATCH = 64  # records per batch of the dataset's token cache
PEAK_FLOPS = 989e12  # dense bf16, H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
# both forwards' out against plain (check_flash_fwd, check_resident_fwd),
# |d|/|ref| over the valid rows and over each row: 2x and 5x the largest
# measured on an H100 with the tensor-core forwards (1.5e-4 at gemma's
# flash row, 1.0e-3 at flash S 4096; the FMA kernels', 10x and 5.7x below,
# set them), where a fault in P.V over the last keys moves the last rows
# by 6% and more
FLASH_OUT_NORM = 3e-4
FLASH_OUT_ROW = 5e-3
# decode attention's out against plain (check_decode), |d|/|ref| over all
# heads and over each (batch row, head): 5.8x and 6x the largest measured
# on an H100 (1.7e-4, 8.4e-4), where a range of the split kernel lost or
# counted twice moves a row by ~1/sqrt(ranges), 11% at 82 ranges
DECODE_OUT_NORM = 1e-3
DECODE_OUT_ROW = 5e-3

SOURCES = {  # kernel -> (route, source, the TPU kernel it replaces)
    "prefill_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_prefill.cu",
                          "ecg_byte_tpu/ops/attention_resident.py:73"),
    "prefill_attention_bwd": ("cuda", "ecg_byte_tpu_torch/csrc/attention_prefill_bwd.cu",
                              "ecg_byte_tpu/ops/attention_resident.py:86"),
    "flash_attention": ("cuda", "ecg_byte_tpu_torch/csrc/flash_attention.cu",
                        "ecg_byte_tpu/ops/flash_attention.py:41"),
    # _bwd_dq_kernel (:93) and _bwd_dkv_kernel (:131): one wrapper call
    "flash_attention_bwd": ("cuda", "ecg_byte_tpu_torch/csrc/flash_attention_bwd.cu",
                            "ecg_byte_tpu/ops/flash_attention.py:93"),
    "decode_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_decode.cu",
                         "ecg_byte_tpu/ops/attention_decode.py:90"),
    "rmsnorm": ("cuda", "ecg_byte_tpu_torch/csrc/rmsnorm.cu", "ecg_byte_tpu/ops/rmsnorm.py:59"),
    "rmsnorm_bwd": ("cuda", "ecg_byte_tpu_torch/csrc/rmsnorm.cu",
                    "ecg_byte_tpu/ops/rmsnorm.py:66"),
    "bpe_match": ("cuda", "ecg_byte_tpu_torch/csrc/bpe_match.cu",
                  "ecg_byte_tpu/ops/bpe_match.py:369"),
    "bpe_chain": ("cuda", "ecg_byte_tpu_torch/csrc/bpe_chain.cu",
                  "ecg_byte_tpu/ops/bpe_match.py:576"),
    # the int8 cache's branch of the decode kernel (_kernel, int8_scales)
    "decode_attention_int8": ("cuda", "ecg_byte_tpu_torch/csrc/attention_decode.cu",
                              "ecg_byte_tpu/ops/attention_decode.py:117"),
    # no Pallas kernel: XLA fuses the dequantization into the dot there; the
    # GEMV kernel at M <= GEMV_MAX_M (decode), the tensor-core one above
    "int8_linear": ("cuda", "ecg_byte_tpu_torch/csrc/int8_linear.cu",
                    "ecg_byte_tpu/models/transformer.py:323"),
    "int8_linear_tc": ("cuda", "ecg_byte_tpu_torch/csrc/int8_linear_tc.cu",
                       "ecg_byte_tpu/models/transformer.py:323"),
    # no Pallas kernel: XLA runs _quant_kv_rows and _append_kv there
    "kv_quant": ("cuda", "ecg_byte_tpu_torch/csrc/kv_quant.cu",
                 "ecg_byte_tpu/models/transformer.py:1013"),
}
LAYERS = 16  # Llama-3.2-1B
# the first chain kernel's times (one thread walked each record), NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, section 6), beside this one's
OLD_CHAIN_MS = {(64, 6000): 0.2193, (256, 30000): 0.2363}
# the first match kernel's (a trie walk from every position), eager and on
# the device (CUDA graphs), the same card (PERF.md, section 6)
OLD_MATCH_MS = {(64, 6000): (0.0307, 0.0134), (256, 30000): (0.1536, 0.1329)}
# the first KV append kernel's device times (a warp a row), the same card
# (PERF.md, section 6)
OLD_KV_QUANT_MS = {(1, 1152, 8, 64): 0.0061, (1, 1, 8, 64): 0.0026}


@dataclasses.dataclass(frozen=True)
class ServePath:
    """A serving path of ``cli.main --inference --peft``: the phase that
    serves the checkpoint, the phase that holds one prompt's logits to the
    plain path, the path's own arguments, and the launches of each kernel
    per prefill, per decode step and per forward (either of them)."""

    key: str  # its name in the kernels line's launches_by_path
    serve_title: str
    check_title: str
    args: tuple
    num_merges: int
    per_prefill: dict
    per_step: dict
    per_forward: dict
    records: int  # records decoded per seed
    min_prompt: int  # tokens in every prompt, at least
    int8: bool = False  # the path check's weights and KV cache int8

    @property
    def kernels(self):
        return tuple({**self.per_prefill, **self.per_step, **self.per_forward})


# per forward 2L + 1 norms; per prefill L attention kernels (the flash
# forward from S 4096 on), per decode step L decode kernels, each of which
# also appends its token's K/V row; with int8, per prefill the 7
# projections of every layer on the tensor-core product (M = the prompt's
# bucket) and one KV append a layer (kv_quant), per decode step the
# projections on the GEMV one (M = 1), per forward the head on the GEMV one
# (the last position only); no BPE kernel (serving encodes on the host).
# --toy decodes a quarter of the test records.
NORMS = {"rmsnorm": 2 * LAYERS + 1}
# phase 4 decodes one record (--toy), as phase 8 does: the script's time limit
SERVE = ServePath(
    "serve", "4. serve: cli.main --inference --peft --toy on phase 6's checkpoint (LoRA merged)",
    f"5. serving kernel path vs plain path: one prompt + {TEACHER_FORCED} teacher-forced tokens",
    ("--toy",), NUM_MERGES, {"prefill_attention": LAYERS}, {"decode_attention": LAYERS}, NORMS,
    records=max(1, int(N_TEST * 0.25)), min_prompt=1024)
SERVE_INT8 = ServePath(
    "serve_int8", "8. serve int8: cli.main --inference --int8_decode --peft --toy on phase 6's "
    "checkpoint (LoRA merged, then quantized; int8 KV cache)",
    f"9. int8 serving kernel path vs plain path: one prompt + {TEACHER_FORCED} teacher-forced "
    "tokens, int8 weights and KV cache",
    ("--int8_decode", "--toy"), NUM_MERGES,
    {"prefill_attention": LAYERS, "int8_linear_tc": 7 * LAYERS, "kv_quant": LAYERS},
    {"decode_attention_int8": LAYERS, "int8_linear": 7 * LAYERS},
    {**NORMS, "int8_linear": 1},
    records=max(1, int(N_TEST * 0.25)), min_prompt=1024, int8=True)
SERVE_LONG = ServePath(
    "serve_long", "11. long serve: cli.main --inference --peft --toy on phase 10's checkpoint "
    "(LoRA merged), prompts of 4,096 tokens and more",
    f"12. long serving kernel path vs plain path: one prompt of 4,096 tokens or more + "
    f"{TEACHER_FORCED} teacher-forced tokens",
    ("--toy",), LONG["num_merges"], {"flash_attention": LAYERS}, {"decode_attention": LAYERS},
    NORMS, records=max(1, int(LONG["n_test"] * 0.25)), min_prompt=4096)


@dataclasses.dataclass(frozen=True)
class TrainCheck:
    """A train-step path check: ``items`` training items of S = pad_to_max
    + 4, each with its own draw of LoRA B, through the kernels (exactly
    ``kernels``), the plain versions and f32 activations."""

    title: str
    pad_to_max: int
    kernels: tuple
    items: int = 4


TRAIN_CHECK = TrainCheck(
    "7. train-step kernel path vs plain path: loss and LoRA gradients at B1 x 1024", 1020,
    ("prefill_attention", "prefill_attention_bwd", "rmsnorm", "rmsnorm_bwd"))
LONG_TRAIN_CHECK = TrainCheck(
    "13. long train-step kernel path vs plain path: loss and LoRA gradients at B1 x 4096", 4092,
    ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"))


_START = time.perf_counter()


def phase(name):
    """A phase's heading, with the script's seconds so far (host clock)."""
    print(f"\n== {name} [at {time.perf_counter() - _START:.1f} s]", flush=True)


# ------------------------------------------------------------------ helpers


def bf16_ulp(y):
    """One bf16 ulp of each value of ``y``: 2^(exponent - 7)."""
    import torch

    _, e = torch.frexp(y.float())  # y = m * 2^e, 0.5 <= |m| < 1
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def time_in_turns(fns, iters):
    """Mean ms per call of each function with CUDA events, after a warm-up,
    in the palindrome order f0, f1, .., fn, fn, .., f1, f0; ``iters`` calls
    each time, or ``iters[i]`` calls of ``fns[i]``."""
    import torch

    if isinstance(iters, int):
        iters = [iters] * len(fns)

    def run(fn, n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    times = [0.0] * len(fns)
    for i in order:
        times[i] += run(fns[i], iters[i]) / 2
    return times


def time_graphed(fns, calls=20, replays=5, stream=None):
    """Device ms per call of each function: ``calls`` calls captured in one
    CUDA graph, its replays timed with CUDA events in turns (as
    :func:`time_in_turns`), so the host's launch cost drops out.  Each is
    warmed and captured on a side stream of its own, or on ``stream``
    (an autograd backward runs on its forward's stream: make the forward
    there)."""
    import torch

    graphs = []
    for fn in fns:
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm: allocations and lazy builds outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(calls):
                fn()
        graphs.append(g)
    return [t / calls for t in time_in_turns([g.replay for g in graphs], replays)]


def bound_ms(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_inputs(qg, k, v, mask):
    """(B, H, S, D) copies for SDPA and the boolean causal & pad mask."""
    import torch

    b, s, kh, g, d = qg.shape
    q4 = qg.reshape(b, s, kh * g, d).transpose(1, 2).contiguous()
    k4, v4 = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    causal = torch.ones(s, s, dtype=torch.bool, device=qg.device).tril()
    return q4, k4, v4, (causal[None] & mask.bool()[:, None, :])[:, None]


def check_attention_bwd(got, want, shape, name="prefill_attention_bwd", tag="K1 bwd"):
    """Hold the kernel's (dq, dk, dv) against the plain backward's and
    return the largest max|d|.  Each must be finite (the left-pad rows
    included) and within two bounds:
    max|d| <= 4e-2 max|ref|, the tolerance of
    tests/test_attention_resident.py:75-81; and |d|/|ref| <= 1e-3 in the
    2-norm.  Causal gradients shrink with the position, so max|ref| comes
    from the first rows and keys and the first bound is loose for the late
    ones; the norm follows the typical element, which the printed median
    |ref| shows.  Both sides round the same f32 sums to bf16, so nearly
    every element agrees exactly: the norm bound sits 10x above the
    largest |d|/|ref| measured on an H100 (9.6e-5, dv at the Llama
    shape)."""
    import torch

    print(f"{name} {shape} against plain:")
    err = 0.0
    for grad, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), f"{tag} {shape}: non-finite {grad}"
        diff = (a - w).abs()
        max_rel = diff.max().item() / w.abs().max().item()
        norm_rel = (torch.linalg.vector_norm(a - w) / torch.linalg.vector_norm(w)).item()
        print(f"  {grad}: max|d|/max|ref| {max_rel:.3e} (bound 4e-2 = "
              f"{4e-2 * w.abs().max().item():.3e}); |d|/|ref| {norm_rel:.3e} (bound 1e-3); "
              f"median |ref| {w.abs().median().item():.3e}")
        assert max_rel <= 4e-2, f"{tag} {shape} {grad}: max|d|/max|ref| {max_rel:.3e}"
        assert norm_rel <= 1e-3, f"{tag} {shape} {grad}: |d|/|ref| {norm_rel:.3e}"
        err = max(err, diff.max().item())
    return err


def check_deterministic(got, again, name, what="dq, dk, dv"):
    """Two calls of a kernel on the same inputs must give the same bits
    (each of the outputs ``what`` names): its kernels use no atomics and
    sum in a fixed order."""
    import torch

    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{name} is not deterministic"
    print(f"  {name}: a second call equals the first (torch.equal, {what})")


def check_resident_fwd(got, want, mask, shape):
    """Hold the resident kernel's out against the plain forward's and return
    max|d| on the valid rows.  It must be finite on every row (a left-pad
    row ends with the mean of V over the keys it visits, never NaN), and on
    the valid rows:

    - allclose(atol=2e-2, rtol=2e-2), the tolerance of
      tests/test_attention_resident.py (bf16 P.V rounding and another
      summation order);
    - |d|/|ref| <= FLASH_OUT_NORM in the 2-norm, and for every query
      position the same over its heads and lanes <= FLASH_OUT_ROW, the
      bounds of check_flash_fwd.  A late row averages V over many keys, so
      its |out| is small and a fault in P.V over the last keys (a key tile
      summed twice or scaled, a wrong V tile) stays inside the allclose
      bound; the row bound follows each row's own size and refuses it."""
    import torch

    assert torch.isfinite(got.float()).all(), f"K1 fwd {shape}: non-finite out"
    valid = mask.bool()  # (B, S); out is (B, S, KH, G, D)
    a, w = got.float()[valid].flatten(1), want.float()[valid].flatten(1)  # (rows, H * D)
    d = a - w
    err = d.abs().max().item()
    norm_rel = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w)).item()
    row_rel = (torch.linalg.vector_norm(d, dim=1) / torch.linalg.vector_norm(w, dim=1)).max().item()
    print(f"prefill_attention {shape}: out on valid rows max|d| {err:.3e} (allclose 2e-2, 2e-2; "
          f"median |ref| {w.abs().median().item():.3e}), |d|/|ref| {norm_rel:.3e} (bound "
          f"{FLASH_OUT_NORM:.0e}), worst row |d|/|ref| {row_rel:.3e} (bound {FLASH_OUT_ROW:.0e})")
    assert torch.allclose(a, w, atol=2e-2, rtol=2e-2), f"K1 fwd {shape}: out not allclose to plain"
    assert norm_rel <= FLASH_OUT_NORM, f"K1 fwd {shape}: out |d|/|ref| {norm_rel:.3e}"
    assert row_rel <= FLASH_OUT_ROW, f"K1 fwd {shape}: out row |d|/|ref| {row_rel:.3e}"
    return err


def check_flash_fwd(got, want, mask, shape):
    """Hold the flash kernel's (out, lse) against the plain forward's and
    return max|d| of out on the valid rows.  Both must be finite on every
    row (a left-pad row ends with lse = -1e30 and the mean of V, never
    NaN), and on the valid rows:

    - out max|d| <= 2e-2 (bf16 P.V rounding and another summation order,
      the bound of the resident kernel's row);
    - |d|/|ref| <= FLASH_OUT_NORM in the 2-norm, and for every query
      position the same over its heads and lanes <= FLASH_OUT_ROW.  With
      unit-variance logits a row over n keys has |out| ~ sqrt(e / n), so
      at S 4096-8192 the max bound is as large as a typical late value;
      the row bound follows each row's own size and refuses a fault in
      P.V over the later key blocks (a wrong V sub-tile, a block summed
      twice), which leaves lse as it is;
    - lse within 1e-4 of max(|lse|, 1) (its f32 scores are summed in
      another order; a row whose max missed a key block is off by far
      more)."""
    import torch

    (out, lse), (p_out, p_lse) = got, want
    assert torch.isfinite(out.float()).all(), f"flash fwd {shape}: non-finite out"
    assert torch.isfinite(lse).all(), f"flash fwd {shape}: non-finite lse"
    valid = mask.bool()  # (B, S); out is (B, S, KH, G, D), lse (B, KH, G, S)
    a, w = out.float()[valid].flatten(1), p_out.float()[valid].flatten(1)  # (rows, H * D)
    d = a - w
    err = d.abs().max().item()
    norm_rel = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w)).item()
    row_rel = (torch.linalg.vector_norm(d, dim=1) / torch.linalg.vector_norm(w, dim=1)).max().item()
    la, lw = lse.permute(0, 3, 1, 2)[valid], p_lse.permute(0, 3, 1, 2)[valid]
    lse_rel = ((la - lw).abs() / lw.abs().clamp_min(1.0)).max().item()
    print(f"flash_attention {shape}: out on valid rows max|d| {err:.3e} (bound 2e-2; median "
          f"|ref| {w.abs().median().item():.3e}), |d|/|ref| {norm_rel:.3e} (bound "
          f"{FLASH_OUT_NORM:.0e}), worst row |d|/|ref| {row_rel:.3e} (bound {FLASH_OUT_ROW:.0e}); "
          f"lse max|d|/max(|lse|, 1) {lse_rel:.3e} (bound 1e-4)")
    assert err <= 2e-2, f"flash fwd {shape}: out max|d| {err:.3e}"
    assert norm_rel <= FLASH_OUT_NORM, f"flash fwd {shape}: out |d|/|ref| {norm_rel:.3e}"
    assert row_rel <= FLASH_OUT_ROW, f"flash fwd {shape}: out row |d|/|ref| {row_rel:.3e}"
    assert lse_rel <= 1e-4, f"flash fwd {shape}: lse relative {lse_rel:.3e}"
    return err


def check_decode(got, want, shape, tag="K2"):
    """Hold decode attention's out (B, 1, H, D) against the plain version's
    and return max|d|.  It must be finite and within max|d| <= 2e-2 (bf16
    rounding of the probabilities and of out, sums in another order: the
    bound of tests/test_attention_decode.py), and |d|/|ref| <= DECODE_OUT_NORM
    in the 2-norm and <= DECODE_OUT_ROW for every (batch row, head).  Over a
    5k cache |out| is ~0.02, so the max bound alone passes a result that
    lost one of the split kernel's ranges; the row bound follows each
    row's own size."""
    import torch

    a, w = got.float(), want.float()
    assert torch.isfinite(a).all(), f"{tag} {shape}: non-finite out"
    d = a - w
    err = d.abs().max().item()
    norm_rel = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w)).item()
    rows = (torch.linalg.vector_norm(d, dim=-1) / torch.linalg.vector_norm(w, dim=-1)).max().item()
    print(f"decode attention {shape}: max|d| {err:.3e} (bound 2e-2; median |ref| "
          f"{w.abs().median().item():.3e}), |d|/|ref| {norm_rel:.3e} (bound "
          f"{DECODE_OUT_NORM:.0e}), worst row |d|/|ref| {rows:.3e} (bound {DECODE_OUT_ROW:.0e})")
    assert err <= 2e-2, f"{tag} {shape}: max|d| {err:.3e}"
    assert norm_rel <= DECODE_OUT_NORM, f"{tag} {shape}: |d|/|ref| {norm_rel:.3e}"
    assert rows <= DECODE_OUT_ROW, f"{tag} {shape}: row |d|/|ref| {rows:.3e}"
    return err


def check_fused_decode(got, want, caches, want_caches, shape):
    """Hold decode attention with this token's row (``fresh_k``, ``fresh_v``
    and ``write_idx`` on a stale cache) to the pair it replaces, the append
    and then the kernel on the updated cache: the output and every cache
    tensor (rows and, with the int8 cache, scales) must be equal bit for
    bit.  The fused kernel writes the row with the append kernel's
    quantizer and attends the same values in the same order."""
    import torch

    assert torch.equal(got, want), f"K2 fresh {shape}: out differs from append + kernel"
    for name, a, w in zip(("k_cache", "v_cache", "k_scale", "v_scale"), caches, want_caches):
        assert torch.equal(a, w), f"K2 fresh {shape}: {name} differs from append + kernel"


def check_rmsnorm_bwd_dx(dx, pdx, x, w, gout, eps, shape):
    """Hold the kernel's RMSNorm dx against the plain one's and return
    max|d|.  dx = r (g w - x r^2 mean(g w x)) is a difference: where its two
    terms nearly cancel, their f32 rounding (sums in another order) shows at
    the small result's ulp.  So every element must be within 2 bf16 ulps of
    the larger of |dx| and the first term |r g w|, and at most 1e-5 of the
    elements may be beyond 2 ulps of dx itself: the looser bound covers the
    rare cancelling elements and nothing more."""
    import torch

    diff = (dx.float() - pdx.float()).abs()
    r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    scale = torch.maximum(pdx.float().abs(), (r * gout.float() * w.float()).abs())
    beyond = int((diff > 2 * bf16_ulp(pdx)).sum())
    print(f"rmsnorm_bwd {shape}: {beyond} of {dx.numel()} elements of dx beyond 2 bf16 ulps "
          f"of dx itself (bound {1e-5 * dx.numel():.0f}: cancellation)")
    assert torch.isfinite(dx.float()).all(), f"K3 bwd {shape}: non-finite dx"
    assert (diff <= 2 * bf16_ulp(scale)).all(), \
        f"K3 bwd {shape}: dx off by more than 2 bf16 ulps of its terms"
    assert beyond <= 1e-5 * dx.numel(), \
        f"K3 bwd {shape}: {beyond} of {dx.numel()} beyond 2 bf16 ulps of dx itself"
    return diff.max().item()


def check_rmsnorm_fwd(got, want, shape):
    """Hold the kernel's RMSNorm output against the plain one's and return
    max|d|.  Both round (x r) w to bf16 from the same f32 products, and r
    differs only by the order of the row's sum of squares and the rsqrt's
    last f32 bits: every element must be finite and within 1 bf16 ulp of
    plain's."""
    import torch

    diff = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all(), f"K3 {shape}: non-finite y"
    assert (diff <= bf16_ulp(want)).all(), f"K3 {shape}: y off by more than 1 bf16 ulp"
    return diff.max().item()


def check_rmsnorm_dw(dw, pdw, again, shape):
    """Hold the kernel's RMSNorm dw against the plain one's and return
    max|d|/max|dw|, which must be at most 1e-3: both sum g x r over the rows
    in f32, in other orders.  ``again``, a second call's dw, must equal the
    first bit for bit: the kernel adds its blocks' partials in a fixed
    order."""
    import torch

    assert torch.isfinite(dw.float()).all(), f"K3 bwd {shape}: non-finite dw"
    rel = ((dw.float() - pdw.float()).abs().max() / pdw.float().abs().max()).item()
    print(f"rmsnorm_bwd {shape}: dw max|d|/max|dw| {rel:.3e} (bound 1e-3)")
    assert rel <= 1e-3, f"K3 bwd {shape}: dw relative {rel:.3e}"
    assert torch.equal(dw, again), f"K3 bwd {shape}: two calls' dw differ"
    return rel


def check_int8_linear(got, want, x, q, scale, bias, shape):
    """Hold the int8 product's output against the plain version's and return
    max|d|.  Both round the same dot to bf16, times the scale, plus the
    bias; the dots are f32 sums in other orders, which differ by at most
    tau = 2 K 2^-24 sum_k |x q| (the deterministic bound of f32 summation).
    So every element must be within 2 bf16 ulps of its magnitude before the
    bias, plus tau times the scale: 2 ulps alone fail only where the dot
    cancels to near 0, and the printed count says how often."""
    import torch
    import torch.nn.functional as F

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    mag = want.abs() if bias is None else torch.maximum(want.abs(), (want - bias.float()).abs())
    terms = F.linear(x.float().abs(), q.float().abs())  # sum_k |x q|, (M, N)
    tau = 2 * x.shape[-1] * 2.0**-24 * terms * scale.float()
    beyond = int((diff > 2 * bf16_ulp(mag)).sum())
    print(f"int8_linear {shape}: {beyond} of {diff.numel()} elements beyond 2 bf16 ulps "
          f"(the dot cancels there); max tau*scale {tau.max().item():.3e}")
    assert torch.isfinite(got).all(), f"int8_linear {shape}: non-finite output"
    assert (diff <= 2 * bf16_ulp(mag) + tau).all(), \
        f"int8_linear {shape}: beyond 2 bf16 ulps + the f32 summation bound"
    return diff.max().item()


def host_streams(signals, p1, p99, merges):
    """Each record's BPE stream by the host path of ``--online_encode``:
    the quantizer on the CPU, then the C++ trie."""
    import torch

    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
    from ecg_byte_tpu_torch.tokenizer import encode_text

    return [encode_text(quantized_to_string(normalize_quantize(torch.from_numpy(s), p1, p99)[1]),
                        merges) for s in signals]


def check_streams(ids, counts, want, what):
    """Hold the device encoder's ``(ids, counts)`` to the host trie's streams
    ``want``, record by record: the same count, the same tokens, and
    PAD_TOKEN after them.  Token ids are integers: the tolerance is zero."""
    from ecg_byte_tpu_torch.ops.bpe_encode import PAD_TOKEN

    ids, counts = ids.cpu(), counts.cpu()
    assert ids.shape[0] == counts.shape[0] == len(want), f"{what}: {len(want)} records"
    for r, w in enumerate(want):
        c = int(counts[r])
        assert c == len(w), f"{what}: record {r} has {c} tokens, the host trie {len(w)}"
        got = ids[r, :c].tolist()
        bad = next((k for k, (a, b) in enumerate(zip(got, w)) if a != b), None)
        assert bad is None, f"{what}: record {r} token {bad} is {got[bad]}, the host trie's {w[bad]}"
        assert (ids[r, c:] == PAD_TOKEN).all(), f"{what}: record {r} is not padded after {c}"


def chain_rows(gen, max_len, device, n=6000, long_n=40_001, threads=512):
    """The chain kernel's adversarial rows, each ``(label, match_len,
    match_tok)`` int32 (B, N) on ``device``, random from ``gen``; ``n`` is
    the common row length (a multiple of 4: the kernel's 16-byte path),
    ``long_n`` one past the kernel's shared-memory stage (its first stage
    on the 16-byte path, its second on the 4-byte one), ``threads`` its
    block (one segment a thread)."""
    import torch

    def rand(b, width, lo=1, hi=max_len):
        return torch.randint(lo, hi + 1, (b, width), generator=gen, device=device,
                             dtype=torch.int32)

    def full(b, v):
        return torch.full((b, n), v, dtype=torch.int32, device=device)

    stops = torch.cat([full(1, 0), full(1, -1), full(1, max_len + 1),
                       rand(2, n, -2, max_len + 1)])
    ones = full(2, 1)
    ones[1, n // 3] = 0
    rows = [("random lengths in [1, max_len]", rand(4, n)),
            ("all lengths 1 (and one 0 at n // 3)", ones),
            ("all lengths 2 (no synchronization)", full(2, 2)),
            ("all lengths max_len", full(2, max_len)),
            ("lengths <= 0 and > max_len (each ends the chain)", stops),
            ("N = 1", rand(3, 1)),
            ("N below the thread count", rand(3, threads // 2 + 3)),
            ("N not a multiple of the segment", rand(3, n + 5)),
            ("B = 1, N past the shared-memory stage", rand(1, long_n))]
    return [(label, ln, torch.randint(0, 70_000, ln.shape, generator=gen, device=device,
                                      dtype=torch.int32)) for label, ln in rows]


FLAT_MAX_LEN = 300  # the flat-lead vocabulary's longest token: past a byte's lengths


def flat_lead_merges(merges, max_len=FLAT_MAX_LEN):
    """``merges`` and the tokens a flat lead merges into: runs of 'a' of 2,
    4, ..., 256 symbols and one of ``max_len``, with ids after the last."""
    nid = max(i for _, i in merges) + 1
    runs = [2 ** k for k in range(1, 9) if 2 ** k < max_len] + [max_len]
    return list(merges) + [([97] * r, nid + j) for j, r in enumerate(runs)]


def flat_lead_records(gen, b, n, max_len=FLAT_MAX_LEN):
    """(b, n) uint8 symbols on the CPU: random ones, each record holding flat
    runs of symbol 0 ('a') of 1 to 2.5 ``max_len`` symbols (one of exactly
    ``max_len``), as a flat lead reads after quantization."""
    import torch

    q = torch.randint(1, 26, (b, n), generator=gen, dtype=torch.uint8)
    for r in range(b):
        p = int(torch.randint(0, 50, (1,), generator=gen))
        first = True
        while p < n:
            run = max_len if first else int(torch.randint(1, 5 * max_len // 2, (1,), generator=gen))
            q[r, p: p + run] = 0
            p += run + int(torch.randint(20, 200, (1,), generator=gen))
            first = False
    return q


def match_rows(rng, merges):
    """The match kernel's adversarial rows, each ``(label, q, merges,
    budget)``: q (B, N) uint8 symbols (numpy, from ``rng``), the vocabulary
    its table is built from and the table's shared-memory budget
    (``build_automaton``'s ``sweep_budget``); ``merges`` is the main path's
    tokenizer.  A record that ends inside the longest token, runs of one
    symbol, a 255-symbol token with ids from 8192 (and a token of a
    non-alphabet byte, skipped), a table past 65,536 states (the wide
    rows), duplicate sequences (the later id wins), N not a multiple of the
    segment, the 16-symbol chunk or 4 (down to N = 1), and two rows whose
    table gets compact rows from a small budget."""
    import numpy as np

    a = ord("a")

    def walk(b, n):
        return (np.abs(np.cumsum(rng.integers(-1, 2, size=(b, n)), axis=1)) % 26).astype(np.uint8)

    def plant(q, seq, at):
        q[at:at + len(seq)] = np.asarray(seq[:len(q) - at], np.uint8)

    longest = max((s for s, _ in merges), key=len)
    longest = [c - a for c in longest]
    ends = walk(8, 6000)
    for r in range(8):  # the record ends after 1, 4, ... symbols of it; once whole mid-record
        plant(ends[r], longest, 6000 - 1 - 4 * r)
        plant(ends[r], longest, 3000)
    runs = [((a,) * (1 << k), 300 + k) for k in range(1, 6)]
    runs_q = np.zeros((3, 6000), np.uint8)
    runs_q[1, 2000:] = 25
    runs_q[2, ::2] = 1
    long_tok = tuple(a + (i * 7) % 26 for i in range(255))
    big_ids = [((a, a + 1), 8192), (long_tok[:40], 9000), (long_tok, 70000),
               ((a, ord("A"), a), 70001), ((a + 3, a + 4, a + 5), 1 << 22)]
    big_q = walk(4, 3000)
    plant(big_q[0], [c - a for c in long_tok], 100)
    plant(big_q[1], [c - a for c in long_tok], 3000 - 200)  # cut by the record's end
    plant(big_q[2], [c - a for c in long_tok[:40]], 1000)
    wide = [(tuple(a + int(c) for c in rng.integers(0, 26, 255)), 9000 + i) for i in range(300)]
    wide_q = walk(3, 4000)
    for r in range(3):
        plant(wide_q[r], [c - a for c in wide[r][0]], 500 * r + 7)
        plant(wide_q[r], [c - a for c in wide[-1 - r][0]], 4000 - 100)
    dup = [((a, a + 1), 256), ((a, a + 1, a + 2), 257), ((a, a + 1, a + 2), 258), ((a, a + 1), 259)]
    from ecg_byte_tpu_torch.ops import bpe_encode

    budget = bpe_encode.SWEEP_SMEM_BUDGET
    # 60% of the main table's full rows: compact rows for its deeper states
    small = bpe_encode.build_sweep_table(bpe_encode._alphabet_tokens(merges)).states * 34
    return [
        ("a record ends inside the longest token", ends, merges, budget),
        ("the same, full and compact rows (two tiers)", ends, merges, small),
        ("runs of one symbol (all a, a then z, b a b a)", runs_q, merges, budget),
        ("the same runs, a vocabulary of a^2 .. a^32", runs_q, runs, budget),
        ("a 255-symbol token, ids from 8192 to 2^22, a non-alphabet token", big_q, big_ids,
         budget),
        ("a table past 65,536 states (wide rows)", wide_q, wide, budget),
        ("duplicate sequences: the later id wins", walk(2, 1000) % 3, dup, budget),
        ("N = 6005 (not a multiple of 4, 16 or the segment)", walk(3, 6005), merges, budget),
        ("the same, full and compact rows", walk(3, 6005), merges, small),
        ("N = 1", walk(3, 1), merges, budget),
        ("N = 7", walk(3, 7), merges, budget),
        ("N = 37", walk(5, 37), merges, budget),
        ("B = 1, N = 30001", walk(1, 30001), merges, budget),
    ]


def sweep_layout(sw):
    """A sweep table's states, rows and bytes, as a phrase."""
    rows = "wide rows" if sw.wide else (
        "narrow rows" if sw.full == sw.states else f"{sw.full} full and "
        f"{sw.states - sw.full} compact narrow rows")
    return f"{sw.states} states ({rows}, {sw.words.numel() * 4 / 1e3:.1f} KB)"


def check_match(got, want, what):
    """Hold the match kernel's ``(match_tok, match_len)`` to the plain
    version's: token ids and lengths are integers, the tolerance is zero;
    names the first position that differs."""
    for name, g, w in (("match_tok", got[0], want[0]), ("match_len", got[1], want[1])):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"{what}: {name} {g.dtype} {tuple(g.shape)}, plain {w.dtype} {tuple(w.shape)}"
        bad = (g.cpu() != w.cpu()).nonzero()
        if len(bad):
            b, p = bad[0].tolist()
            raise AssertionError(f"{what}: {name} at record {b} position {p} is "
                                 f"{int(g[b, p])}, plain {int(w[b, p])} ({len(bad)} positions)")


def check_kv_quant(got, want, what):
    """Hold the KV append's cache rows and scales ``(k_cache, v_cache,
    k_scale, v_scale)`` to the plain version's, exactly: int8 rows and bf16
    scales are the cache's bytes, and decode attention reads them as they
    are.  Names the first (batch row, slot) that differs."""
    names = ("k_cache", "v_cache", "k_scale", "v_scale")
    for name, g, w in zip(names, got, want):
        bad = (g.cpu() != w.cpu()).nonzero()
        if len(bad):
            b, slot = bad[0].tolist()[:2]
            raise AssertionError(f"{what}: {name} differs from the plain version at batch row "
                                 f"{b}, slot {slot} ({len(bad)} values)")


def _chain_plain(match_len, match_tok, max_len):
    """``bpe_match.greedy_chain``'s plain path: the chain, then the sort."""
    from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match

    visited = bpe_match.greedy_chain_plain(match_len, max_len)
    return (visited, *bpe_encode._compact(match_tok, visited))


@functools.lru_cache(maxsize=1)
def _counters():
    """kernel -> (its wrapper, the wrapper's count), the wrappers themselves,
    taken before any plain_path() swap (``ops.counted_wrappers``)."""
    from ecg_byte_tpu_torch.ops import counted_wrappers

    return {name: (fn, attr) for name, fn, attr in counted_wrappers()}


def launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def zero_launches():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


@contextlib.contextmanager
def plain_path(kernels=tuple(SOURCES)):
    """Swap the plain PyTorch versions in for the named kernels' wrappers
    (the autograd functions look their wrappers up when called).  Both
    decode kernels have one wrapper, and both int8 products: naming either
    swaps it."""
    from ecg_byte_tpu_torch.ops import (
        attention,
        attention_decode,
        attention_resident,
        bpe_match,
        flash_attention,
        int8_linear,
        kv_quant,
        rmsnorm,
    )

    _counters()
    decode = (attention_decode, "decode_attention_fused",
              attention_decode.decode_attention_fused_plain)
    product = (int8_linear, "int8_linear", int8_linear.int8_linear_plain)
    swaps = {
        "prefill_attention": (attention_resident, "resident_attention", attention.grouped_attention),
        "prefill_attention_bwd": (attention_resident, "resident_attention_bwd",
                                  attention_resident.resident_attention_bwd_plain),
        "flash_attention": (flash_attention, "flash_attention_fwd",
                            flash_attention.flash_attention_fwd_plain),
        "flash_attention_bwd": (flash_attention, "flash_attention_bwd",
                                flash_attention.flash_attention_bwd_plain),
        "decode_attention": decode,
        "rmsnorm": (rmsnorm, "rmsnorm", rmsnorm.rmsnorm_plain),
        "rmsnorm_bwd": (rmsnorm, "rmsnorm_bwd", rmsnorm.rmsnorm_bwd_plain),
        "bpe_match": (bpe_match, "longest_match", bpe_match.longest_match_plain),
        "bpe_chain": (bpe_match, "greedy_chain", _chain_plain),
        "decode_attention_int8": decode,
        "int8_linear": product,
        "int8_linear_tc": product,
        "kv_quant": (kv_quant, "append_kv", kv_quant.append_kv_plain),
    }
    with contextlib.ExitStack() as stack:
        for swap in {swaps[name][:2]: swaps[name] for name in kernels}.values():
            stack.enter_context(mock.patch.object(*swap))
        yield


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def make_data(root, *, name="ptb_500", n_train=N_TRAIN, n_val=N_VAL, n_test=N_TEST,
              seg_len=SEG_LEN, num_merges=NUM_MERGES):
    """A synthetic dataset tree under ``root/data`` (``cli.make_synthetic``)
    and its BPE tokenizer, ``data/tokenizer_<num_merges>.pkl``, trained on
    its train split by ``cli.train_tokenizer`` (host only, no card needed);
    returns (vocab, merges)."""
    from ecg_byte_tpu_torch.cli import make_synthetic, train_tokenizer
    from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges

    data = os.path.join(root, "data")
    with contextlib.redirect_stdout(sys.stderr):
        make_synthetic.main(["--name", name, "--data_root", data, "--n_train", str(n_train),
                             "--n_val", str(n_val), "--n_test", str(n_test), "--seg_len",
                             str(seg_len), "--seed", "0"])
        path = train_tokenizer.main([
            "--train", "--num_merges", str(num_merges), "--out_dir", data,
            "--sampled_files", os.path.join(data, f"sampled_ecg_files_{n_train}.txt"),
            "--percentiles", os.path.join(data, f"{name}_dataset_stats.npy"),
        ])
    return load_vocab_and_merges(path)


def load_split(root, name, split="train"):
    """The records of a split of ``root/data/<name>`` stacked (B, 12, L)
    float32, and the dataset's (p1, p99)."""
    import numpy as np

    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, _ = align_signal_text_files(f"{data}/{name}/ecg/{split}", f"{data}/{name}/text/{split}")
    stats = np.load(os.path.join(data, f"{name}_dataset_stats.npy"), allow_pickle=True).item()
    return (np.stack([np.load(p) for p in sigs]).astype(np.float32),
            stats["percentile_1"], stats["percentile_99"])


def _cli_args(num_merges=NUM_MERGES):
    return ["--model", MODEL, "--dataset", "ptb_500", "--tokenizer_check",
            f"tokenizer_{num_merges}", "--num_merges", str(num_merges),
            "--percentiles", "data/ptb_500_dataset_stats.npy"]


def _training_items(root, vocab, merges, tokenizer, n, pad_to_max=1020):
    """The first ``n`` packed training items (S = pad_to_max + 4)."""
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset, collate
    from ecg_byte_tpu_torch.train.runner import model_batch
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/train", f"{data}/ptb_500/text/train")
    ds = ECGTokenDataset(sigs[:n], texts[:n], vocab, merges, tokenizer=tokenizer,
                         args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy",
                                         pad_to_max=pad_to_max))
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    return model_batch(collate([ds[i] for i in range(n)], pad_id=pad_id))


def prompt_lengths(root, vocab, merges):
    """The token count of each test record of ``root/data/ptb_500`` as the
    CLI's serving prompt, before it is bucketed to a multiple of 128."""
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.data.text_tokenizer import ByteTextTokenizer, register_ecg_tokens
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    tok = ByteTextTokenizer()
    register_ecg_tokens(tok, vocab)
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/test", f"{data}/ptb_500/text/test")
    ds = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=tok,
                         args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy",
                                         inference=True))
    return [len(ds[i]["tokenized_signal"]) for i in range(len(ds))]


def bucket(n):
    """The CLI's prompt bucket: ``n`` rounded up to a multiple of 128."""
    return -(-n // 128) * 128


# ------------------------------------------------------------------- phases


def device_phase():
    import torch

    phase("1. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    print(smi)
    return name, smi


def build_phase():
    from ecg_byte_tpu_torch.ops import _cuda
    from ecg_byte_tpu_torch.tokenizer import native

    phase("2. build")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"CUDA kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(parallel nvcc + link {_cuda.build_info.get('seconds', 0.0):.1f} s)")
    for line in _cuda.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    t0 = time.perf_counter()
    native.load_library()
    print(f"host BPE library built and loaded in {time.perf_counter() - t0:.1f} s")


def kernels_phase(root, merges, big_merges, serve_prompt):
    """Phase 3; ``serve_prompt`` is the long serving path's (bucket, prompt
    length): the shape of its flash forward and, with 128 new tokens, of
    its decode cache."""
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.ops import attention, attention_resident, rmsnorm

    phase("3. kernels vs plain (and one library call as yardstick)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    report = {name: {"max_abs_err": 0.0, "rows": []} for name in SOURCES}

    def record(name, shape, err, times, flops, nbytes, main, **extra):
        ms, plain_ms, library_ms = times
        b_ms, b_by = bound_ms(flops, nbytes)
        row = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, **extra}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{name} {shape}: max|d| {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library}, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB)" + "".join(f"; {k} {v}" for k, v in extra.items()))
        entry = report[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["rows"].append(row)
        if main:
            entry.update({k: v for k, v in row.items() if k != "max_abs_err"})

    # K1 forward: (B, S, H, KH, D, left pad).  B1 S1024 is the serving
    # path's prefill, B4 S1024 the training path's (also with 300 positions
    # of left padding, more than one key tile); the gpt2, gemma and D128
    # heads; and gpt2's at S 1040 (G = 1 and S not a multiple of 64: the
    # last query and key tiles hold rows past S)
    for b, s, h, kh, d, pad in [(1, 1024, 32, 8, 64, 37), (1, 2048, 32, 8, 64, 37),
                                (4, 1024, 32, 8, 64, 37), (4, 1024, 32, 8, 64, 300),
                                (1, 1024, 25, 25, 64, 37), (1, 256, 8, 1, 256, 37),
                                (1, 1024, 16, 4, 128, 37), (1, 1040, 25, 25, 64, 37),
                                (4, 1024, 16, 4, 64, 37)]:  # a rank's heads at --tp 2
        shape = [b, s, h, kh, d]
        main = (b, s, h, pad) == (4, 1024, 32, 37)
        with torch.inference_mode():
            qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, :pad] = 0
            got = attention_resident.resident_attention(qg, k, v, mask)
            want = attention.grouped_attention(qg, k, v, mask)
            torch.cuda.synchronize()
            err = check_resident_fwd(got, want, mask, shape)
            if main:
                check_deterministic((got,), (attention_resident.resident_attention(qg, k, v, mask),),
                                    "prefill_attention", what="out")
            q4, k4, v4, bmask = sdpa_inputs(qg, k, v, mask)
            times = time_in_turns([
                lambda: attention_resident.resident_attention(qg, k, v, mask),
                lambda: attention.grouped_attention(qg, k, v, mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                       enable_gqa=True),
            ], [20, 10 if b * s <= 2048 else 4, 20])
            pairs = (mask * mask.cumsum(-1)).sum().item() * h  # valid causal (q, t) pairs
            nbytes = 2 * (2 * qg.numel() + k.numel() + v.numel()) + 4 * mask.numel()
            record("prefill_attention", shape, err, times, 4 * d * pairs, nbytes, main=main,
                   left_pad=pad, tflops=round(4 * d * pairs / times[0] / 1e9, 1))
            del q4, k4, v4, bmask

    # K1 backward at the training shape (also with 300 positions of left
    # padding, more than one key tile), the gpt2 / gemma shapes, a D128 one,
    # S 3072 (the port runs the resident kernels up to S 4095) and gpt2's
    # heads at S 1040 (G = 1 and S not a multiple of 64: the last query and
    # key tiles hold rows past S); the output gradient is zero on left-pad
    # rows, as on the training path
    for b, s, h, kh, d, pad in [(4, 1024, 32, 8, 64, 37), (4, 1024, 32, 8, 64, 300),
                                (1, 1024, 25, 25, 64, 37), (1, 256, 8, 1, 256, 37),
                                (1, 1024, 16, 4, 128, 37), (1, 3072, 32, 8, 64, 37),
                                (1, 1040, 25, 25, 64, 37),
                                (4, 1024, 16, 4, 64, 37)]:  # a rank's heads at --tp 2
        qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[:, :pad] = 0
        main = (b, h, pad) == (4, 32, 37)
        with torch.no_grad():
            out = attention_resident.resident_attention(qg, k, v, mask)
            gout = randn(*qg.shape) * mask[:, :, None, None, None].to(torch.bfloat16)
            got = attention_resident.resident_attention_bwd(qg, k, v, mask, out, gout)
            want = attention_resident.resident_attention_bwd_plain(qg, k, v, mask, out, gout)
            torch.cuda.synchronize()
            err = check_attention_bwd(got, want, [b, s, h, kh, d])
            if main:
                check_deterministic(
                    got, attention_resident.resident_attention_bwd(qg, k, v, mask, out, gout),
                    "prefill_attention_bwd")
        q4, k4, v4, bmask = (t.requires_grad_(t.dtype != torch.bool)
                             for t in sdpa_inputs(qg, k, v, mask))
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask, enable_gqa=True)
        g4 = gout.reshape(b, s, h, d).transpose(1, 2).contiguous()
        times = time_in_turns([
            lambda: attention_resident.resident_attention_bwd(qg, k, v, mask, out, gout),
            lambda: attention_resident.resident_attention_bwd_plain(qg, k, v, mask, out, gout),
            lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True),
        ], 4)
        del lib_out
        pairs = (mask * mask.cumsum(-1)).sum().item() * h
        nbytes = 2 * (4 * qg.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * mask.numel()
        record("prefill_attention_bwd", [b, s, h, kh, d], err, times, 10 * d * pairs, nbytes,
               main=main, left_pad=pad, tflops=round(10 * d * pairs / times[0] / 1e9, 1))

    padded_checks(record, dev, randn)

    # K2: (B, S_max, H, KH, D), the left padding of row 0, the slots filled
    # and the split counts forced beside the kernel's own choice ("max": one
    # range a tile).  The long rows are the long serving path's cache (its
    # prompt's bucket + 128 new tokens) half-way through the answer; the B4
    # one pads row 0 by 1,000 slots (range boundaries inside the padding at
    # 7 ranges and at the maximum) and leaves the last 848 unfilled (whole
    # ranges past the filled slots).
    bucket, prompt_len = serve_prompt
    long_s = bucket + 128
    for b, s, h, kh, d, pad, filled, forced in [
            (1, 1152, 32, 8, 64, 3, 864, ()), (4, 1152, 32, 8, 64, 3, 864, ()),
            (1, 1152, 25, 25, 64, 3, 864, ()), (4, 1152, 25, 25, 64, 3, 864, ()),
            (1, long_s, 32, 8, 64, bucket - prompt_len, bucket + 64, (1, 7, "max")),
            (4, long_s, 32, 8, 64, 1000, long_s - 848, (1, 7, "max")),
            (1, long_s, 8, 1, 256, bucket - prompt_len, bucket + 64, ())]:
        with torch.inference_mode():
            q, kc, vc = randn(b, 1, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, filled:] = 0
            mask[0, :pad] = 0
            q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            bmask = mask.bool()[:, None, None, :]
            decode_row(record, "decode_attention", [b, s, h, kh, d], forced, q, kc, vc, mask,
                       lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                              enable_gqa=True))
            del q4, k4, v4, bmask

    # K3 forward: the main paths' shapes with llama's stored bf16 weight,
    # the training rows also with an f32 weight (gemma's 1 + w), and a
    # ragged row count at gpt2-xl's width 1,600 (200 vectors: the block's
    # last warp a quarter full); the decode row is the serving path's
    # commonest call.  Eager times (host launch costs included, as the
    # serving loop pays them) and device times (CUDA graphs).
    for shape, w_dtype in [((4096, 2048), torch.bfloat16), ((4096, 2048), torch.float32),
                           ((1024, 2048), torch.bfloat16), ((1, 2048), torch.bfloat16),
                           ((1003, 1600), torch.float32)]:
        with torch.inference_mode():
            x = randn(*shape)
            w = torch.randn(shape[-1], generator=gen, device=dev).to(w_dtype)
            err = check_rmsnorm_fwd(rmsnorm.rmsnorm(x, w, 1e-5), rmsnorm.rmsnorm_plain(x, w, 1e-5),
                                    list(shape))
            wb = w.to(torch.bfloat16)
            fns = [lambda: rmsnorm.rmsnorm(x, w, 1e-5), lambda: rmsnorm.rmsnorm_plain(x, w, 1e-5),
                   lambda: F.rms_norm(x, (shape[-1],), wb, 1e-5)]
            times = time_in_turns(fns, 200)
            dev_ms = time_graphed(fns)
            record("rmsnorm", list(shape), err, times, 4 * x.numel(),
                   4 * x.numel() + w.element_size() * w.numel(),
                   main=(shape, w_dtype) == ((4096, 2048), torch.bfloat16),
                   w_dtype=str(w_dtype).removeprefix("torch."), device_ms=dev_ms[0],
                   plain_device_ms=dev_ms[1], library_device_ms=dev_ms[2])

    # K3 backward: the training path's (4096, 2048), a ragged row count, and
    # gpt2-xl's width with an f32 weight; dx held by check_rmsnorm_bwd_dx, dw
    # by check_rmsnorm_dw; timed as the LoRA path runs it, without dw (the
    # norm weights are frozen), eager and on the device, against
    # F.rms_norm's autograd backward (its forward made on the capture
    # stream, where its backward then runs)
    for shape, w_dtype in [((4096, 2048), torch.bfloat16), ((1000, 2048), torch.bfloat16),
                           ((1003, 1600), torch.float32)]:
        x, gout = randn(*shape), randn(*shape)
        w = torch.randn(shape[-1], generator=gen, device=dev).to(w_dtype)
        with torch.no_grad():
            dx, none = rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, False)  # the LoRA path's call
            dx_dw, dw = rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, True)
            again = rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, True)[1]
            pdx, pdw = rmsnorm.rmsnorm_bwd_plain(x, w, gout, 1e-5, True)
            torch.cuda.synchronize()
            assert none is None
            err = check_rmsnorm_bwd_dx(dx, pdx, x, w, gout, 1e-5, list(shape))
            check_rmsnorm_bwd_dx(dx_dw, pdx, x, w, gout, 1e-5, list(shape) + ["with dw"])
            check_rmsnorm_dw(dw, pdw, again, list(shape))
        cap = torch.cuda.Stream()
        cap.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(cap):
            xl = x.detach().requires_grad_(True)
            yl = F.rms_norm(xl, (shape[-1],), w.to(torch.bfloat16), 1e-5)
        torch.cuda.current_stream().wait_stream(cap)
        fns = [lambda: rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, False),
               lambda: rmsnorm.rmsnorm_bwd_plain(x, w, gout, 1e-5, False),
               lambda: torch.autograd.grad(yl, xl, gout, retain_graph=True)]
        times = time_in_turns(fns, 50)
        dev_ms = time_graphed(fns, stream=cap)
        del yl
        record("rmsnorm_bwd", list(shape), err, times, 8 * x.numel(),
               6 * x.numel() + w.element_size() * w.numel(), main=shape[0] == 4096,
               w_dtype=str(w_dtype).removeprefix("torch."), device_ms=dev_ms[0],
               plain_device_ms=dev_ms[1], library_device_ms=dev_ms[2])

    int8_checks(record, dev, randn, serve_prompt)
    fused_decode_checks(record, dev, randn, serve_prompt)
    flash_checks(record, dev, randn, serve_prompt)

    # the BPE kernels: one batch of the token cache at ptb_500's 12 x 500
    # with phase 6's tokenizer (the main path's), and 256 records of
    # 12 x 2,500 with a 3,500-merge tokenizer
    import numpy as np

    from ecg_byte_tpu_torch.cli.make_synthetic import make_signal

    _, p1, p99 = load_split(root, "ptb_500")
    rng = np.random.default_rng(1)
    batch = np.stack([make_signal(rng, i % 2 == 0, SEG_LEN) for i in range(CACHE_BATCH)])
    batch[0] = p1 - 1.0  # below the range: an all-'a' record, one symbol repeated
    big, big_p1, big_p99 = load_split(root, BIG["name"])
    bpe_checks(record, dev, "ptb_500 cache batch", batch, p1, p99, merges, main=True,
               iters=(200, 3, 2))
    bpe_checks(record, dev, f"{BIG['name']}, {BIG['num_merges']} merges", big, big_p1, big_p99,
               big_merges, main=False, iters=(10, 1, 1))
    return report


def padded_checks(record, dev, randn):
    """The resident kernels through ``attention.resident_padded``, as the
    model runs them where S is not a multiple of 16: B4 32/8 D64 with 37
    left-pad positions at S 1004 (cli.main's default --pad_to_max 1000) and
    S 504 (--pad_to_max 500).  The forward held by check_resident_fwd and
    the backward (autograd through the padding) by check_attention_bwd,
    each against the plain version at the unpadded S; both timed with the
    padding's copies, against plain and SDPA at the unpadded S, and the
    bound counted at the unpadded S."""
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.ops import attention, attention_resident

    b, h, kh, d, pad = 4, 32, 8, 64, 37
    for s in (1004, 504):
        shape = [b, s, h, kh, d]
        qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[:, :pad] = 0
        pairs = (mask * mask.cumsum(-1)).sum().item() * h
        padded = s + (-s % attention.RESIDENT_SEQ_TILE)
        q4, k4, v4, bmask = sdpa_inputs(qg, k, v, mask)
        with torch.inference_mode():
            got = attention.resident_padded(qg, k, v, mask)
            want = attention.grouped_attention(qg, k, v, mask)
            torch.cuda.synchronize()
            err = check_resident_fwd(got, want, mask, shape + ["padded"])
            times = time_in_turns([
                lambda: attention.resident_padded(qg, k, v, mask),
                lambda: attention.grouped_attention(qg, k, v, mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                       enable_gqa=True),
            ], [20, 4, 20])
        nbytes = 2 * (2 * qg.numel() + k.numel() + v.numel()) + 4 * mask.numel()
        record("prefill_attention", shape, err, times, 4 * d * pairs, nbytes, main=False,
               left_pad=pad, padded_to=padded, tflops=round(4 * d * pairs / times[0] / 1e9, 1))

        leaves = [t.detach().requires_grad_(True) for t in (qg, k, v)]
        out = attention.resident_padded(*leaves, mask)
        gout = randn(*qg.shape) * mask[:, :, None, None, None].to(torch.bfloat16)
        got = torch.autograd.grad(out, leaves, gout, retain_graph=True)
        with torch.no_grad():
            want = attention_resident.resident_attention_bwd_plain(qg, k, v, mask, out.detach(),
                                                                   gout)
            torch.cuda.synchronize()
            err = check_attention_bwd(got, want, shape + ["padded"])
        l4 = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        lib_out = F.scaled_dot_product_attention(*l4, attn_mask=bmask, enable_gqa=True)
        g4 = gout.reshape(b, s, h, d).transpose(1, 2).contiguous()
        times = time_in_turns([
            lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True),
            lambda: attention_resident.resident_attention_bwd_plain(qg, k, v, mask, out.detach(),
                                                                    gout),
            lambda: torch.autograd.grad(lib_out, l4, g4, retain_graph=True),
        ], 4)
        del lib_out, out, q4, k4, v4, bmask
        nbytes = 2 * (4 * qg.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * mask.numel()
        record("prefill_attention_bwd", shape, err, times, 10 * d * pairs, nbytes, main=False,
               left_pad=pad, padded_to=padded, tflops=round(10 * d * pairs / times[0] / 1e9, 1))


def decode_row(record, name, shape, forced, q, kc, vc, mask, library, k_scale=None,
               v_scale=None):
    """Decode attention over one cache: the kernel at each forced split
    count and at its own (``num_splits``) held to plain by check_decode;
    then kernel, plain and ``library`` timed in turns with CUDA events over
    100 eager calls each (host launch costs included, as the serving loop
    pays them), and the device times of kernel and library and of every
    forced split count (CUDA graphs)."""
    import torch

    from ecg_byte_tpu_torch.ops import _cuda, attention, attention_decode

    b, s, h, kh, d = shape
    scales = (k_scale, v_scale)
    want = attention.decode_attention(q, kc, vc, mask, *scales)
    tiles = -(-s // attention_decode.KEYS)
    default = attention_decode.num_splits(b, kh, s, _cuda.sm_count(q.device.index))
    counts = [tiles if n == "max" else n for n in forced]
    for n in counts:
        got = attention_decode.decode_attention_fused(q, kc, vc, mask, *scales, splits=n)
        torch.cuda.synchronize()
        check_decode(got, want, shape + [f"{n} ranges"])
    got = attention_decode.decode_attention_fused(q, kc, vc, mask, *scales)
    torch.cuda.synchronize()
    err = check_decode(got, want, shape + [f"{default} ranges (its own)"])
    kernel = lambda: attention_decode.decode_attention_fused(q, kc, vc, mask, *scales)  # noqa: E731
    times = time_in_turns([kernel, lambda: attention.decode_attention(q, kc, vc, mask, *scales),
                           library], 100)
    forced_fns = [lambda n=n: attention_decode.decode_attention_fused(q, kc, vc, mask, *scales,
                                                                      splits=n) for n in counts]
    dev_ms = time_graphed([kernel, library] + forced_fns)
    n_valid = mask.sum().item()  # the cache rows this call must read
    # a K or V row: bf16, or int8 with its bf16 scale
    row_bytes = 2 * kh * d if k_scale is None else kh * d + 2 * kh
    nbytes = 2 * n_valid * row_bytes + 2 * 2 * q.numel() + 4 * mask.numel()
    record(name, shape, err, times, 4 * d * h * n_valid, nbytes, main=False, ranges=default,
           device_ms=dev_ms[0], library_device_ms=dev_ms[1],
           forced_device_ms={n: t for n, t in zip(counts, dev_ms[2:])})


def fused_decode_checks(record, dev, randn, serve_prompt):
    """Decode attention as the decode step calls it, with this token's row
    (``fresh_k``, ``fresh_v``, ``write_idx``) on a stale cache, for both
    caches at the serving cache (S_max 1,152) and the long one: held by
    check_fused_decode to the pair it replaces (:func:`append_then_kernel`:
    ``kv_quant.append_kv`` or two slice copies, then the kernel), at every
    forced split count and its own, with the row on a tile boundary, on a
    range boundary, in the last tile and past slot 5,120; then, with the row where a decode step
    writes it, held to plain by check_decode and timed in turns with the
    pair, the plain version and SDPA (the bf16 rows) on the host clock
    (100 eager calls), and with the pair, the kernel alone on the updated
    cache (what the row adds to phase A) and SDPA on the device (CUDA
    graphs).  These are the main rows of both decode kernels."""
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.ops import _cuda, kv_quant
    from ecg_byte_tpu_torch.ops import attention_decode as ad

    kernel = ad.decode_attention_fused
    bucket, prompt_len = serve_prompt
    for int8 in (False, True):
        name = "decode_attention_int8" if int8 else "decode_attention"
        for b, s, h, kh, d, pad, at in [(1, 1152, 32, 8, 64, 3, 1100),
                                        (1, bucket + 128, 32, 8, 64, bucket - prompt_len,
                                         bucket + 64),
                                        (1, 1152, 16, 4, 64, 3, 1100)]:  # a rank's at --tp 2
            shape = [b, s, h, kh, d]
            with torch.inference_mode():
                q, kb, vb = randn(b, 1, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
                fk, fv = randn(b, 1, kh, d), randn(b, 1, kh, d)
                if int8:
                    (kc, ks), (vc, vs) = kv_quant.quant_kv_rows(kb), kv_quant.quant_kv_rows(vb)
                    stale = [kc, vc, ks, vs]
                else:
                    stale = [kb, vb]

                def cache_mask(idx):  # a decode step's: the slots up to its own
                    m = torch.zeros(b, s, dtype=torch.int32, device=dev)
                    m[:, :idx + 1] = 1
                    m[0, :pad] = 0
                    return m

                def fused(c, mask, idx, n=None, call=kernel):
                    return call(q, c[0], c[1], mask, *(c[2:] if int8 else (None, None)), n,
                                fresh_k=fk, fresh_v=fv, write_idx=idx)

                def pair(c, mask, idx, n=None):
                    return fused(c, mask, idx, n, call=append_then_kernel)

                tiles = -(-s // ad.KEYS)
                own = ad.num_splits(b, kh, s, _cuda.sm_count(q.device.index))
                checked = 0
                for n in sorted({own, 1, 7, tiles}):
                    starts = [lo for lo, _ in ad.split_ranges(s, n)]
                    slots = {10 * ad.KEYS, starts[len(starts) // 2], s - 1}
                    if s > 5120 + 8:
                        slots.add(5120 + 7)
                    for idx in sorted(slots):
                        mask = cache_mask(idx)
                        got_c, want_c = [t.clone() for t in stale], [t.clone() for t in stale]
                        got, want = fused(got_c, mask, idx, n), pair(want_c, mask, idx, n)
                        torch.cuda.synchronize()
                        check_fused_decode(got, want, got_c, want_c,
                                           shape + [f"{n} ranges", f"slot {idx}"])
                        checked += 1
                print(f"{name} {shape} with this token's row: {checked} calls (split counts "
                      f"{sorted({own, 1, 7, tiles})}, slots on a tile boundary, a range "
                      "boundary, the last tile, past 5,120) equal append + kernel "
                      "(torch.equal: out, cache rows and scales)")

                mask = cache_mask(at)
                c_f, c_p, c_l = ([t.clone() for t in stale] for _ in range(3))
                scales = (c_l[2], c_l[3]) if int8 else (None, None)
                want = ad.decode_attention_fused_plain(q, c_l[0], c_l[1], mask, *scales,
                                                       fresh_k=fk, fresh_v=fv, write_idx=at)
                got = fused(c_f, mask, at)
                torch.cuda.synchronize()
                err = check_decode(got, want, shape + ["this token's row", f"slot {at}"])
                q4 = q.transpose(1, 2)
                k4, v4 = kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
                bmask = mask.bool()[:, None, None, :]
                fns = [lambda: fused(c_f, mask, at), lambda: pair(c_p, mask, at),
                       lambda: ad.decode_attention_fused_plain(
                           q, c_l[0], c_l[1], mask, *scales, fresh_k=fk, fresh_v=fv,
                           write_idx=at),
                       lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                              enable_gqa=True)]
                times = time_in_turns(fns, [100, 100, 20, 100])
                alone = lambda: kernel(q, c_p[0], c_p[1], mask,  # noqa: E731
                                       *(c_p[2:] if int8 else (None, None)))
                dev_ms = time_graphed([fns[0], fns[1], alone, fns[3]])
                n_valid = mask.sum().item()
                row_bytes = kh * d + 2 * kh if int8 else 2 * kh * d
                # the valid cache rows read once (the fresh one from its bf16
                # input instead), the fresh rows written, q read, out written
                nbytes = (2 * (n_valid - 1) * row_bytes + 2 * 2 * fk.numel() + 2 * row_bytes
                          + 2 * 2 * q.numel() + 4 * mask.numel())
                record(name, shape + ["fresh"], err, (times[0], times[2], times[3]),
                       4 * d * h * n_valid, nbytes, main=s == 1152, ranges=own, write_idx=at,
                       pair_ms=times[1], device_ms=dev_ms[0], pair_device_ms=dev_ms[1],
                       alone_device_ms=dev_ms[2], library_device_ms=dev_ms[3])
                del q4, k4, v4, bmask


def int8_checks(record, dev, randn, serve_prompt):
    """The int8 serving kernels against their plain versions, timed beside
    their bounds and the bf16 path they replace."""
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.models.quantized import quantize_weight
    from ecg_byte_tpu_torch.ops import _cuda, int8_linear, kv_quant

    # decode attention over the int8 cache: random bf16 rows quantized by
    # the plain quantizer; the yardstick is SDPA on the bf16 rows.  The last
    # row is the long serving path's cache, as the bf16 one.
    bucket, prompt_len = serve_prompt
    for b, s, h, kh, d, pad, filled in [
            (1, 1152, 32, 8, 64, 3, 864), (4, 1152, 32, 8, 64, 3, 864),
            (1, 1152, 25, 25, 64, 3, 864), (1, 1152, 8, 1, 256, 3, 864),
            (1, bucket + 128, 32, 8, 64, bucket - prompt_len, bucket + 64)]:
        with torch.inference_mode():
            q, kb, vb = randn(b, 1, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
            (kc, ks), (vc, vs) = kv_quant.quant_kv_rows(kb), kv_quant.quant_kv_rows(vb)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, filled:] = 0
            mask[0, :pad] = 0
            q4, k4, v4 = q.transpose(1, 2), kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
            bmask = mask.bool()[:, None, None, :]
            decode_row(record, "decode_attention_int8", [b, s, h, kh, d], (), q, kc, vc, mask,
                       lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                              enable_gqa=True),
                       k_scale=ks, v_scale=vs)
            del q4, k4, v4, bmask

    # the int8 weight product, each row on the kernel the wrapper picks or
    # on the one forced: Llama's gate projection (8192 x 2048) at decode
    # (M = 1), at both sides of the GEMV / tensor-core threshold with each
    # kernel, at a 1k prompt (M 1000), at the serving bucket (M 1152, once
    # with each kernel forced) and at the long one (M 4992); Llama's other
    # prefill projections at M 1152 (q/o 2048 x 2048, k/v 512 x 2048 on the
    # one-warpgroup tile, down 2048 x 8192); the head (f32 logits); gpt2's
    # c_fc at decode and c_attn at prefill (K = 1600, a bias, N = 4800
    # ragged to 128-wide tiles).  The yardstick is cuBLAS on the
    # bf16 weight.  Kernel, plain and library are timed on the device (CUDA
    # graphs): at M = 1 the host's launch cost would otherwise hide the
    # kernel; the host-clock times of kernel and library calls in turns are
    # kept as host_ms.
    edge = int8_linear.GEMV_MAX_M
    for m, n, k, with_bias, path in [
            (1, 8192, 2048, False, None), (edge, 8192, 2048, False, None),
            (edge, 8192, 2048, False, "tc"), (edge + 1, 8192, 2048, False, "gemv"),
            (edge + 1, 8192, 2048, False, None), (16, 8192, 2048, False, None),
            (1000, 8192, 2048, False, None), (1152, 8192, 2048, False, "tc"),
            (1152, 8192, 2048, False, "gemv"), (4992, 8192, 2048, False, None),
            (1152, 2048, 2048, False, None), (1152, 512, 2048, False, None),
            (1152, 2048, 8192, False, None), (1, 128256, 2048, False, None), (1, 6400, 1600, True, None),
            (1152, 4800, 1600, True, None)]:
        if m == 16 and edge in (15, 16):
            continue  # already a row
        with torch.inference_mode():
            x, w = randn(m, k), randn(n, k) * 0.02
            qw, scale = quantize_weight(w)
            bias = randn(n) * 0.1 if with_bias else None
            out_dtype = torch.float32 if n == 128256 else None
            taken = path or int8_linear.choose_path(m)
            name = "int8_linear_tc" if taken == "tc" else "int8_linear"
            got = int8_linear.int8_linear(x, qw, scale, bias, out_dtype, path=path)
            want = int8_linear.int8_linear_plain(x, qw, scale, bias, out_dtype)
            torch.cuda.synchronize()
            err = check_int8_linear(got, want, x, qw, scale, bias, [m, n, k, taken])
            fns = [lambda: int8_linear.int8_linear(x, qw, scale, bias, out_dtype, path=path),
                   lambda: int8_linear.int8_linear_plain(x, qw, scale, bias, out_dtype),
                   lambda: F.linear(x, w, bias)]
            times = time_graphed(fns, calls=5 if m > 1 else 20)
            host = time_in_turns([fns[0], fns[2]], 10 if m > 1 else 50)
            out_bytes = m * n * (4 if out_dtype else 2)
            nbytes = n * k + 2 * m * k + 2 * n * (2 if with_bias else 1) + out_bytes
            main = (m, n) == (1, 8192) if name == "int8_linear" else (m, n) == (1152, 8192)
            tile = (int8_linear.TC_TILES[int8_linear.choose_tile(
                m, n, _cuda.sm_count(x.device.index))] if taken == "tc" else None)
            record(name, [m, n, k], err, times, 2 * m * n * k, nbytes, main=main and path != "gemv",
                   bias=with_bias, path=taken, forced=path is not None, tile=tile,
                   host_ms=host[0], library_host_ms=host[1])
            del x, w, qw, scale, got, want, fns

    # the host's cost of one call, from a tiny product: the wrapper against
    # F.linear (eager decode makes 113 such calls per token)
    x, qw, scale = randn(1, 64), torch.ones(64, 64, dtype=torch.int8, device=dev), randn(64)
    wb = qw.to(torch.bfloat16)
    for label, fn in (("int8_linear", lambda: int8_linear.int8_linear(x, qw, scale)),
                      ("F.linear", lambda: F.linear(x, wb))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        print(f"host cost of one {label} call at (1, 64) x (64, 64): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} us (host clock over 1,000 calls)")

    # the KV quantizer: a prefill's rows (its main path's call, one a layer
    # per prompt), a decode step's (B1, B4), gemma's D 256 and the long
    # prompt's prefill (its bucket, 4,992 rows, into 5,120 slots); it must
    # equal the plain version (check_kv_quant)
    for b, rows, kh, d, idx, slots in [(1, 1, 8, 64, 1100, 1152), (4, 1, 8, 64, 1100, 1152),
                                       (1, 1152, 8, 64, 0, 1152), (1, 1, 1, 256, 5, 1152),
                                       (1, 4992, 8, 64, 0, 5120)]:
        with torch.inference_mode():
            k, v = randn(b, rows, kh, d), randn(b, rows, kh, d)
            k[0, 0, 0] = 0.0  # a zero row: scale 1

            def cache():
                return (torch.zeros(b, slots, kh, d, dtype=torch.int8, device=dev),
                        torch.zeros(b, slots, kh, d, dtype=torch.int8, device=dev),
                        torch.ones(b, slots, kh, dtype=torch.bfloat16, device=dev),
                        torch.ones(b, slots, kh, dtype=torch.bfloat16, device=dev))

            got, want = cache(), cache()
            kv_quant.append_kv(k, v, *got, idx)
            kv_quant.append_kv_plain(k, v, *want, idx)
            torch.cuda.synchronize()
            check_kv_quant(got, want, f"kv_quant {[b, rows, kh, d]}")
            # device time (CUDA graphs), and the host clock of calls in turns:
            # at a decode step's size the launch is the cost
            fns = [lambda: kv_quant.append_kv(k, v, *got, idx),
                   lambda: kv_quant.append_kv_plain(k, v, *want, idx)]
            times = time_graphed(fns)
            host = time_in_turns(fns, 100)
            # bytes: K and V read once, their int8 rows and scales written
            # once; ~5 operations per element (abs, max, divide, round, clamp)
            nbytes = 2 * (2 * k.numel() + k.numel() + 2 * b * rows * kh)
            record("kv_quant", [b, rows, kh, d], 0.0, (*times, None), 10 * k.numel(), nbytes,
                   main=rows == 1152, host_ms=host[0], plain_host_ms=host[1])
            old = OLD_KV_QUANT_MS.get((b, rows, kh, d))
            if old is not None:
                print(f"  kv_quant {[b, rows, kh, d]}: {times[0]:.4f} ms on the device (the warp "
                      f"a row kernel: {old} ms, in PERF.md)")
    print("  kv_quant: int8 rows and bf16 scales equal the plain version's (torch.equal)")


def flash_checks(record, dev, randn, serve_prompt):
    """The flash kernels against their plain versions (``check_flash_fwd``,
    ``check_attention_bwd``), timed in turns with them and with SDPA under
    the causal and pad mask (its autograd backward for the backward), beside
    the bound.  The output gradient is random on every row, the left-pad
    rows included, so their backward (p = 1 on every key of their blocks)
    is held to plain too."""
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.ops import flash_attention as fa

    bucket, prompt_len = serve_prompt  # the long serving path's prefill
    # (B, S, H, KH, D, left pad, backward too): the training shape; the long
    # serving path's prefill; S 8192; gpt2's and gemma's heads; a ragged S
    for b, s, h, kh, d, pad, bwd in [
            (1, 4096, 32, 8, 64, 300, True), (1, bucket, 32, 8, 64, bucket - prompt_len, False),
            (1, 8192, 32, 8, 64, 37, True), (1, 4096, 25, 25, 64, 128, True),
            (1, 4096, 8, 1, 256, 1, True), (1, 4000, 32, 8, 64, 127, True),
            (1, 4096, 16, 4, 64, 300, True)]:  # a rank's heads at --tp 2
        qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[:, :pad] = 0
        shape = [b, s, h, kh, d]
        pairs = (mask * mask.cumsum(-1)).sum().item() * h  # valid causal (q, t) pairs
        lse_bytes = 4 * b * h * s
        iters = 2 if s > 4096 else 3
        main = (s, h) == (4096, 32)
        with torch.inference_mode():
            got = fa.flash_attention_fwd(qg, k, v, mask)
            want = fa.flash_attention_fwd_plain(qg, k, v, mask)
            torch.cuda.synchronize()
            err = check_flash_fwd(got, want, mask, shape)
            if main:
                check_deterministic(got, fa.flash_attention_fwd(qg, k, v, mask),
                                    "flash_attention", what="out, lse")
            q4, k4, v4, bmask = sdpa_inputs(qg, k, v, mask)
            times = time_in_turns([
                lambda: fa.flash_attention_fwd(qg, k, v, mask),
                lambda: fa.flash_attention_fwd_plain(qg, k, v, mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                       enable_gqa=True),
            ], [10, iters, 10])
            nbytes = 2 * (2 * qg.numel() + k.numel() + v.numel()) + 4 * mask.numel() + lse_bytes
            record("flash_attention", shape, err, times, 4 * d * pairs, nbytes, main=main,
                   left_pad=pad, tflops=round(4 * d * pairs / times[0] / 1e9, 1))
            del q4, k4, v4, bmask
        if not bwd:
            continue
        out, lse = got
        gout = randn(*qg.shape)
        with torch.no_grad():
            got = fa.flash_attention_bwd(qg, k, v, mask, out, lse, gout)
            want = fa.flash_attention_bwd_plain(qg, k, v, mask, out, lse, gout)
            torch.cuda.synchronize()
            err = check_attention_bwd(got, want, shape, name="flash_attention_bwd",
                                      tag="flash bwd")
            if main:
                check_deterministic(got, fa.flash_attention_bwd(qg, k, v, mask, out, lse, gout),
                                    "flash_attention_bwd")
        q4, k4, v4, bmask = (t.requires_grad_(t.dtype != torch.bool)
                             for t in sdpa_inputs(qg, k, v, mask))
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask, enable_gqa=True)
        g4 = gout.reshape(b, s, h, d).transpose(1, 2).contiguous()
        times = time_in_turns([
            lambda: fa.flash_attention_bwd(qg, k, v, mask, out, lse, gout),
            lambda: fa.flash_attention_bwd_plain(qg, k, v, mask, out, lse, gout),
            lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True),
        ], iters)
        del lib_out, q4, k4, v4, bmask
        nbytes = (2 * (4 * qg.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * mask.numel()
                  + lse_bytes)
        record("flash_attention_bwd", shape, err, times, 10 * d * pairs, nbytes, main=main,
               left_pad=pad, tflops=round(10 * d * pairs / times[0] / 1e9, 1))
    torch.cuda.empty_cache()


def chain_checks(record, dev, max_len):
    """The chain kernel on :func:`chain_rows`' adversarial rows (with the
    main path's ``max_len``, and the first three also at max_len 64, 128
    and 255, the byte stage's instances for longer tokens, at 300 and
    CHAIN_WIDE_MAX_LEN, its 16-bit stage's, and past it, the one-thread
    walk): each must equal the plain chain and ``_compact`` exactly; timed
    in turns with the plain version, and on the device (CUDA graphs)."""
    import torch

    from ecg_byte_tpu_torch.ops import bpe_match

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(max_len, row) for row in chain_rows(gen, max_len, dev)]
    wide = bpe_match.CHAIN_WIDE_MAX_LEN
    cases += [(w, row) for w in (64, 128, 255, FLAT_MAX_LEN, wide, wide + 76)
              for row in chain_rows(gen, w, dev)[:3]]
    for w, (label, ln, tok) in cases:
        got = bpe_match.greedy_chain(ln, tok, w)
        want = _chain_plain(ln, tok, w)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"bpe_chain {label}, max_len {w}: differs from plain"
        kernel = lambda: bpe_match.greedy_chain(ln, tok, w)  # noqa: E731
        times = time_in_turns([kernel, lambda: _chain_plain(ln, tok, w)], [20, 1])
        b, n = ln.shape
        record("bpe_chain", [b, n], 0.0, (*times, None), 0, 8 * b * n + b * n + 4 * b * n + 4 * b,
               False, row=label, max_len=w,
               tokens_per_record=round(want[2].float().mean().item(), 1),
               device_ms=time_graphed([kernel])[0])
    print(f"  bpe_chain: every adversarial row (max_len {max_len}, and 64, 128, 255, "
          f"{FLAT_MAX_LEN}, {wide}, {wide + 76}) equals the plain chain and _compact exactly")


def flat_lead_checks(record, dev, merges):
    """A vocabulary whose flat-lead tokens reach a^FLAT_MAX_LEN
    (:func:`flat_lead_merges` over ``merges``) on 64 records of 6,000
    symbols with flat runs past it (:func:`flat_lead_records`): the device
    encoder (the match kernel, then the chain kernel's 16-bit stage) equals
    the host C++ trie exactly, record by record; the chain timed in turns
    with its plain version, and on the device."""
    import torch

    from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match
    from ecg_byte_tpu_torch.tokenizer import native

    vocab = flat_lead_merges(merges)
    table = bpe_encode.build_automaton(vocab, dev)
    assert table.max_len == FLAT_MAX_LEN > bpe_match.CHAIN_MAX_LEN, table.max_len
    q_cpu = flat_lead_records(torch.Generator().manual_seed(4), CACHE_BATCH, 6000)
    q = q_cpu.to(dev)
    ids, counts = bpe_encode.encode(q, table)
    enc = native.NativeEncoder(vocab)
    want = [enc.encode(bytes((row + 97).tolist())).tolist() for row in q_cpu]
    check_streams(ids, counts, want, f"flat leads, max_len {FLAT_MAX_LEN}")
    tok, ln = bpe_match.longest_match(q, table)
    assert int(ln.max()) == FLAT_MAX_LEN
    times = time_in_turns([lambda: bpe_match.greedy_chain(ln, tok, table.max_len),
                           lambda: _chain_plain(ln, tok, table.max_len)], [20, 1])
    b, n = q.shape
    record("bpe_chain", [b, n], 0.0, (*times, None), 0, 8 * b * n + b * n + 4 * b * n + 4 * b,
           False, row="flat leads, encoded as the host trie", max_len=FLAT_MAX_LEN,
           tokens_per_record=round(counts.float().mean().item(), 1),
           device_ms=time_graphed([lambda: bpe_match.greedy_chain(ln, tok, table.max_len)])[0])
    print(f"  flat leads: {b} records of {n} symbols, longest token {FLAT_MAX_LEN}: the device "
          f"encoder (16-bit chain stage) equals the host trie on every record "
          f"({int(counts.sum())} tokens)")


def match_checks(dev, merges):
    """The match kernel on :func:`match_rows`' adversarial rows at every
    (segment length, warps) that ``bpe_match.choose_sweep`` takes, and once
    with no table rows in shared memory (the path of a table too large to
    stage; a table with compact rows is always staged whole): each must
    equal the plain version exactly (:func:`check_match`)."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match

    choices = bpe_match.sweep_choices()
    for label, q_np, vocab, budget in match_rows(np.random.default_rng(11), merges):
        table = bpe_encode.build_automaton(vocab, dev, sweep_budget=budget)
        q = torch.from_numpy(q_np).to(dev)
        want = bpe_match.longest_match_plain(q, table)
        for seg, warps in choices:
            check_match(bpe_match.sweep_match(q, table, seg, warps), want,
                        f"bpe_match {label}, segment {seg}, {warps} warps")
        check_match(bpe_match.sweep_match(q, table, *choices[0], max_hot=0), want,
                    f"bpe_match {label}, no rows staged")
        check_match(bpe_match.longest_match(q, table), want, f"bpe_match {label}")
        sw = table.sweep
        staging = "staged whole" if sw.full < sw.states else "and with no rows staged"
        print(f"  bpe_match {label}: {tuple(q.shape)}, longest token {table.max_len}, "
              f"{sweep_layout(sw)}: exact at (segment, warps) {choices}, {staging}")


def bpe_checks(record, dev, label, signals, p1, p99, merges, main, iters):
    """Both BPE kernels against their plain versions (exactly), the device
    encoder against the host trie (every record), and the times of kernel,
    plain and the host trie, in turns; ``iters`` calls of the kernels, of
    the plain versions and of the trie per turn.  The match kernel's eager
    and device times beside the first design's; the chain's tokens per
    record and ns per token beside the first design's; with ``main`` also
    :func:`match_checks` and :func:`chain_checks` at this ``max_len``."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match
    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize
    from ecg_byte_tpu_torch.tokenizer import native

    t0 = time.perf_counter()
    table = bpe_encode.build_automaton(merges, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    signal = torch.from_numpy(signals).to(dev)
    q = normalize_quantize(signal, p1, p99)[1].reshape(signals.shape[0], -1).contiguous()
    b, n = q.shape
    states = table.trans.shape[0]
    table_bytes = states * 28 * 4  # trans (S, 27) and token (S,), int32
    sweep_bytes = table.sweep.words.numel() * 4
    print(f"BPE {label}: ({b}, {n}) symbols; {len(merges)} merges, longest token "
          f"{table.max_len} symbols, largest id {max(t for _, t in merges)}, {states} states "
          f"({table_bytes / 1e3:.1f} KB trie); sweep table {sweep_layout(table.sweep)}, both "
          f"built in {build_ms:.1f} ms on the host")

    tok, ln = bpe_match.longest_match(q, table)
    want = bpe_match.longest_match_plain(q, table)
    vis, ids, counts = bpe_match.greedy_chain(ln, tok, table.max_len)
    pvis, pids, pcounts = _chain_plain(ln, tok, table.max_len)
    torch.cuda.synchronize()
    check_match((tok, ln), want, f"bpe_match {label}")
    assert torch.equal(vis, pvis) and torch.equal(ids, pids) and torch.equal(counts, pcounts), \
        f"bpe_chain {label}: differs from plain"
    eids, ecounts = bpe_encode.quantize_and_encode(signal, p1, p99, table)
    host = host_streams(signals, p1, p99, merges)
    check_streams(eids, ecounts, host, f"quantize_and_encode {label}")
    print(f"  exact: both kernels equal their plain versions; quantize_and_encode equals the "
          f"host trie on all {b} records ({int(ecounts.sum())} tokens, "
          f"{n * b / int(ecounts.sum()):.2f} symbols per token)")

    enc = native.NativeEncoder(merges)
    texts = [bytes(np.asarray(r, np.uint8) + ord("a")) for r in q.cpu().numpy()]
    trie = lambda: [enc.encode(t) for t in texts]  # noqa: E731
    match_times = time_in_turns([lambda: bpe_match.longest_match(q, table),
                                 lambda: bpe_match.longest_match_plain(q, table), trie], iters)
    chain_times = time_in_turns([lambda: bpe_match.greedy_chain(ln, tok, table.max_len),
                                 lambda: _chain_plain(ln, tok, table.max_len)], iters[:2])
    # device times (CUDA graphs): eager, a call's host cost hides a kernel
    # that takes less
    dev_ms = time_graphed([lambda: bpe_match.longest_match(q, table),
                           lambda: bpe_match.greedy_chain(ln, tok, table.max_len)])
    seg, warps = bpe_match.choose_sweep(b, n)
    trie_ms = match_times[2]
    print(f"  host trie (C++, the --online_encode path) {trie_ms:.3f} ms for the batch; the "
          f"plain versions over {iters[1]} call(s) a turn")
    old = OLD_MATCH_MS.get((b, n))
    print(f"  bpe_match {label}: segment {seg}, {warps} warps a block, {match_times[0]:.4f} ms "
          f"eager, {dev_ms[0]:.4f} on the device" + ("" if old is None else
                                                     f" (the trie walk from every position: "
                                                     f"{old[0]} eager, {old[1]} on the device, "
                                                     "in PERF.md)"))
    # bytes: each input once, each output once (no floating-point work); the
    # trie's bytes, whichever table the kernel reads
    record("bpe_match", [b, n], 0.0, (match_times[0], match_times[1], None), 0,
           b * n + table_bytes + 8 * b * n, main, host_trie_ms=trie_ms, device_ms=dev_ms[0],
           segment=seg, warps=warps, sweep_states=table.sweep.states,
           sweep_full_rows=table.sweep.full, sweep_bytes=sweep_bytes)
    record("bpe_chain", [b, n], 0.0, (chain_times[0], chain_times[1], None), 0,
           8 * b * n + b * n + 4 * b * n + 4 * b, main, host_trie_ms=trie_ms,
           device_ms=dev_ms[1])
    per_record = counts.float().mean().item()
    old = OLD_CHAIN_MS.get((b, n))
    print(f"  bpe_chain {label}: {per_record:.1f} tokens per record; "
          f"{chain_times[0] * 1e6 / per_record:.2f} ns per chain token eager, "
          f"{dev_ms[1] * 1e6 / per_record:.2f} on the device" + (
              "" if old is None else f" (the one-thread walk, {old} ms eager in PERF.md: "
              f"{old * 1e6 / per_record:.2f} ns per token)"))
    if main:
        match_checks(dev, merges)
        chain_checks(record, dev, table.max_len)
        flat_lead_checks(record, dev, merges)


def train_phase(root, vocab, merges):
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.ops import bpe_encode
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step

    phase("6. train: cli.main --peft --dev from the device token cache, random Llama-3.2-1B "
          "at full width")
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    encoded = []  # each batch of the token cache: its records and what the card made of them
    encode = bpe_encode.quantize_and_encode

    def spy(signal, p1, p99, table):
        ids, counts = encode(signal, p1, p99, table)
        encoded.append((signal.cpu().numpy(), p1, p99, ids, counts))
        return ids, counts

    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root), mock.patch.object(bpe_encode, "quantize_and_encode", spy):
        result = cli_main.main(_cli_args() + TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    summary = result["training"]
    steps, evals = summary["steps"], 2  # two epochs, one validation batch each
    print(f"launches {counts}; {steps} train steps, {evals} eval steps; "
          f"{summary['tokens']} tokens in {summary['seconds']:.1f} s; phase wall {wall:.1f} s")
    layers = LAYERS
    # per train step every layer's attention forward and backward, 2L + 1
    # norms forward; 2L norm backwards, as layer 0's input norm reads the
    # frozen embedding and nothing asks for its gradient; per eval step the
    # forwards alone; each BPE kernel once per batch of the token cache, one
    # batch for the train split and one for the val split; no serving kernel
    expected = dict.fromkeys(SOURCES, 0)
    expected.update({"prefill_attention": layers * (steps + evals),
                     "prefill_attention_bwd": layers * steps,
                     "rmsnorm": (2 * layers + 1) * (steps + evals),
                     "rmsnorm_bwd": 2 * layers * steps,
                     "bpe_match": 2, "bpe_chain": 2})
    assert steps == 12, f"{steps} train steps"
    for name, n in counts.items():
        assert n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
    assert [len(e[0]) for e in encoded] == [N_TRAIN, N_VAL], [len(e[0]) for e in encoded]
    for k, (signals, p1, p99, ids, n_tok) in enumerate(encoded):
        check_streams(ids, n_tok, host_streams(signals, p1, p99, merges), f"token cache batch {k}")
    print(f"token cache: {sum(len(e[0]) for e in encoded)} records in {len(encoded)} batches, "
          "every stream equal to the host trie's")
    losses = summary["train_loss"] + summary["val_loss"]
    assert all(np.isfinite(losses)), losses
    print(f"train loss per epoch {summary['train_loss']}, val loss {summary['val_loss']}")

    fresh, config, tokenizer = check_run_dir(root, summary, vocab, dev)
    data_layer(root, vocab, merges, tokenizer, dev)

    # the train step alone at B4 x 1024, for each remat mode: 2 warm-up
    # steps, then 5 timed with CUDA events
    opt = make_optimizer(config.hidden_size, 500)
    state = create_train_state(config, opt, torch.Generator(device=dev).manual_seed(0),
                               peft=True, params=fresh)
    batch = _training_items(root, vocab, merges, tokenizer, 4)
    b, s = batch["input_ids"].shape
    gen = torch.Generator().manual_seed(0)
    timed = {}
    for remat in ("none", "full"):
        state, *timed[remat] = time_train_step(make_train_step(config, opt, remat=remat), state,
                                               batch, gen, f"remat {remat}")
    profile_steps(make_train_step(config, opt), state, batch, gen)
    ms, peak = timed["none"]
    return counts, {"ms_per_step": ms, "tokens_per_s": b * s / ms * 1e3, "peak_gib": peak,
                    "checkpoint": os.path.basename(summary["directory"])}


def time_train_step(step, state, batch, gen, label):
    """The train step alone: 2 warm-up steps, then 5 timed with CUDA events;
    returns (state, ms per step, peak device memory in GiB)."""
    import torch

    b, s = batch["input_ids"].shape
    for _ in range(2):
        state, loss = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        state, loss = step(state, batch, gen)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step B{b} x S{s}, {label}: {ms:.2f} ms/step = "
          f"{b * s / ms * 1e3:.0f} tokens/s (CUDA events over 5 steps after 2 warm-up); "
          f"loss {loss.item():.4f}; peak device memory {peak:.2f} GiB")
    return state, ms, peak


def check_run_dir(root, summary, vocab, dev):
    """The run directory ``cli.main`` wrote: both checkpoints exist, every
    LoRA B of ``best_model.pt`` is non-zero and its base is the fresh random
    model, bit for bit.  Returns (fresh params, config, text tokenizer)."""
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.models.lora import leaves

    run_dir = os.path.join(root, summary["directory"])
    for role in ("best_model", "crash_model"):
        assert os.path.exists(os.path.join(run_dir, f"{role}.pt")), f"{role}.pt missing"
    best = torch.load(os.path.join(run_dir, "best_model.pt"), map_location=dev, weights_only=True)
    lora = best["state"]["trainable"]
    bs = [layer[n]["b"] for layer in lora["layers"] for n in layer]
    assert all(b.abs().max() > 0 for b in bs), "a LoRA B stayed zero"
    fresh, config, tokenizer = build_model(MODEL, vocab, dev)
    assert all(torch.equal(a, b) for a, b in zip(leaves(best["state"]["base"]), leaves(fresh))), \
        "the frozen base changed"
    print(f"best_model.pt: {len(bs)} LoRA B tensors non-zero (max |B| "
          f"{max(b.abs().max().item() for b in bs):.3e}); base bitwise unchanged")
    return fresh, config, tokenizer


def long_train_phase(root, vocab, merges):
    """Phase 10: ``cli.main`` trains at S = 4096 (``--pad_to_max 4092``, batch
    1) on the long data: every attention call goes through the flash
    kernels; then the train step at B1 x 4096 alone, its peak memory and
    its device time by kernel."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step

    phase("10. long train: cli.main --peft --dev --batch_size 1 --pad_to_max 4092 (S 4096, "
          "the flash kernels) from the device token cache, random Llama-3.2-1B at full width")
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root):
        result = cli_main.main(_cli_args(LONG["num_merges"]) + LONG_TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    summary = result["training"]
    steps, evals = summary["steps"], 2  # two epochs, one validation batch each
    print(f"launches {counts}; {steps} train steps, {evals} eval steps; "
          f"{summary['tokens']} tokens in {summary['seconds']:.1f} s; phase wall {wall:.1f} s")
    # as phase 6, with the flash kernels in the resident kernels' place
    expected = dict.fromkeys(SOURCES, 0)
    expected.update({"flash_attention": LAYERS * (steps + evals),
                     "flash_attention_bwd": LAYERS * steps,
                     "rmsnorm": (2 * LAYERS + 1) * (steps + evals),
                     "rmsnorm_bwd": 2 * LAYERS * steps,
                     "bpe_match": 2, "bpe_chain": 2})
    assert steps == 2 * LONG["n_train"], f"{steps} train steps"
    for name, n in counts.items():
        assert n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
    losses = summary["train_loss"] + summary["val_loss"]
    assert all(np.isfinite(losses)), losses
    print(f"train loss per epoch {summary['train_loss']}, val loss {summary['val_loss']}")
    fresh, config, tokenizer = check_run_dir(root, summary, vocab, dev)

    opt = make_optimizer(config.hidden_size, 500)
    state = create_train_state(config, opt, torch.Generator(device=dev).manual_seed(0),
                               peft=True, params=fresh)
    batch = _training_items(root, vocab, merges, tokenizer, 1, pad_to_max=4092)
    b, s = batch["input_ids"].shape
    assert s == 4096, s
    gen = torch.Generator().manual_seed(0)
    step = make_train_step(config, opt)
    state, ms, peak = time_train_step(step, state, batch, gen, "remat none")
    profile_steps(step, state, batch, gen)
    return counts, {"ms_per_step": ms, "tokens_per_s": b * s / ms * 1e3, "peak_gib": peak,
                    "checkpoint": os.path.basename(summary["directory"])}


def data_layer(root, vocab, merges, tokenizer, dev):
    """The training items' cost on the host clock, for the ptb_500 train
    split: the token cache's build (all records on the card) and ms per item
    read from it, against ms per item with the host encode of
    ``--online_encode``."""
    import numpy as np

    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/train", f"{data}/ptb_500/text/train")
    cfg = DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy", pad_to_max=1020)
    items = {}
    for name, cache in (("host encode", False), ("token cache", True)):
        t0 = time.perf_counter()
        ds = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=tokenizer, args=cfg,
                             cache_tokens=cache, device=dev)
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        items[name] = [ds[i] for i in range(len(ds))]
        per_item = (time.perf_counter() - t0) / len(ds) * 1e3
        print(f"data, {name}: {per_item:.3f} ms per item over {len(ds)} items (host clock); "
              f"dataset built in {built * 1e3:.1f} ms")
    for a, b in zip(*items.values()):
        assert all(np.array_equal(a[k], b[k]) for k in a), "cached and host-encoded items differ"


def profile_steps(step, state, batch, gen, n=2):
    """Device time by kernel over ``n`` train steps (torch.profiler), the
    kernels grouped by what they do, and the device's idle share of the
    window's wall time (an upper bound: the profiler adds host time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            state, _ = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    # the attention kernels are ecg::fwd::fwd_kernel<D, flash>,
    # ecg::bwd::dq_kernel<D, flash> and dkv_kernel<D, flash, parts>: the
    # policy names the path
    groups = {"flash attention backward (bwd::dq_kernel, dkv_kernel <D, true>)":
              (("bwd::dq_kernel<", "bwd::dkv_kernel<"), ("true",)),
              "flash attention forward (fwd::fwd_kernel <D, true>)":
              (("fwd::fwd_kernel<",), ("true",)),
              "attention backward (bwd::dq_kernel, dkv_kernel <D, false>)":
              (("bwd::dq_kernel<", "bwd::dkv_kernel<"), ("false",)),
              "attention forward (fwd::fwd_kernel <D, false>)": (("fwd::fwd_kernel<",), ("false",)),
              "rmsnorm (rmsnorm_fwd_kernel, rmsnorm_bwd_kernel, rmsnorm_dw_sum_kernel)":
              (("rmsnorm_fwd_kernel<", "rmsnorm_bwd_kernel<", "rmsnorm_dw_sum_kernel<"), ()),
              "matmuls (cuBLAS)": (("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas"), ())}
    totals = dict.fromkeys(list(groups) + ["other"], 0.0)
    kernels = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        # kernels only: not the host ops above them, nor the ranges that
        # annotate them on the device timeline ("Optimizer.step#Adam.step")
        if (e.device_type != DeviceType.CUDA or us <= 0
                or e.key.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        kernels.append((us, e.count, e.key))
        group = next((g for g, (keys, also) in groups.items()
                      if any(k in e.key for k in keys) and all(k in e.key for k in also)),
                     "other")
        totals[group] += us
    busy_ms = sum(totals.values()) / 1e3
    print(f"profile of {n} train steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} (upper bound)")
    for g, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / n:8.2f} ms/step  {100 * us / 1e3 / busy_ms:5.1f}%  {g}")
    print("  top kernels (ms/step, calls/step):")
    for us, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {us / 1e3 / n:8.3f}  {count / n:6.1f}  {key[:110]}")


def serve_phase(root, checkpoint, path):
    """``cli.main --inference --peft`` with ``path``'s arguments on the
    checkpoint, LoRA merged: every kernel's launch count, every prompt at
    least ``path.min_prompt`` tokens.  Returns the counts and decode
    ms/token."""
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.models import llama_3_2_1b

    phase(path.serve_title)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root):
        result = cli_main.main(_cli_args(path.num_merges) + [
            "--inference", "--dev", "--peft", "--checkpoint", checkpoint, "--eval_batch_size", "1",
            *path.args])
    wall = time.perf_counter() - t0
    counts = launches()
    serving, records = result["serving"], result["records"]
    prefills, steps = serving["records"], serving["decode_steps"]
    print(f"launches {counts}; {prefills} prefills, {steps} decode steps")
    expected = dict.fromkeys(SOURCES, 0)
    for per, n in ((path.per_prefill, prefills), (path.per_step, steps),
                   (path.per_forward, prefills + steps)):
        for name, k in per.items():
            expected[name] += k * n
    assert prefills == 5 * path.records, f"{prefills} records decoded"
    for name, n in counts.items():
        assert n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
        assert n > 0 or name not in path.kernels
    vocab_size = llama_3_2_1b().vocab_size  # the ECG tokens fit inside it
    for r in records:
        toks = r["tokens"]
        assert toks.shape == (1, 128) and toks.min() >= 0 and toks.max() < vocab_size
    lens = [r["prompt_len"] for r in records]
    print(f"every prompt's bucketed length: {lens}")
    assert min(lens) >= path.min_prompt, lens
    ms_step = serving["decode_ms_per_step"]
    print(f"bucketed prompt lengths {serving['prompt_lens']}; prefill "
          f"{serving['prefill_ms_mean']:.2f} ms/record; decode {ms_step:.3f} ms/token "
          f"= {1e3 / ms_step:.1f} tok/s at batch 1 (host clock around synchronize)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"phase wall {wall:.1f} s")
    return counts, ms_step


def paths_phase(root, vocab, merges, path):
    """One prompt of ``root``'s first test record + TEACHER_FORCED tokens
    through prefill and decode_step with the kernels, with the plain
    versions, and in f32 activations (the plain versions on the same
    weights: for an int8 path, the same int8 weights and int8 cache); the
    kernel path must be no further from the f32 run than 1.25x the plain
    path, and launches only ``path``'s kernels; then the device time of a
    decode step."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.models.quantized import quantize_lm_int8
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    phase(path.check_title)
    dev = torch.device("cuda")
    data = os.path.join(root, "data")
    params, config, tok = build_model(MODEL, vocab, dev)
    cache_dtype = None
    if path.int8:
        params, cache_dtype = quantize_lm_int8(params, config), torch.int8
    kernels = path.kernels
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/test", f"{data}/ptb_500/text/test")
    item = ECGTokenDataset(
        sigs[:1], texts[:1], vocab, merges, tokenizer=tok,
        args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy", inference=True),
    )[0]
    n = len(item["tokenized_signal"])
    s = bucket(n)  # left-padded to the bucket, as the CLI does
    ids = np.concatenate([np.full(s - n, tok.pad_token_id), item["tokenized_signal"]])
    mask = np.concatenate([np.zeros(s - n), np.ones(n)])
    ids = torch.from_numpy(ids).long()[None].to(dev)
    mask = torch.from_numpy(mask).to(torch.int32)[None].to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    forced = torch.randint(0, config.vocab_size, (TEACHER_FORCED,), generator=gen, device=dev)

    @torch.inference_mode()
    def run(params, config, cache_dtype=cache_dtype, steps=TEACHER_FORCED, on_step=None):
        cache = T.init_kv_cache(config, 1, s + TEACHER_FORCED, dev, dtype=cache_dtype)
        logits, cache, pos = T.prefill(params, config, ids, mask, cache)
        out = [logits]
        cache_mask = torch.cat(
            [mask, torch.zeros(1, TEACHER_FORCED, dtype=torch.int32, device=dev)], 1)
        pos = pos.to(torch.int32)
        for step in range(steps):
            if on_step is not None:
                on_step(step)
            cache_mask[:, s + step] = 1
            logits, cache = T.decode_step(
                params, config, forced[step:step + 1], pos, s + step, cache, cache_mask)
            out.append(logits)
            pos = pos + 1
        return torch.stack(out)  # (1 + steps, 1, V)

    # f32 activations: the bf16 leaves in f32, the int8 weights kept int8
    # (a blanket .float() would turn them into a bf16-path weight)
    f32 = lambda t: t.float() if t.dtype == torch.bfloat16 else t  # noqa: E731
    before = launches()
    kern = run(params, config)
    mid = launches()
    with plain_path():
        plain = run(params, config)
        ref = run(_map_tree(f32, params), config.replace(dtype="float32"))
    after = launches()
    assert all(mid[k] > before[k] for k in kernels), "the kernel run launched no kernel"
    assert all(mid[k] == before[k] for k in SOURCES if k not in kernels), (before, mid)
    assert after == mid, "the plain runs launched a kernel"
    print(f"prompt {n} tokens bucketed to {s}")
    by_wrapper = {}  # the int8 products share one wrapper, and so one swap
    for name in kernels:
        by_wrapper.setdefault(_counters()[name][0], []).append(name)
    for names in by_wrapper.values():  # how far one wrapper's kernels alone move the logits
        with plain_path([k for k in kernels if k not in names]):
            only = run(params, config)
        print(f"  only {' and '.join(names)} as kernel, vs plain path: worst "
              f"{step_errors(only, plain).max().item():.3e}")
    hold_logits(kern, plain, ref)
    decode_device_time(run, params, config, s, "int8" if path.int8 else "bf16")


def step_errors(a, b):
    """max|a - b| / max|b| at each step of (steps, B, V) logits."""
    return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).cpu()


def hold_logits(kern, plain, ref):
    """Teacher-forced logits (steps, B, V) with the kernels, with the plain
    versions and in f32 activations (the plain versions on the same
    weights and cache types): the kernel path no further from f32 than
    1.25x the plain path, and no further from the plain path than 2x the
    plain path's own error.  Any bf16 rounding difference, even RMSNorm's
    rare 1-ulp ones, grows through 16 random layers to about the bf16
    path's own error against f32; the bounds are therefore relative to
    that error.  Greedy argmax agreement is printed, not held: near-ties
    under random weights may flip."""
    import torch

    assert all(torch.isfinite(x).all() for x in (kern, plain, ref))
    d_kp, d_pr, d_kr = step_errors(kern, plain), step_errors(plain, ref), step_errors(kern, ref)
    print(f"max|dlogits|/max|logits| over {d_kp.numel()} steps of {kern.shape[1]} row(s), "
          "worst / mean:")
    print(f"  kernel path vs plain path    {d_kp.max().item():.3e} / {d_kp.mean().item():.3e}")
    print(f"  plain path vs f32 reference  {d_pr.max().item():.3e} / {d_pr.mean().item():.3e}")
    print(f"  kernel path vs f32 reference {d_kr.max().item():.3e} / {d_kr.mean().item():.3e}")
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    print(f"greedy argmax of kernel and plain paths agrees at {agree} of "
          f"{kern.shape[0] * kern.shape[1]} positions (not held)")
    assert d_kr.max() <= 1.25 * d_pr.max(), "kernel path further from f32 than the plain path"
    assert d_kp.max() <= 2 * d_pr.max(), "kernel and plain paths differ beyond the bf16 error"


def append_then_kernel(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None, splits=None,
                       *, fresh_k=None, fresh_v=None, write_idx=None):
    """Decode attention as the decode step ran it before the kernel took
    this token's row: the append first (``kv_quant.append_kv`` for the int8
    cache, two slice copies for the bf16 one), then the kernel on the
    updated cache.  A stand-in for ``decode_attention_fused`` that
    measures what the fused row saves."""
    from ecg_byte_tpu_torch.ops import kv_quant

    if k_scale is not None:
        kv_quant.append_kv(fresh_k, fresh_v, k_cache, v_cache, k_scale, v_scale, write_idx)
    else:
        k_cache[:, write_idx:write_idx + 1] = fresh_k
        v_cache[:, write_idx:write_idx + 1] = fresh_v
    kernel = _counters()["decode_attention"][0]  # the wrapper, whatever is patched in
    return kernel(q, k_cache, v_cache, valid_mask, k_scale, v_scale, splits)


# the wrapper counts its launches on what its module's name holds, which is
# this function while it is patched in
append_then_kernel.launches = append_then_kernel.int8_launches = 0


def decode_device_time(run, params, config, s, label, steps=8):
    """Device time and device launches of a decode step of ``run`` after a
    prompt bucketed to ``s``: ``torch.profiler`` over ``steps``
    teacher-forced steps after the prefill (cut from 16: the profiler took
    most of phases 5, 9 and 12), the kernels' (and copies')
    device time summed and their launches counted; beside it the wall time
    of the same steps (host clock, the profiler's overhead included).  Once
    as the decode step runs, once with the append before the kernel
    (:func:`append_then_kernel`), in the order fused, append, append,
    fused."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ecg_byte_tpu_torch.ops import attention_decode

    _counters()  # the wrappers themselves, before the patch below

    def measure():
        run(params, config, steps=2)  # warm
        torch.cuda.synchronize()
        marks = {}

        def on_step(step):
            if step == 1:  # the prefill and the first step are outside the window
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
                prof.start()

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        run(params, config, steps=steps + 1, on_step=on_step)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - marks["t0"]) / steps * 1e3
        prof.stop()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
        n = sum(e.count for e in kernels) / steps
        return busy, wall, n, sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]

    variants = {"fused append": contextlib.nullcontext,
                "append, then kernel": lambda: mock.patch.object(
                    attention_decode, "decode_attention_fused", append_then_kernel)}
    got = {}
    for name in list(variants) + list(reversed(variants)):
        with variants[name]():
            got.setdefault(name, []).append(measure())
    for name, (first, second) in got.items():
        busy, wall, n = ((a + b) / 2 for a, b in zip(first[:3], second[:3]))
        print(f"decode step after a {s}-token prompt, {label}, {name}, over {steps} steps x 2 "
              f"(torch.profiler): device busy {busy:.3f} ms/step, {n:.1f} device launches a "
              f"token, wall {wall:.3f} ms/step, idle share {max(0.0, 1 - busy / wall):.3f}; "
              "top: " + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / steps:.3f}"
                                  for e in first[3]))


def train_paths_phase(root, vocab, merges, check, model=MODEL, dev="cuda"):
    """Loss and LoRA gradients of ``check.items`` training items (S =
    pad_to_max + 4), each with its own draw of LoRA B, with the kernels,
    with the plain versions and in f32; the kernel path must be no further
    from f32 than 1.25x the plain path, and launches only ``check.kernels``.

    The training loss is the mean next-token cross entropy over the
    labelled positions (the ~25 answer tokens).  Over all items together,
    by the norm of their error as the gradient groups are, each is held:
    the cross entropy at the labelled positions, the one at every valid
    position (the hidden states of the whole sequence), and each LoRA
    gradient group.  The loss itself is held item by item to 1.25x the
    plain path's RMS cross-entropy error at its labelled positions: the
    most a mean of those terms can move if the kernel's terms are as good
    as plain's.  The ratio of the two scalar losses' errors is printed: a
    mean of signed errors that cancel by chance, it falls on either side
    of 1.25 from item to item (PERF.md, section 6)."""
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.train.step import _batch_tensors

    phase(check.title)
    s = check.pad_to_max + 4
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params, config, tok = build_model(model, vocab, dev)
    items = _batch_tensors(_training_items(root, vocab, merges, tok, check.items,
                                           check.pad_to_max), dev)
    assert items["input_ids"].shape == (check.items, s), items["input_ids"].shape
    batches = [{k: v[i:i + 1] for k, v in items.items()} for i in range(check.items)]
    loras = [random_lora(config, 2 + i, dev) for i in range(check.items)]
    def run(params, lora, config, batch):
        return lora_loss_and_grads(params, lora, config, batch)[0]

    before = launches()
    kern = [run(params, lora, config, batch) for lora, batch in zip(loras, batches)]
    mid = launches()
    with plain_path():
        plain = [run(params, lora, config, batch) for lora, batch in zip(loras, batches)]
        f32 = lambda t: t.float()  # noqa: E731
        params32, config32 = _map_tree(f32, params), config.replace(dtype="float32")
        ref = [run(params32, _map_tree(f32, lora), config32, batch)
               for lora, batch in zip(loras, batches)]
        del params32
    after = launches()
    if dev.type == "cuda":  # the plain versions count nothing
        assert all(mid[k] > before[k] for k in check.kernels), (before, mid)
    assert all(mid[k] == before[k] for k in SOURCES if k not in check.kernels), (before, mid)
    assert after == mid, "the plain runs launched a kernel"
    print(f"{check.items} items at B1 x {s}, each with its own LoRA B; errors against f32:")
    hold_train_paths(kern, plain, ref)


def path_error_ratios(kern, plain, ref):
    """A step's distance from ``ref`` over ``plain``'s (each ``(loss, cross
    entropies at the labelled and at the valid positions, {group:
    gradient}[, at the last left-pad rows])``, as :func:`lora_loss_and_grads`
    returns them): the cross entropies', and the largest and the smallest
    of the gradient groups'; where the last left-pad rows are given, theirs
    alone and with the valid positions'."""
    import torch

    def ratio(j, g=None):
        k, p, r = (x[j] if g is None else x[j][g] for x in (kern, plain, ref))
        dk, dp = (torch.linalg.vector_norm(a - r).item() for a in (k, p))
        return dk / dp if dp else (0.0 if dk == 0 else math.inf)

    groups = [ratio(3, g) for g in ref[3]]
    out = {"ce_labelled": ratio(1), "ce_valid": ratio(2), "grad_max": max(groups),
           "grad_min": min(groups)}
    if len(ref) > 4 and ref[4].numel():  # the last left-pad rows: alone, and with the valid ones
        out["ce_last_pad"] = ratio(4)
        k, p, r = (torch.cat([x[2], x[4]]) for x in (kern, plain, ref))
        dp = torch.linalg.vector_norm(p - r).item()
        out["ce_valid_and_last_pad"] = torch.linalg.vector_norm(k - r).item() / dp if dp else 0.0
    return out


def random_lora(config, seed, dev):
    """Adapters of ``lora.init_lora`` from a generator seeded with ``seed``,
    B drawn too (1e-2 N(0, 1)), so that dA != 0."""
    import torch

    from ecg_byte_tpu_torch.models import lora as lora_lib

    gen = torch.Generator(device=dev).manual_seed(seed)
    lora = lora_lib.init_lora(config, gen, dev)
    for layer in lora["layers"]:
        for ab in layer.values():
            ab["b"] = (1e-2 * torch.randn(ab["b"].shape, generator=gen, device=dev)).to(
                ab["b"].dtype)
    return lora


def valid_predictions(attn_mask):
    """(..., S - 1) bool: the next-token predictions made at a valid position
    of a valid token.  The last left-pad row predicts the first valid token,
    but its every key is masked, and the attention kernels, the plain
    version and the TPU kernel each average V over other keys there
    (nothing of the model reads such a row): no kernel output there is
    held."""
    m = attn_mask.bool()
    return m[..., :-1] & m[..., 1:]


def lora_loss_and_grads(params, lora, config, batch):
    """One forward and backward of the LoRA loss on ``batch``, dropout off:
    ((loss, cross entropies at the labelled and at the valid positions
    (:func:`valid_predictions`), {LoRA gradient group: flat f32 gradient},
    cross entropies at the last left-pad rows), the kernels that forward
    and backward launched)."""
    import torch

    from ecg_byte_tpu_torch.models import transformer as T

    lora = _map_tree(lambda t: t.detach().clone().requires_grad_(True), lora)
    before = launches()
    hidden = T.forward(params, config, batch["input_ids"], batch["attn_mask"],
                       batch["position_ids"], lora=lora, return_hidden=True)
    loss = T.lm_loss_from_hidden(params, config, hidden, batch["labels"])
    loss.backward()
    counts = {k: n - before[k] for k, n in launches().items()}
    with torch.no_grad():
        logits = T._unembed(params, config, hidden)[:, :-1]
        lse = torch.logsumexp(logits, -1)
        labels, nxt = batch["labels"][:, 1:], batch["input_ids"][:, 1:]
        ce_lab = lse - logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        ce_all = lse - logits.gather(-1, nxt[..., None])[..., 0]
        del logits
    names = [(name, k) for name in lora["layers"][0] for k in ("a", "b")]
    grads = {f"LoRA {n}.{k}": torch.cat([layer[n][k].grad.float().flatten()
                                         for layer in lora["layers"]]) for n, k in names}
    valid = valid_predictions(batch["attn_mask"])
    last_pad = batch["attn_mask"][:, 1:].bool() & ~valid
    return (loss.item(), ce_lab[labels != -100], ce_all[valid], grads, ce_all[last_pad]), counts


def hold_train_paths(kern, plain, ref, held=("labelled", "valid")):
    """The rules of :func:`train_paths_phase` on its runs: each a list over
    items of (loss, cross entropies at the labelled and at the valid
    positions, {gradient group: flat f32 gradient}), with the kernels, the
    plain versions and in f32.  ``held``: the positions whose pooled cross
    entropy is held (both are printed)."""
    import torch

    def rel(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    ratios, too_far = [], []
    for i, (k, p, r) in enumerate(zip(kern, plain, ref)):
        dk, dp = abs(k[0] - r[0]), abs(p[0] - r[0])
        n = r[1].numel()
        # the rule of phase 5, at the plain path's per-token scale: the
        # kernel's loss no further from f32 than 1.25x plain's RMS error
        bound = 1.25 * (torch.linalg.vector_norm(p[1] - r[1]) / n**0.5).item()
        ratios.append(dk / max(dp, 1e-30))
        print(f"  item {i}: loss kernel {k[0]:.6f}, plain {p[0]:.6f}, f32 {r[0]:.6f}; |dloss| "
              f"kernel {dk:.3e} (bound {bound:.3e}), plain {dp:.3e}, ratio {ratios[-1]:.3f}; "
              f"cross entropy at {n} labelled positions |dce|/|ce| kernel {rel(k[1], r[1]):.3e}, "
              f"plain {rel(p[1], r[1]):.3e}")
        if dk > bound:
            too_far.append(i)
    print(f"scalar loss error ratio kernel / plain per item {[round(x, 3) for x in ratios]}: "
          f"{sum(x > 1.25 for x in ratios)} of {len(ratios)} above 1.25 (not held: see the "
          "docstring)")

    def pooled(path, j):
        return torch.cat([x[j] for x in path])

    ce = {}  # positions: (count, kernel error, plain error)
    for what, j in (("labelled", 1), ("valid", 2)):
        r = pooled(ref, j)
        ce[what] = (r.numel(), rel(pooled(kern, j), r), rel(pooled(plain, j), r))
    grads = {g: (rel(torch.cat([x[3][g] for x in kern]), torch.cat([x[3][g] for x in ref])),
                 rel(torch.cat([x[3][g] for x in plain]), torch.cat([x[3][g] for x in ref])))
             for g in kern[0][3]}
    print("all items together, |d|/|ref| vs f32 (kernel / plain):")
    for what, (n, ek, ep) in ce.items():
        print(f"  cross entropy at {n} {what} positions: {ek:.3e} / {ep:.3e}")
    for name, (ek, ep) in grads.items():
        print(f"  {name}: {ek:.3e} / {ep:.3e}")
    # the rule of phase 5: the kernel path no further from f32 than 1.25x
    # the plain path's own bf16 error
    assert not too_far, f"items {too_far}: loss further from f32 than its bound"
    for what in held:
        _, ek, ep = ce[what]
        assert ek <= 1.25 * ep, f"cross entropy at the {what} positions: {ek:.3e} vs plain {ep:.3e}"
    bad = [name for name, (ek, ep) in grads.items() if ek > 1.25 * ep]
    assert not bad, f"gradient groups further from f32 than 1.25x the plain path: {bad}"


# phase 14: the size-exact Llama-3.2-1B checkpoint directory
# (cli.make_flagship_fixture), the tensors read back after it is written
# (the first ones drawn: only they are cheap to draw again), and BERTScore's
# card and CPU scorers, which agree within SCORER_TOL (f32, TF32 off)
HF_FIXTURE = "llama32_1b_fixture"
HF_READBACK = 3
SCORER_TOL = 1e-4
BERT_BASE = dict(hidden=768, layers=12, heads=12, intermediate=3072)


def check_readback(written, read):
    """Each tensor of ``written`` (name -> tensor) equals the one ``read``
    back from the file: dtype, shape and every bit (torch.equal)."""
    import torch

    for name, want in written.items():
        got = read.get(name)
        assert got is not None, f"{name} is not in the file"
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{name}: read {got.dtype} {tuple(got.shape)}, wrote {want.dtype} {tuple(want.shape)}"
        assert torch.equal(got, want), f"{name}: read back differs from what was written"


def check_round_trip(tokenizer, texts):
    """``decode(encode(t)) == t`` for every text, without specials."""
    for t in texts:
        back = tokenizer.decode(tokenizer.encode(t, add_special_tokens=False))
        assert back == t, f"decode(encode({t!r})) is {back!r}"


def check_launch_counts(counts, expected, what):
    """Every kernel's launch count is exactly the expected one."""
    for name, n in counts.items():
        assert n == expected.get(name, 0), \
            f"{what}: {name} launched {n} times, expected {expected.get(name, 0)}"


def check_bertscore(modes, f1s):
    """The serving run scored BERTScore with the local BERT only (every
    seed's ``metric_modes``) and every sample's F1 lies in (0, 1]."""
    assert modes and all(m.get("bertscore") == ["local-bert"] for m in modes), \
        f"BERTScore modes {modes}"
    assert f1s and all(0.0 < f <= 1.0 for f in f1s), f"F1 outside (0, 1]: {f1s}"


def check_scorers(card, cpu, tol=SCORER_TOL):
    """The card's and the CPU's P, R and F1 agree within ``tol``; returns
    the largest difference."""
    worst = 0.0
    for key in ("precision", "recall", "f1"):
        assert len(card[key]) == len(cpu[key]), f"{key}: {len(card[key])} vs {len(cpu[key])} pairs"
        for a, b in zip(card[key], cpu[key]):
            assert abs(a - b) <= tol, f"BERTScore {key}: card {a!r}, CPU {b!r} (tol {tol})"
            worst = max(worst, abs(a - b))
    return worst


def write_random_bert(out_dir, texts, hidden, layers, heads, intermediate, seed=0):
    """A random BERT checkpoint directory (f32, HF key names) whose
    ``vocab.txt`` holds the five specials, every character of ``texts``
    (lower-cased), their ``##`` pieces and the texts' words; written with
    the port's safetensors writer.  Returns the vocabulary size."""
    import torch

    from ecg_byte_tpu_torch.models.hf_loader import save_safetensors
    from ecg_byte_tpu_torch.tokenizer.wordpiece import basic_tokenize

    words = sorted({w for t in texts for w in basic_tokenize(t)})
    chars = sorted({c for w in words for c in w})
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + [f"##{c}" for c in chars]
             + [w for w in words if w not in chars])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    V, H, I, P = len(vocab), hidden, intermediate, 512
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "vocab_size": V, "hidden_size": H,
                   "num_hidden_layers": layers, "num_attention_heads": heads,
                   "intermediate_size": I, "max_position_embeddings": P, "type_vocab_size": 2,
                   "layer_norm_eps": 1e-12}, f)
    gen = torch.Generator().manual_seed(seed)

    def dense(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    t = {"embeddings.word_embeddings.weight": dense(V, H),
         "embeddings.position_embeddings.weight": dense(P, H),
         "embeddings.token_type_embeddings.weight": dense(2, H),
         "embeddings.LayerNorm.weight": torch.ones(H), "embeddings.LayerNorm.bias": torch.zeros(H),
         "pooler.dense.weight": dense(H, H), "pooler.dense.bias": torch.zeros(H)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            t[p + f"attention.self.{name}.weight"] = dense(H, H)
            t[p + f"attention.self.{name}.bias"] = torch.zeros(H)
        for name, shape in (("attention.output.dense", (H, H)), ("intermediate.dense", (I, H)),
                            ("output.dense", (H, I))):
            t[p + name + ".weight"] = dense(*shape)
            t[p + name + ".bias"] = torch.zeros(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[p + name + ".weight"] = torch.ones(H)
            t[p + name + ".bias"] = torch.zeros(H)
    save_safetensors(t, os.path.join(out_dir, "model.safetensors"))
    return V


def hf_phase(root, vocab, merges):
    """Phase 14: the size-exact Llama-3.2-1B directory written by the port's
    ``cli.make_flagship_fixture``, read back; its tokenizer round-trips the
    dataset's texts; ``cli.main --hf_weights`` trains with LoRA from the
    device token cache and serves the checkpoint with BERTScore on a random
    BERT-base; the card's and the CPU's scorers agree.  Returns the launch
    counts of both runs and the phase's numbers."""
    import itertools

    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import common
    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli import make_flagship_fixture as fixture_cli
    from ecg_byte_tpu_torch.data import load_text_tokenizer
    from ecg_byte_tpu_torch.data.datasets import parse_question_answer
    from ecg_byte_tpu_torch.models.hf_loader import read_safetensors_file
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step
    from ecg_byte_tpu_torch.utils import bertscore, metrics

    phase("14. HF checkpoint: a size-exact Llama-3.2-1B directory, cli.main --hf_weights "
          "--peft --dev (train) and --inference --toy with BERTScore on a local BERT")
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    fixture = os.path.join(root, HF_FIXTURE)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        stats = fixture_cli.main(["--out", fixture])
    print(f"fixture written in {time.perf_counter() - t0:.1f} s: {stats['weight_bytes']:,} bytes "
          f"of bf16 weights (drawn in {stats['draw_weights_s']} s, with the write "
          f"{stats['write_weights_s']} s), tokenizer.json of {stats['tokenizer_vocab']:,} rows, "
          f"{stats['tokenizer_json_bytes']:,} bytes ({stats['write_tokenizer_s']} s)")
    cfg = fixture_cli._FLAGSHIP_CONFIG
    written = dict(itertools.islice(fixture_cli.weight_stream(cfg, 0), HF_READBACK))
    read = read_safetensors_file(os.path.join(fixture, "model.safetensors"))
    check_readback(written, read)
    print(f"read back equal (torch.equal): {', '.join(written)}; {len(read)} tensors in the file")
    del written, read

    data = os.path.join(root, "data", "ptb_500", "text")
    texts = set()
    for split in ("train", "val", "test"):
        for name in sorted(os.listdir(os.path.join(data, split))):
            with open(os.path.join(data, split, name)) as f:
                texts.update(parse_question_answer(json.load(f), "ptb_500"))
    texts = sorted(texts)
    t0 = time.perf_counter()
    tokenizer = load_text_tokenizer(fixture)
    t_tok = time.perf_counter() - t0
    check_round_trip(tokenizer, texts)
    print(f"tokenizer.json loaded in {t_tok:.1f} s ({len(tokenizer):,} tokens); decode(encode(t)) "
          f"== t for the dataset's {len(texts)} texts")

    builds = []  # (seconds, config) of each model build the CLI makes
    real_build = common.build_model

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        out = real_build(*args, **kw)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, out[1]))
        return out

    args = ["--hf_weights", fixture, "--dataset", "ptb_500", "--tokenizer_check",
            f"tokenizer_{NUM_MERGES}", "--num_merges", str(NUM_MERGES), "--percentiles",
            "data/ptb_500_dataset_stats.npy"]
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root), mock.patch.object(cli_main, "build_model", timed_build):
        result = cli_main.main(args + TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = launches()
    summary = result["training"]
    steps, evals = summary["steps"], 2
    build_s, config = builds[-1]
    print(f"launches {train_counts}; {steps} train steps, {evals} eval steps; "
          f"phase wall {wall:.1f} s")
    assert steps == 12, f"{steps} train steps"
    assert config.vocab_size == len(tokenizer) + len(vocab) + 3, config.vocab_size
    # as phase 6: per train step each layer's attention forward and
    # backward, 2L + 1 norms forward and 2L backward; per eval step the
    # forwards; each BPE kernel once per split's batch of the token cache
    L = LAYERS
    check_launch_counts(train_counts, {
        "prefill_attention": L * (steps + evals), "prefill_attention_bwd": L * steps,
        "rmsnorm": (2 * L + 1) * (steps + evals), "rmsnorm_bwd": 2 * L * steps,
        "bpe_match": 2, "bpe_chain": 2}, "HF training")
    losses = summary["train_loss"] + summary["val_loss"]
    assert all(np.isfinite(losses)), losses
    print(f"model built from --hf_weights in {build_s:.1f} s: vocab {config.vocab_size:,} "
          f"(128,256 + {config.vocab_size - 128256:,} ECG tokens and specials, mean rows), "
          f"hidden {config.hidden_size}, layers {config.num_layers}, {config.dtype}; "
          f"train loss {summary['train_loss']}, val loss {summary['val_loss']}")

    # the train step alone at B4 x 1024 on the loaded weights, as phase 6
    params, config, hf_tok = common.build_model(None, vocab, dev, hf_weights=fixture)
    opt = make_optimizer(config.hidden_size, 500)
    state = create_train_state(config, opt, torch.Generator(device=dev).manual_seed(0),
                               peft=True, params=params)
    del params
    batch = _training_items(root, vocab, merges, hf_tok, 4)
    b, s = batch["input_ids"].shape
    state, ms_step, _ = time_train_step(make_train_step(config, opt, remat="none"), state, batch,
                                        torch.Generator().manual_seed(0), "--hf_weights")
    del state, batch
    torch.cuda.empty_cache()

    bert_dir = os.path.join(root, "bert_base")
    t0 = time.perf_counter()
    n_bert = write_random_bert(bert_dir, texts, **BERT_BASE)
    print(f"random BERT-base (12 layers, hidden 768, f32, {n_bert} WordPiece rows) written in "
          f"{time.perf_counter() - t0:.1f} s")
    f1s = []
    real_score = metrics.bertscore_with_mode

    def scored(references, hypotheses, device=None):
        out = real_score(references, hypotheses, device)
        f1s.extend(out[0]["hf-f1"])
        return out

    checkpoint = os.path.basename(summary["directory"])
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root), mock.patch.dict(os.environ, {bertscore.MODEL_ENV: bert_dir}), \
            mock.patch.object(metrics, "bertscore_with_mode", scored):
        result = cli_main.main(args + ["--inference", "--dev", "--peft", "--toy", "--checkpoint",
                                       checkpoint, "--eval_batch_size", "1"])
    wall = time.perf_counter() - t0
    serve_counts = launches()
    serving = result["serving"]
    prefills, dsteps = serving["records"], serving["decode_steps"]
    print(f"launches {serve_counts}; {prefills} prefills, {dsteps} decode steps; "
          f"phase wall {wall:.1f} s")
    assert prefills == 5 * max(1, int(N_TEST * 0.25)), f"{prefills} records decoded"
    check_launch_counts(serve_counts, {
        "prefill_attention": L * prefills, "decode_attention": L * dsteps,
        "rmsnorm": (2 * L + 1) * (prefills + dsteps)}, "HF serving")
    for r in result["records"]:
        toks = r["tokens"]
        assert toks.shape == (1, 128) and toks.min() >= 0 and toks.max() < config.vocab_size
    modes = []
    for seed in (0, 42, 123, 456, 789):
        with open(os.path.join(root, "runs", "0", checkpoint,
                               f"seed_{seed}_results_ptb_500.json")) as f:
            modes.append(json.load(f)["metric_modes"])
    check_bertscore(modes, f1s)
    print(f"BERTScore mode local-bert in every seed; {len(f1s)} F1s in "
          f"[{min(f1s):.4f}, {max(f1s):.4f}]")

    refs = texts[:4]
    cands = [texts[(i + 1) % len(texts)] for i in range(len(refs))]
    card = bertscore.LocalBertScorer(bert_dir, device=dev)
    cpu = bertscore.LocalBertScorer(bert_dir, device="cpu")
    card.score(refs, cands)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.score(refs, cands)
    scorer_ms = (time.perf_counter() - t0) * 1e3 / len(refs)
    worst = check_scorers(got, cpu.score(refs, cands))
    print(f"LocalBertScorer on the card vs the CPU, {len(refs)} pairs: max |d| {worst:.2e} over "
          f"P, R, F1 (tol {SCORER_TOL}); {scorer_ms:.2f} ms a pair on the card (host clock)")
    numbers = {"vocab": config.vocab_size, "build_s": build_s, "ms_per_step": ms_step,
               "tokens_per_s": b * s / ms_step * 1e3,
               "prefill_ms": serving["prefill_ms_mean"],
               "ms_per_token": serving["decode_ms_per_step"], "scorer_ms_per_pair": scorer_ms}
    print(f"phase 14: {json.dumps(numbers)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"hf_train": train_counts, "hf_serve": serve_counts}, numbers


# ------------------------------------------------------- phase 15: preprocess

RAW_RECORDS = 512  # MIMIC-IV-ECG-shaped: 12 leads x 5,000 samples at 500 Hz, format 16
# records bad on purpose, by instance index: the samples overflow to inf (a
# gain of 1e-320), fs 250, 100 samples, no .dat file; each is skipped
RAW_BAD = {3: "inf", 100: "fs250", 201: "short", 402: "missing"}
PTB_RECORDS = 32
RAW_GAIN = 200.0  # adc units per mV
RAW_LEADS = ("I", "II", "III", "aVR", "aVF", "aVL", "V1", "V2", "V3", "V4", "V5", "V6")
PREPROCESS_SEG_LENS = (2500, 500)
PREPROCESS_BATCH = 64  # records per batch: the CLI's default
PREPROCESS_MERGES = 400
SAMPLE_CLUSTERS = 100
# against float64 scipy, |d| / max|ref| (tests/test_dsp.py:40, :67): the
# filter chain and the whole chain 2e-4, the cubic resample 2e-5
FILTER_TOL = 2e-4
RESAMPLE_TOL = 2e-5
# the card's preprocess_records against the port's CPU path on the same
# batch, |d| / max|cpu|: both are float32 products of the same operators in
# another summation order
CARD_CPU_TOL = 2e-5
PEAK_FLOPS_F32 = 67e12  # FP32 outside the tensor cores, H100 SXM (NVIDIA's data sheet)
# PTB-XL SCP statements (scp_statements.csv): code -> (diagnostic, form,
# rhythm, diagnostic_class, diagnostic_subclass); None is an empty cell
SCP = {
    "NORM": (1, None, None, "NORM", "NORM"), "IMI": (1, None, None, "MI", "IMI"),
    "ASMI": (1, None, None, "MI", "AMI"), "LVH": (1, None, None, "HYP", "LVH"),
    "NDT": (1, None, None, "STTC", None), "ISC_": (1, None, None, "STTC", "ISC_"),
    "IRBBB": (1, None, None, "CD", "IRBBB"), "1AVB": (1, None, None, "CD", "_AVB"),
    "ABQRS": (None, 1, None, None, None), "PVC": (None, 1, 1, None, None),
    "LOWT": (None, 1, None, None, None), "SR": (None, None, 1, None, None),
    "AFIB": (None, None, 1, None, None), "STACH": (None, None, 1, None, None),
}
PTB_DIAGNOSTIC = ("NORM", "IMI", "ASMI", "LVH", "NDT", "ISC_", "IRBBB", "1AVB")


def write_wfdb16(directory, name, adc, fs=500, gain=RAW_GAIN, leads=RAW_LEADS):
    """A format-16 WFDB record ``directory/name`` (.hea and .dat): ``adc``
    (n, n_sig) int16, one gain for every signal (a number or its text)."""
    os.makedirs(directory, exist_ok=True)
    n, n_sig = adc.shape
    with open(os.path.join(directory, f"{name}.hea"), "w") as f:
        f.write(f"{name} {n_sig} {fs} {n}\n")
        for i in range(n_sig):
            f.write(f"{name}.dat 16 {gain}(0)/mV 16 0 {int(adc[0, i])} 0 0 {leads[i]}\n")
    adc.astype("<i2").tofile(os.path.join(directory, f"{name}.dat"))


def raw_ecg(rng, n=5000, fs=500):
    """(n, 12) float64 mV: beats (P, QRS, T as Gaussians) at 45-120 bpm with
    per-lead gains, baseline wander, 50 Hz hum and noise."""
    import numpy as np

    t = np.arange(n) / fs
    rr = 60.0 / rng.uniform(45, 120)
    beats = np.arange(rng.uniform(0, rr), n / fs + rr, rr)

    def wave(shift, width, amp):
        return amp * np.exp(-0.5 * ((t[None, :] - beats[:, None] - shift) / width) ** 2).sum(0)

    qrs_width = rng.uniform(0.008, 0.02)
    beat = (wave(-0.16, 0.025, 0.15) + wave(0.0, qrs_width, 1.0)
            - wave(0.025, 0.01, rng.uniform(0.1, 0.4)) + wave(0.3, 0.05, rng.uniform(0.1, 0.4)))
    lead_gain = rng.uniform(0.3, 1.5, 12) * np.where(rng.random(12) < 0.2, -1.0, 1.0)
    wander = 0.2 * np.sin(2 * np.pi * rng.uniform(0.05, 0.5) * t + rng.uniform(0, 6.3))
    sig = (lead_gain[:, None] * beat[None] + wander[None] + 0.05 * np.sin(2 * np.pi * 50 * t)
           + 0.02 * rng.normal(size=(12, n)))
    return sig.T


def raw_adc(rng, n=5000):
    import numpy as np

    return np.round(raw_ecg(rng, n) * RAW_GAIN).astype(np.int16)


def write_raw_mimic(root, n=RAW_RECORDS, bad=RAW_BAD, seed=0):
    """``root/mimic``: ``n`` records as MIMIC-IV-ECG lays them out
    (``files/p<group>/s<study>/<study>``) with their conversations JSON,
    the records of ``bad`` written faulty; returns the JSON's path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mimic = os.path.join(root, "mimic")
    instances = []
    for i in range(n):
        rel = f"files/p{1000 + i // 64}/s{40000000 + i}/{40000000 + i}"
        directory, name = os.path.split(os.path.join(mimic, rel))
        fault = bad.get(i)
        adc = raw_adc(rng)
        write_wfdb16(directory, name, adc[:100] if fault == "short" else adc,
                     fs=250 if fault == "fs250" else 500,
                     gain="1e-320" if fault == "inf" else RAW_GAIN)
        if fault == "missing":
            os.remove(os.path.join(directory, f"{name}.dat"))
        instances.append({"ecg": rel, "conversations": [
            {"from": "human", "value": f"<ecg>\nWhat is the rhythm of ECG {i}?"},
            {"from": "gpt", "value": f"Record {i}: sinus rhythm, {'normal' if i % 3 else 'borderline'} ECG."}]})
    path = os.path.join(mimic, "conversations.json")
    with open(path, "w") as f:
        json.dump(instances, f)
    return path


def ptb_codes(i):
    """Record ``i``'s scp_codes: every fifth has no diagnostic statement
    (so no superdiagnostic label), the others one or two."""
    codes = {}
    if i % 5:
        codes[PTB_DIAGNOSTIC[i % len(PTB_DIAGNOSTIC)]] = 100.0
        if i % 3 == 0:
            codes[PTB_DIAGNOSTIC[(i * 7) % len(PTB_DIAGNOSTIC)]] = 50.0
    codes[("SR", "AFIB", "STACH")[i % 3]] = 0.0
    if i % 4 == 0:
        codes[("ABQRS", "PVC", "LOWT")[i % 3]] = 0.0
    return codes


def write_raw_ptb(folder, n=PTB_RECORDS, seed=1):
    """A PTB-XL folder: ``n`` 500 Hz records under ``records500/``,
    ``ptbxl_database.csv`` (ecg_id, patient_id, report, scp_codes,
    strat_fold 1-10, filename_lr, filename_hr; one empty report, quotes
    and commas in the others) and ``scp_statements.csv`` (:data:`SCP`)."""
    import csv

    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ecg_id = i + 1
        rel = f"records500/00000/{ecg_id:05d}_hr"
        write_wfdb16(os.path.join(folder, os.path.dirname(rel)), os.path.basename(rel),
                     raw_adc(rng))
        report = "" if i == 7 else ptb_report(i)
        rows.append([ecg_id, 15000 + i, report, repr(ptb_codes(i)), i % 10 + 1,
                     f"records100/00000/{ecg_id:05d}_lr", rel])
    with open(os.path.join(folder, "ptbxl_database.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ecg_id", "patient_id", "report", "scp_codes", "strat_fold",
                    "filename_lr", "filename_hr"])
        w.writerows(rows)
    with open(os.path.join(folder, "scp_statements.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "description", "diagnostic", "form", "rhythm", "diagnostic_class",
                    "diagnostic_subclass"])
        for code, values in SCP.items():
            w.writerow([code, f"statement {code}"]
                       + ["" if v is None else (f"{v:.1f}" if isinstance(v, int) else v)
                          for v in values])


def expected_mimic(n=RAW_RECORDS, bad=RAW_BAD):
    """Each split's instance indices, by the definition of the CLI's split
    (``RandomState(42).permutation``: the test part first, ceil(0.3 n) and
    then ceil(0.6 rest) records), and each split's skip count."""
    import math

    import numpy as np

    def split(items, test_size):
        n_test = math.ceil(test_size * len(items))
        perm = np.random.RandomState(42).permutation(len(items))
        return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]

    train, rest = split(list(range(n)), 0.3)
    val, test = split(rest, 0.6)
    splits = {"train": train, "val": val, "test": test}
    return splits, {name: sum(i in bad for i in idx) for name, idx in splits.items()}


def expected_ptb(n=PTB_RECORDS):
    """Per split, the records kept (those with a superdiagnostic label), in
    file order, with their label rows; and the sorted classes."""
    labels = [sorted({SCP[c][3] for c in ptb_codes(i) if SCP[c][0] == 1}) for i in range(n)]
    splits = {"train": [], "val": [], "test": []}
    for i, row in enumerate(labels):
        fold = i % 10 + 1
        if row:
            splits["train" if fold < 8 else "val" if fold == 8 else "test"].append((i, row))
    return splits, sorted({c for row in labels for c in row})


def ptb_report(i):
    """Record ``i``'s report as the CLI saves it (an empty cell reads as
    NaN, saved as "nan")."""
    return "nan" if i == 7 else f'sinusrhythmus, "lagetyp" normal {i}, t abnormal'


def check_tree(out, splits, segments, names_of, texts_of=None):
    """``out/{ecg,text}/<split>`` hold exactly the expected files: for each
    split the names ``names_of(position, segment)`` of each kept record's
    ``segments`` segments, each array (12, L) float32 and finite, each text
    ``texts_of(split, position)`` where given.  Returns the file count."""
    import numpy as np

    total = 0
    for split, positions in splits.items():
        want = {names_of(p, j) for p in positions for j in range(segments)}
        for kind, ext in (("ecg", "npy"), ("text", "json")):
            got = set(os.listdir(os.path.join(out, kind, split)))
            names = {f"{kind}_{w}.{ext}" for w in want}
            assert got == names, (f"{out} {kind}/{split}: {len(got)} files, expected "
                                  f"{len(names)}; extra {sorted(got - names)[:3]}, "
                                  f"missing {sorted(names - got)[:3]}")
        for w in sorted(want)[:: max(1, len(want) // 16)]:
            seg = np.load(os.path.join(out, "ecg", split, f"ecg_{w}.npy"))
            assert seg.dtype == np.float32 and seg.shape[0] == 12 and np.isfinite(seg).all(), \
                f"{out} ecg/{split}/ecg_{w}.npy: {seg.dtype} {seg.shape}"
            if texts_of is not None:
                with open(os.path.join(out, "text", split, f"text_{w}.json")) as f:
                    text = json.load(f)
                p = int(w.split("_")[0])
                assert text == texts_of(split, p), f"{out} text/{split}/text_{w}.json: {text!r}"
        total += len(want)
    return total


def check_skips(log, skips):
    """The CLI's log names each split's skip count, and it is the expected
    one."""
    for split, n in skips.items():
        line = f"Total instances skipped in {split} split: {n}\n"
        assert line in log, f"skip count of {split}: expected {n}; the log says " + repr(
            [x for x in log.splitlines() if f"in {split} split" in x])


def check_rel(got, want, tol, what):
    """max |got - want| / max |want| <= ``tol``, both finite; returns it."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape}, expected {want.shape}"
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, f"{what}: |d| / max|ref| = {err:.3e} > {tol:.0e}"
    return err


def check_token_cache(cache, want, what):
    """The token cache's streams equal the host encoder's, record by record
    and token by token."""
    assert len(cache) == len(want), f"{what}: {len(cache)} streams, the host {len(want)}"
    for r, (got, w) in enumerate(zip(cache, want)):
        if got != w:
            bad = next((k for k, (a, b) in enumerate(zip(got, w)) if a != b), min(len(got), len(w)))
            raise AssertionError(f"{what}: record {r} differs from the host encoder at token "
                                 f"{bad} ({len(got)} tokens, the host {len(w)})")


def scipy_chain(x):
    """The float64 reference on (B, 12, n) float64 arrays: scipy's filtfilt
    chain (tests/test_dsp.py's oracle), the wavelet denoise in float64 (the
    conv-path transforms, numpy's median and soft threshold), scipy's cubic
    interp1d; returns (filtered, denoised, resampled)."""
    import numpy as np
    import torch
    from scipy import interpolate
    from scipy import signal as sps

    from ecg_byte_tpu_torch.ops.wavelet import daubechies, dec_lengths, wavedec, waverec

    y = x
    for f0 in (50.0, 60.0):
        b, a = sps.iirnotch(f0, 30.0, 500.0)
        y = sps.filtfilt(b, a, y, axis=-1)
    b, a = sps.butter(4, [0.5 / 250.0, 100.0 / 250.0], btype="band")
    y = sps.filtfilt(b, a, y, axis=-1)
    b, a = sps.butter(4, 0.05 / 250.0, btype="high")
    filtered = sps.filtfilt(b, a, y, axis=-1)
    n = x.shape[-1]
    db6 = daubechies(6)
    coeffs = [c.numpy() for c in wavedec(torch.from_numpy(np.ascontiguousarray(filtered)), db6, 4)]
    med = np.median(np.abs(coeffs[1]), axis=-1, keepdims=True)
    threshold = np.where(med == 0, 0.0, med / 0.6745)
    kept = [coeffs[0]]
    for d in coeffs[1:]:
        th = np.sign(d) * np.maximum(np.abs(d) - threshold, 0.0)
        kept.append(np.where(np.isfinite(th) & (np.abs(d) > 1e-10), th, 0.0))
    denoised = waverec([torch.from_numpy(c) for c in kept], db6, dec_lengths(n, db6.dec_len, 4))
    denoised = denoised.numpy()
    t = np.linspace(0, n / 500.0, n, endpoint=True)
    f = interpolate.interp1d(t, denoised, kind="cubic", axis=-1, bounds_error=False,
                             fill_value="extrapolate")
    return filtered, denoised, f(np.linspace(0, n / 500.0, n // 2, endpoint=True))


def check_median(got, values, what):
    """The threshold's median equals numpy's exactly: for an even length
    the mean of the two middle values (``torch.median`` returns the lower
    one)."""
    import numpy as np

    want = np.median(values, axis=-1, keepdims=True)
    got = np.asarray(got)
    assert got.shape == want.shape, f"{what}: shape {got.shape}, expected {want.shape}"
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (f"{what}: {bad.size} of {got.size} medians differ from numpy's, "
                           f"first {got.flat[bad[0]]!r} against {want.flat[bad[0]]!r}")


def _run_cli(module, args, cwd, env):
    """``python -m <module> <args>``; returns (host seconds, its output)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, f"{module} {args}: exit {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    return wall, r.stdout


def preprocess_phase(root, dev="cuda", records=RAW_RECORDS, ptb_records=PTB_RECORDS):
    """Phase 15: raw WFDB records through the port's preprocessing on the
    card to the token cache.  Returns the launch counts of its main path
    and its numbers.  (``dev="cpu"`` and fewer records rehearse it on the
    CPU, with ``time_in_turns`` and ``torch.cuda`` patched.)"""
    import pickle

    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import train_tokenizer
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.data.preprocess import PreprocessArgs, load_instance_signal
    from ecg_byte_tpu_torch.data.text_tokenizer import ByteTextTokenizer, register_ecg_tokens
    from ecg_byte_tpu_torch.ops import dsp, wavelet
    from ecg_byte_tpu_torch.tokenizer import load_vocab_and_merges
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    phase("15. preprocess: raw WFDB records -> cli.preprocess_ecg (mimic, ptb) -> "
          "cli.sample_ecg -> cli.train_tokenizer -> the device token cache")
    torch.cuda.empty_cache()
    dev = torch.device(dev)
    cli_device = [] if dev.type == "cuda" else ["--device", "cpu"]
    t_phase = time.perf_counter()
    raw = os.path.join(root, "raw")
    env = dict(os.environ, PYTHONPATH=REPO)
    env[dsp.CACHE_ENV] = os.path.join(root, "op_cache")
    os.environ[dsp.CACHE_ENV] = env[dsp.CACHE_ENV]  # cold: this phase builds the operators
    t0 = time.perf_counter()
    instances_json = write_raw_mimic(raw, records)
    ptb_folder = os.path.join(raw, "ptb")
    write_raw_ptb(ptb_folder, ptb_records)
    print(f"{records} MIMIC-IV-ECG-shaped records (12 x 5,000 at 500 Hz, format 16, "
          f"{records * 5000 * 12 * 2 / 1e6:.1f} MB; bad on purpose: {RAW_BAD}) and a PTB-XL "
          f"folder of {ptb_records} written in {time.perf_counter() - t0:.1f} s")

    # the operators, built cold: scipy's filtfilt and interp1d through
    # identities, the wavelet matrices in float64, their products on the card
    build = {}
    for name, fn in (("filtfilt (scipy)", lambda: dsp.filtfilt_matrix(5000, 500.0)),
                     ("interp1d (scipy)", lambda: dsp.resample_matrix(5000, 500.0, 250.0)),
                     ("wavelet (float64 conv)", lambda: wavelet._wavelet_matrices(5000, 4, 6)),
                     ("float64 products on the card",
                      lambda: dsp.preprocess_operators(5000, 500.0, 250.0, device=dev))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        build[name] = time.perf_counter() - t0
    dec_op, rec_op, seg = dsp.preprocess_operators(5000, 500.0, 250.0, device=dev)
    print(f"operators built in {sum(build.values()):.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in build.items())
          + f"): dec {tuple(dec_op.shape)}, rec {tuple(rec_op.shape)} float32, "
            f"{(dec_op.numel() + rec_op.numel()) * 4 / 1e6:.1f} MB on the card")

    # one batch of 64 valid records, as the CLI stacks them
    with open(instances_json) as f:
        instances = json.load(f)
    pargs = PreprocessArgs(data="mimic", data_root=raw, device=str(dev))
    batch = []
    for inst in instances:
        sig, _ = load_instance_signal(inst, pargs)
        if sig is not None:
            batch.append(sig)
        if len(batch) == PREPROCESS_BATCH:
            break
    x = torch.from_numpy(np.stack(batch).astype(np.float32)).to(dev).transpose(1, 2)
    x = dsp.reorder_leads(x).contiguous()  # (64, 12, 5000), as the pipeline reorders
    card = dsp.preprocess_records(x)
    cpu = dsp.preprocess_records(x.cpu())
    torch.cuda.synchronize()
    e_cpu = check_rel(card.cpu(), cpu, CARD_CPU_TOL, "preprocess_records card vs CPU")
    # the median that sets the threshold, on the card, at the even length
    # of this n's cD4 band and at one less
    cd = dsp.apply_operator(x, dec_op)[..., seg[0]: seg[0] + seg[1]].abs()
    for band in (cd, cd[..., :-1]):
        check_median(wavelet.median(band).cpu(), band.cpu().numpy(),
                     f"median of |cD4| over {band.shape[-1]} values")
    del cd
    filtered, denoised, resampled = scipy_chain(x.cpu().double().numpy())
    e_filter = check_rel(dsp.advanced_ecg_filter(x).cpu(), filtered, FILTER_TOL,
                         "advanced_ecg_filter vs scipy filtfilt")
    e_resample = check_rel(dsp.nsample_ecg(torch.from_numpy(denoised).float().to(dev), 500.0,
                                           250.0).cpu(), resampled,
                           RESAMPLE_TOL, "nsample_ecg vs scipy interp1d")
    e_chain = check_rel(card.cpu(), resampled, FILTER_TOL,
                        "preprocess_records vs scipy filtfilt + float64 denoise + interp1d")
    print(f"preprocess_records on the card, {len(batch)} records: |d| / max|ref| against "
          f"float64 scipy {e_chain:.2e} (tol {FILTER_TOL:.0e}); filter {e_filter:.2e} "
          f"(tol {FILTER_TOL:.0e}), resample {e_resample:.2e} (tol {RESAMPLE_TOL:.0e}); against "
          f"the port's CPU path {e_cpu:.2e} (tol {CARD_CPU_TOL:.0e}); the median of |cD4| "
          f"({seg[1]} and {seg[1] - 1} values) equal to numpy's")
    n, m, total = 5000, 2500, sum(seg)
    rows = len(batch) * 12
    flops = 2 * rows * (total * n + m * total)
    nbytes = 4 * (rows * n + total * n + m * total + rows * m)
    t_ops, t_bytes = flops / PEAK_FLOPS_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    ms, products_ms = time_in_turns([lambda: dsp.preprocess_records(x),
                                  lambda: dsp.apply_operator(dsp.apply_operator(x, dec_op),
                                                             rec_op)], 10)
    graph_ms = time_graphed([lambda: dsp.preprocess_records(x)], calls=5)[0]
    print(f"device {ms:.3f} ms per {len(batch)}-record batch (CUDA events over eager calls; "
          f"{graph_ms:.3f} in a CUDA graph; the two products alone {products_ms:.3f}); bound "
          f"{max(t_ops, t_bytes):.3f} ms by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'} ({flops / 1e9:.1f} GFLOP at "
          f"{PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s FP32, {nbytes / 1e6:.1f} MB)")
    del x, card, cpu

    zero_launches()
    splits, skips = expected_mimic(records)
    walls = {}
    for seg_len in PREPROCESS_SEG_LENS:
        walls[seg_len], log = _run_cli(
            "ecg_byte_tpu_torch.cli.preprocess_ecg",
            ["--data", "mimic", "--instances_json", instances_json, "--data_root", raw,
             "--seg_len", str(seg_len)] + cli_device, root, env)
        check_skips(log, skips)
        kept = {s: [p for p, i in enumerate(idx) if i not in RAW_BAD] for s, idx in splits.items()}
        files = check_tree(
            os.path.join(raw, f"mimic_{seg_len}"), kept, 2500 // seg_len,
            lambda p, j: f"{p}_{j}",
            lambda s, p: instances[splits[s][p]]["conversations"])
        print(f"cli.preprocess_ecg --data mimic --seg_len {seg_len}: {walls[seg_len]:.1f} s, "
              f"{records / walls[seg_len]:.1f} records/s (host clock, the whole CLI); splits "
              f"{ {s: len(i) for s, i in splits.items()} }, skipped {skips}, {files} segments")
    stats_path = os.path.join(raw, "mimic_dataset_stats.npy")
    stats = np.load(stats_path, allow_pickle=True).item()
    assert stats["skipped_instances"] == skips["train"], stats
    assert np.isfinite([stats[k] for k in ("global_min", "global_max", "percentile_1",
                                           "percentile_99")]).all(), stats
    assert stats["global_min"] < stats["percentile_1"] < stats["percentile_99"] < \
        stats["global_max"], stats
    # the CLI's arrays against the CPU path on a few train records
    pos = [p for p, i in enumerate(splits["train"]) if i not in RAW_BAD][:4]
    sigs = np.stack([load_instance_signal(instances[splits["train"][p]], pargs)[0] for p in pos])
    want = dsp.segment_ecg(dsp.preprocess_records(
        torch.from_numpy(sigs.astype(np.float32)).transpose(1, 2), do_reorder=True), 500)
    got = np.stack([[np.load(os.path.join(raw, "mimic_500", "ecg", "train", f"ecg_{p}_{j}.npy"))
                     for j in range(5)] for p in pos])
    e_saved = check_rel(got, want, CARD_CPU_TOL, "saved segments vs the CPU path")
    print(f"stats {stats}; saved segments of {len(pos)} records vs the CPU path {e_saved:.2e}")

    walls["ptb"], log = _run_cli(
        "ecg_byte_tpu_torch.cli.preprocess_ecg",
        ["--data", "ptb", "--ptb_folder", ptb_folder, "--data_root", raw, "--seg_len", "500"]
        + cli_device, root, env)
    ptb_splits, classes = expected_ptb(ptb_records)
    files = check_tree(os.path.join(raw, "ptb_500"),
                       {s: list(range(len(r) * 5)) for s, r in ptb_splits.items()}, 1,
                       lambda p, j: f"{p}_{p}", lambda s, p: ptb_report(ptb_splits[s][p // 5][0]))
    with open(os.path.join(raw, "ptb_500", "mlb.pkl"), "rb") as f:
        mlb = pickle.load(f)
    assert list(mlb.classes_) == classes, (list(mlb.classes_), classes)
    rows = [row for s in ptb_splits.values() for _, row in s]
    y = mlb.transform(rows)
    assert [[c for c, on in zip(classes, r) if on] for r in y.tolist()] == rows, "mlb rows"
    cached = np.load(os.path.join(ptb_folder, "raw500.npy"), allow_pickle=True)
    assert cached.shape == (ptb_records, 2500, 12) and cached.dtype == np.float32, cached.shape
    print(f"cli.preprocess_ecg --data ptb --seg_len 500: {walls['ptb']:.1f} s, "
          f"{ptb_records / walls['ptb']:.1f} records/s; splits "
          f"{ {s: len(r) for s, r in ptb_splits.items()} } records, {files} segments, classes "
          f"{classes}, raw500.npy {cached.shape}")

    train_dir = os.path.join(raw, "mimic_2500", "ecg", "train")
    walls["sample"], log = _run_cli(
        "ecg_byte_tpu_torch.cli.sample_ecg",
        ["--ecg_dir", train_dir, "--max_clusters", str(SAMPLE_CLUSTERS), "--data_root", raw]
        + cli_device, root, env)
    chosen = [line for line in log.splitlines() if "chosen" in line or "clusters" in line]
    n_files = len(os.listdir(train_dir))
    listed = os.path.join(raw, f"sampled_ecg_files_{n_files}.txt")
    with open(listed) as f:
        sampled = f.read().split("\n")
    assert sorted(sampled) == sorted(os.path.join(train_dir, x) for x in os.listdir(train_dir)), \
        "the sampled list is not every train file once"
    print(f"cli.sample_ecg --max_clusters {SAMPLE_CLUSTERS}: {walls['sample']:.1f} s for "
          f"{n_files} files ({'; '.join(chosen)})")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        tok_path = train_tokenizer.main([
            "--train", "--num_merges", str(PREPROCESS_MERGES), "--sampled_files", listed,
            "--percentiles", stats_path, "--out_dir", raw])
    walls["tokenizer"] = time.perf_counter() - t0
    vocab, merges = load_vocab_and_merges(tok_path)
    print(f"cli.train_tokenizer {PREPROCESS_MERGES} merges on the sampled list: "
          f"{walls['tokenizer']:.1f} s")

    data = os.path.join(raw, "mimic_500")
    sigs, texts = align_signal_text_files(f"{data}/ecg/train", f"{data}/text/train")
    tok = ByteTextTokenizer()
    register_ecg_tokens(tok, vocab)
    t0 = time.perf_counter()
    ds = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=tok,
                         args=DataConfig(dataset="mimic_500", percentiles=stats_path),
                         cache_tokens=True, device=dev)
    torch.cuda.synchronize()
    walls["cache"] = time.perf_counter() - t0
    counts = launches()
    batches = -(-len(sigs) // CACHE_BATCH)
    check_launch_counts(counts, {"bpe_match": batches, "bpe_chain": batches}, "token cache")
    signals = np.stack([np.load(p) for p in sigs]).astype(np.float32)
    check_token_cache(ds._token_cache,
                      host_streams(signals, stats["percentile_1"], stats["percentile_99"], merges),
                      "token cache of mimic_500 train")
    print(f"token cache of mimic_500 train on the card: {len(sigs)} records in {batches} batches "
          f"in {walls['cache']:.1f} s, equal to the host encoder's streams "
          f"({sum(map(len, ds._token_cache))} tokens); launches {counts}")
    numbers = {"operator_build_s": sum(build.values()), "device_ms_per_batch": ms,
               "graph_ms_per_batch": graph_ms,
               "bound_ms": max(t_ops, t_bytes), "err_vs_scipy": e_chain,
               "records_per_s_2500": records / walls[2500],
               "records_per_s_500": records / walls[500], "sample_s": walls["sample"],
               "tokenizer_s": walls["tokenizer"], "cache_s": walls["cache"]}
    print(f"phase 15: {json.dumps(numbers)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"preprocess": counts}, numbers


# ------------------------------------------------------- phase 16: two-stage


@dataclasses.dataclass(frozen=True)
class TwoStage:
    """The sizes of phase 16: full width on the card (the defaults), tiny for
    a rehearsal on the CPU."""

    llm: str = MODEL
    pretrain_data: str = BIG["name"]  # 256 records of 12 x 2,500
    pretrain_batch: int = 128  # bench.py's bench_pretrain: 128 x (12, 2500)
    finetune_batch: int = 4
    pad_to_max: int = 1022  # ECGCLIPFinetune packs pad_to_max + 2 = 1024 positions
    vision_batch: int = 8
    items: int = 4  # training items of the kernel-vs-plain train-step check
    new_tokens: int = 32  # tokens of the kernel-vs-plain streams check
    tiny: bool = False  # --tiny backbones (the rehearsal's)


TWO_STAGE = TwoStage()
# cli.finetune's max_new_tokens: its serving cache holds the spliced prompt
# and this many tokens
SERVE_NEW_TOKENS = 128


def _two_stage_items(root, tok, args, idx, split="train"):
    """Items ``idx`` of ``ECGCLIPFinetune`` on ``ptb_500``, collated."""
    from ecg_byte_tpu_torch.data import collate
    from ecg_byte_tpu_torch.data.two_stage import ECGCLIPFinetune
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/{split}",
                                          f"{data}/ptb_500/text/{split}")
    ds = ECGCLIPFinetune(sigs, texts, tokenizer=tok, args=args)
    return collate([ds[i] for i in idx], pad_id=tok.convert_tokens_to_ids(tok.pad_token))


def _fusion_model(ts, dev):
    """The frozen part of the stage-2 model as ``cli.finetune`` builds it,
    weights fresh: (LLM params, config, tokenizer, <signal> id, ResNet
    encoders)."""
    import torch

    from ecg_byte_tpu_torch.cli import common, pretrain
    from ecg_byte_tpu_torch.models import resnet1d
    from ecg_byte_tpu_torch.models import transformer as T

    params, config, tok = common.build_model(ts.llm, {}, dev)
    tok.add_tokens(["<signal>"], special_tokens=True)
    params, config = T.resize_embeddings(params, config, len(tok))
    gen = torch.Generator(device=dev).manual_seed(1)
    resnet = resnet1d.init_resnet(gen, pretrain.backbone_configs(ts.tiny, 224)[2])
    return params, config, tok, tok.convert_tokens_to_ids("<signal>"), {"resnet": resnet}


def _fusion_trainable(config, encoders, seed, dev):
    """A fresh fusion projection and LoRA adapters with B != 0 (so dA != 0),
    drawn from ``seed``."""
    import torch

    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models import lora as lora_lib

    gen = torch.Generator(device=dev).manual_seed(seed)
    fusion = F.init_fusion(gen, "resnet_model", config.hidden_size,
                           resnet_channels=encoders["resnet"][2]["out_channels"])
    lora = lora_lib.init_lora(config, gen, dev)
    for layer in lora["layers"]:
        for ab in layer.values():
            ab["b"] = (1e-2 * torch.randn(ab["b"].shape, generator=gen, device=dev)).to(
                ab["b"].dtype)
    return fusion, lora


def _finetune_args(ts, **kw):
    from ecg_byte_tpu_torch.data.two_stage import TwoStageConfig

    return TwoStageConfig(dataset="ptb_500", model="resnet_model", pad_to_max=ts.pad_to_max,
                          **kw)


def fusion_train_check(root, ts, dev):
    """The fusion train step at B1 x (pad_to_max + 2), kernels vs plain, held
    as phase 7 holds the main path's (:func:`hold_train_paths`): each of
    ``ts.items`` items with its own LoRA and projection draw; the cross
    entropy at the labelled and the valid positions, every LoRA and fusion
    gradient group, and each item's loss bounded by plain's per-token
    error.  A valid position here is one whose own row is valid too: an
    item is ~70 tokens after ~950 left pads, so the last pad's row, which
    attends no key and whose output no check holds, would weigh in the
    norm as one of ~70.  (Its next token is the first valid one, so a
    position with a valid next token only would count it.)  Only the two
    resident attention and both RMSNorm kernels launch."""
    import torch

    from ecg_byte_tpu_torch.cli.pretrain import to_device
    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models import transformer as T

    params, config, tok, sig_id, encoders = _fusion_model(ts, dev)
    s = ts.pad_to_max + 2
    batch = to_device(_two_stage_items(root, tok, _finetune_args(ts), range(ts.items)), dev)
    assert batch["tokenized_signal"].shape == (ts.items, s), batch["tokenized_signal"].shape
    items = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(ts.items)]
    trees = [_fusion_trainable(config, encoders, 2 + i, dev) for i in range(ts.items)]

    def run(params, config, fusion, lora, item):
        fusion, lora = (_map_tree(lambda t: t.detach().clone().requires_grad_(True), x)
                        for x in (fusion, lora))
        sig = F.encoder_embedding("resnet_model", fusion, item, **encoders)
        ids = item["tokenized_signal"]
        adapted = F.adapt_sequence(sig, params["embed"][ids], ids, item["attn_mask"],
                                   item["quantized_signal_ids_input"], item["position_ids"],
                                   sig_id=sig_id)
        hidden = T.forward(params, config, None, adapted["attn_mask"], adapted["position_ids"],
                           inputs_embeds=adapted["combined_embeds"], lora=lora,
                           return_hidden=True)
        loss = T.lm_loss_from_hidden(params, config, hidden, adapted["labels"])
        loss.backward()
        with torch.no_grad():
            logits = T._unembed(params, config, hidden)[0, :-1]
            lse = torch.logsumexp(logits, -1)
            labels, nxt = adapted["labels"][0, 1:], ids[0, 1:]
            valid = valid_predictions(adapted["attn_mask"][0])
            ce_lab = lse - logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
            ce_all = lse - logits.gather(1, nxt[:, None])[:, 0]
        grads = {f"LoRA {n}.{k}": torch.cat([layer[n][k].grad.float().flatten()
                                             for layer in lora["layers"]])
                 for n in lora["layers"][0] for k in ("a", "b")}
        grads.update({f"fusion {k}": fusion["image_projection"][k].grad.flatten()
                      for k in ("weight", "bias")})
        return loss.item(), ce_lab[labels != -100], ce_all[valid], grads

    before = launches()
    kern = [run(params, config, *tree, item) for tree, item in zip(trees, items)]
    mid = launches()
    with plain_path():
        plain = [run(params, config, *tree, item) for tree, item in zip(trees, items)]
        f32 = lambda t: t.float() if t.dtype == torch.bfloat16 else t  # noqa: E731
        params32, config32 = _map_tree(f32, params), config.replace(dtype="float32")
        ref = [run(params32, config32, fusion, _map_tree(f32, lora), item)
               for (fusion, lora), item in zip(trees, items)]
        del params32
    after = launches()
    kernels = ("prefill_attention", "prefill_attention_bwd", "rmsnorm", "rmsnorm_bwd")
    if dev.type == "cuda":  # the plain versions count nothing
        assert all(mid[k] > before[k] for k in kernels), (before, mid)
    assert all(mid[k] == before[k] for k in SOURCES if k not in kernels), (before, mid)
    assert after == mid, "the plain runs launched a kernel"
    print(f"fusion train step: {ts.items} items at B1 x {s}, each with its own LoRA B and "
          "projection; errors against f32:")
    hold_train_paths(kern, plain, ref)


def _fusion_logits(params, config, lora, fusion, encoders, batch, sig_id, forced,
                   cache_dtype=None):
    """Teacher-forced logits of the stage-2 serving path as
    ``fusion_generate`` runs it: the prefill on the spliced prompt, then a
    decode step per token of ``forced`` (B, n) but the last, into a cache
    of ``cache_dtype`` sized as ``cli.finetune``'s; (n, B, V), step t's
    row predicts token t."""
    import torch

    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models import transformer as T

    ids = batch["tokenized_signal2"]
    sig = F.encoder_embedding("resnet_model", fusion, batch, **encoders)
    adapted = F.adapt_sequence(sig, params["embed"][ids], ids, batch["attn_mask2"].to(torch.int32),
                               sig_id=sig_id)
    mask = adapted["attn_mask"]
    (b, s), n = mask.shape, forced.shape[1]
    cache = T.init_kv_cache(config, b, s + SERVE_NEW_TOKENS, mask.device, dtype=cache_dtype)
    logits, cache, pos = T.prefill(params, config, None, mask, cache, lora=lora,
                                   inputs_embeds=adapted["combined_embeds"])
    out = [logits]
    cache_mask = torch.cat(
        [mask, torch.zeros(b, SERVE_NEW_TOKENS, dtype=torch.int32, device=mask.device)], 1)
    pos = pos.to(torch.int32)
    for t in range(n - 1):
        cache_mask[:, s + t] = 1
        logits, cache = T.decode_step(params, config, forced[:, t], pos, s + t, cache, cache_mask,
                                      lora=lora)
        out.append(logits)
        pos = pos + 1
    return torch.stack(out)


def fusion_serve_check(root, ts, dev):
    """Phase 9's check on the stage-2 serving path, once with the bf16
    cache and LoRA attached and once as ``--int8_decode`` serves (LoRA
    merged, the LLM quantized, the int8 cache): two test prompts, each at
    B1 padded as the CLI pads it (``pad_prompt``), in a cache sized as the
    CLI's; ``fusion_generate``'s greedy stream of ``ts.new_tokens`` tokens
    with the kernels and with the plain versions (where they part is
    printed, not held), then the plain stream teacher-forced with the
    kernels, with the plain versions and in f32 activations (the same
    int8 weights and cache for the int8 tree), held by
    :func:`hold_logits`; each kernel run launches its path's kernels and
    no other, the plain runs none."""
    import torch

    from ecg_byte_tpu_torch.cli.finetune import pad_prompt
    from ecg_byte_tpu_torch.cli.pretrain import to_device
    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models import lora as lora_lib
    from ecg_byte_tpu_torch.models.quantized import quantize_lm_int8

    params, config, tok, sig_id, encoders = _fusion_model(ts, dev)
    fusion, lora = _fusion_trainable(config, encoders, 1, dev)
    pad_id = tok.convert_tokens_to_ids(tok.pad_token)
    args = _finetune_args(ts, inference=True)
    batches = [to_device(pad_prompt(_two_stage_items(root, tok, args, [i], "test"), pad_id), dev)
               for i in range(2)]
    f32 = lambda t: t.float() if t.dtype == torch.bfloat16 else t  # noqa: E731
    for key in ("bf16", "int8"):
        int8 = key == "int8"
        if int8:
            params, lora = quantize_lm_int8(lora_lib.merge_lora(params, lora, config), config), None
            kernels = ("prefill_attention", "int8_linear_tc", "kv_quant", "decode_attention_int8",
                       "int8_linear", "rmsnorm")
        else:
            kernels = ("prefill_attention", "decode_attention", "rmsnorm")
        params32 = _map_tree(f32, params)
        lora32 = None if lora is None else _map_tree(f32, lora)
        config32 = config.replace(dtype="float32")
        gen_kw = dict(lora=lora, encoders=encoders, max_new_tokens=ts.new_tokens, eos_token_id=-1,
                      pad_token_id=pad_id, int8_kv=int8)
        kern, plain, ref, parted = [], [], [], {}
        for i, batch in enumerate(batches):
            run = functools.partial(_fusion_logits, fusion=fusion, encoders=encoders, batch=batch,
                                    sig_id=sig_id, cache_dtype=torch.int8 if int8 else None)
            with torch.inference_mode():
                stream = F.fusion_generate(params, config, fusion, "resnet_model", batch, sig_id,
                                           **gen_kw)
                with plain_path():
                    want = F.fusion_generate(params, config, fusion, "resnet_model", batch,
                                             sig_id, **gen_kw)
                diff = (stream[0] != want[0]).nonzero()
                if len(diff):
                    parted[i] = int(diff[0])
                before = launches()
                kern.append(run(params, config, lora, forced=want))
                mid = launches()
                with plain_path():
                    plain.append(run(params, config, lora, forced=want))
                    ref.append(run(params32, config32, lora32, forced=want))
                after = launches()
            if dev.type == "cuda":  # the plain versions count nothing
                assert all(mid[k] > before[k] for k in kernels), (key, before, mid)
            assert all(mid[k] == before[k] for k in SOURCES if k not in kernels), (key, before, mid)
            assert after == mid, f"{key}: the plain runs launched a kernel"
        del params32, lora32
        print(f"stage-2 serving {key}, {len(batches)} prompts at B1 (spliced "
              f"{batches[0]['tokenized_signal2'].shape[1] + 1} positions, cache "
              f"+{SERVE_NEW_TOKENS}), {ts.new_tokens} tokens: fusion_generate's streams with the "
              f"kernels and the plain versions {f'part at steps {parted}' if parted else 'equal'} "
              "(not held); the plain stream teacher-forced:")
        hold_logits(torch.cat(kern, 1), torch.cat(plain, 1), torch.cat(ref, 1))


def two_stage_phase(root, ts=TWO_STAGE, dev="cuda"):
    """Phase 16: the two-stage baselines through the port's CLIs.  Stage 1,
    ``cli.pretrain --model resnet`` (ResNet-101, MERL head, hash text
    encoder) at batch 128 x (12, 2,500); stage 2, ``cli.finetune --model
    resnet_model --llm llama-3.2-1b`` on its checkpoint at B4 x 1024, then
    its ``--inference --toy`` with the bf16 and with the int8 cache (exact
    launch counts of every kernel); the fusion train step and streams held
    to the plain path; each step timed alone; CLIP and ViT (``clip_vit``)
    pretrained and one ``clip_vit_model`` finetune at the published widths.
    Returns the launch counts of the two LLM paths and the numbers.
    (``dev="cpu"`` with ``TwoStage(tiny=True, ...)`` rehearses it on the
    CPU, with ``check_launch_counts``, ``time_in_turns`` and
    ``torch.cuda`` patched.)"""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import common, finetune, pretrain
    from ecg_byte_tpu_torch.cli.pretrain import to_device
    from ecg_byte_tpu_torch.data import ByteTextTokenizer, collate
    from ecg_byte_tpu_torch.data.two_stage import ECGCLIPPretrain, TwoStageConfig
    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models.lora import leaves
    from ecg_byte_tpu_torch.train.scheduler import clip_by_global_norm_, make_optimizer
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    phase(f"16. two-stage: cli.pretrain --model resnet (B{ts.pretrain_batch} x (12, L)), "
          f"cli.finetune --model resnet_model --llm {ts.llm} (B{ts.finetune_batch} x "
          f"{ts.pad_to_max + 2}), its serving (bf16, int8); cli.pretrain --model clip_vit and "
          "cli.finetune --model clip_vit_model")
    torch.cuda.empty_cache()
    dev = torch.device(dev)
    t_phase = time.perf_counter()
    extra = ([] if dev.type == "cuda" else ["--device", "cpu"]) + (
        ["--tiny", "--image_size", "32"] if ts.tiny else [])
    L = common._PRESETS[ts.llm]().num_layers
    data = os.path.join(root, "data")

    def records(name, split):
        return len(align_signal_text_files(f"{data}/{name}/ecg/{split}",
                                           f"{data}/{name}/text/{split}")[0])

    def steps_of(n, batch):  # --dev: 2 epochs of at most 10 batches
        return 2 * min(10, -(-n // batch))

    def run_cli(cli, args):
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.chdir(root):
            out = cli.main(args + extra)
        torch.cuda.synchronize()
        return out, launches(), time.perf_counter() - t0

    def train_counts(steps, evals):
        # per train step each layer's attention forward and backward, 2L + 1
        # norms forward and backward (layer 0's input, the spliced embeds,
        # takes a gradient here); per eval step the forwards
        return {"prefill_attention": L * (steps + evals), "prefill_attention_bwd": L * steps,
                "rmsnorm": (2 * L + 1) * (steps + evals), "rmsnorm_bwd": (2 * L + 1) * steps}

    numbers = {}
    # stage 1: the conv is cuDNN's (XLA's in the JAX package): no kernel of the port
    pre_args = ["--model", "resnet", "--dataset", ts.pretrain_data, "--batch_size",
                str(ts.pretrain_batch), "--dev"]
    pre, counts, wall = run_cli(pretrain, pre_args)
    check_launch_counts(counts, {}, "stage-1 pretraining")
    n_pre = records(ts.pretrain_data, "train")
    assert pre["steps"] == steps_of(n_pre, ts.pretrain_batch), pre
    assert all(np.isfinite(pre["train_loss"])), pre
    print(f"stage 1: {pre['steps']} steps on {n_pre} records of {ts.pretrain_data}; train loss "
          f"per epoch {pre['train_loss']}; {pre['seconds'] / pre['steps'] * 1e3:.1f} ms a step "
          f"with its data (host clock); phase wall {wall:.1f} s")
    # the pretrain step alone at its batch: CUDA events, after a warm-up
    args = pretrain.get_args(pre_args + extra)
    gen = torch.Generator(device=dev).manual_seed(0)
    sigs, texts = align_signal_text_files(f"{data}/{ts.pretrain_data}/ecg/train",
                                          f"{data}/{ts.pretrain_data}/text/train")
    length = np.load(sigs[0]).shape[-1]
    trainable, bn, loss_fn, hidden = pretrain.build_backbone(args, gen, length)
    ds = ECGCLIPPretrain(sigs[:ts.pretrain_batch], texts[:ts.pretrain_batch],
                         tokenizer=ByteTextTokenizer(),
                         args=TwoStageConfig(model="resnet", dataset=ts.pretrain_data))
    batch = collate([ds[i] for i in range(len(ds))])
    batch["text_emb"] = loss_fn.text_encoder(batch.pop("resnet_input_ids"),
                                             batch.pop("resnet_att_mask")).float()
    batch = to_device(batch, dev)
    for t in leaves(trainable):
        t.requires_grad_(True)
    opt, sched = make_optimizer(hidden, 500).build(leaves(trainable))
    state = {"bn": bn}

    def pretrain_step():
        opt.zero_grad(set_to_none=True)
        loss, state["bn"] = loss_fn(trainable, state["bn"], batch, gen)
        loss.backward()
        clip_by_global_norm_([t.grad for t in leaves(trainable)], 1.0)
        opt.step()
        sched.step()

    torch.cuda.reset_peak_memory_stats()
    numbers["pretrain_ms"] = time_in_turns([pretrain_step], 3)[0]
    numbers["pretrain_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    b, _, siglen = batch["norm_signal"].shape
    print(f"pretrain step B{b} x (12, {siglen}), {loss_fn.text_encoder.__class__.__name__}: "
          f"{numbers['pretrain_ms']:.2f} ms = {b / numbers['pretrain_ms'] * 1e3:.0f} samples/s "
          f"(CUDA events); peak device memory {numbers['pretrain_peak_gib']:.2f} GiB")
    del trainable, bn, opt, batch, state, loss_fn
    torch.cuda.empty_cache()

    # stage 2: the fusion LLM trains on the frozen ResNet-101 of stage 1
    ft_args = ["--model", "resnet_model", "--llm", ts.llm, "--dataset", "ptb_500",
               "--batch_size", str(ts.finetune_batch), "--pad_to_max", str(ts.pad_to_max),
               "--dev", "--first_check", os.path.basename(pre["directory"])]
    result, counts, wall = run_cli(finetune, ft_args)
    ft = result["training"]
    n_train, n_val = records("ptb_500", "train"), records("ptb_500", "val")
    evals = steps_of(n_val, ts.finetune_batch)
    assert ft["steps"] == steps_of(n_train, ts.finetune_batch), ft
    check_launch_counts(counts, train_counts(ft["steps"], evals), "stage-2 training")
    assert all(np.isfinite(ft["train_loss"] + ft["val_loss"])), ft
    by_path = {"two_stage_train": counts}
    print(f"stage 2: {ft['steps']} train steps, {evals} eval steps; launches {counts}; train "
          f"loss {ft['train_loss']}, val loss {ft['val_loss']}; phase wall {wall:.1f} s")

    # the fusion train step alone at B x (pad_to_max + 2), as the CLI takes it
    params, config, tok, sig_id, encoders = _fusion_model(ts, dev)
    fusion, lora = _fusion_trainable(config, encoders, 0, dev)
    for t in leaves([params, encoders]):
        t.requires_grad_(False)
    trainable = {"lora": lora, "fusion": fusion}
    for t in leaves(trainable):
        t.requires_grad_(True)
    opt, sched = make_optimizer(config.hidden_size, 500).build(leaves(trainable))
    batch = to_device(_two_stage_items(root, tok, _finetune_args(ts), range(ts.finetune_batch)), dev)
    dropout = torch.Generator().manual_seed(0)

    def finetune_step():
        opt.zero_grad(set_to_none=True)
        loss = F.fusion_lm_loss(params, config, fusion, "resnet_model", batch, sig_id,
                                encoders=encoders, lora=lora, dropout_generator=dropout)
        loss.backward()
        clip_by_global_norm_([t.grad for t in leaves(trainable)], 1.0)
        opt.step()
        sched.step()

    torch.cuda.reset_peak_memory_stats()
    numbers["finetune_ms"] = time_in_turns([finetune_step], 5)[0]
    numbers["finetune_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    b, s = batch["tokenized_signal"].shape
    numbers["finetune_tokens_per_s"] = b * s / numbers["finetune_ms"] * 1e3
    print(f"fusion train step B{b} x {s} (frozen ResNet forward, {ts.llm} with LoRA): "
          f"{numbers['finetune_ms']:.2f} ms = {numbers['finetune_tokens_per_s']:.0f} tokens/s "
          f"(CUDA events); peak device memory {numbers['finetune_peak_gib']:.2f} GiB")
    del params, encoders, fusion, lora, trainable, opt, batch
    torch.cuda.empty_cache()

    # serving the stage-2 checkpoint, bf16 cache then int8 weights and cache
    serve = dict.fromkeys(SOURCES, 0)
    n_test = max(1, int(records("ptb_500", "test") * 0.25))  # --toy
    for int8 in (False, True):
        result, counts, wall = run_cli(finetune, ft_args + [
            "--inference", "--toy", "--checkpoint", os.path.basename(ft["directory"])]
            + (["--int8_decode"] if int8 else []))
        recs = result["records"]
        prefills, dsteps = len(recs), sum(r["decode_steps"] for r in recs)
        assert prefills == 5 * n_test, prefills
        per_forward = prefills + dsteps
        if int8:
            # per prefill the 7 projections of every layer on the tensor
            # cores and one KV append a layer; per step the projections on
            # the GEMV kernel; per forward the head on the GEMV kernel
            want = {"prefill_attention": L * prefills, "int8_linear_tc": 7 * L * prefills,
                    "kv_quant": L * prefills, "decode_attention_int8": L * dsteps,
                    "int8_linear": 7 * L * dsteps + per_forward,
                    "rmsnorm": (2 * L + 1) * per_forward}
        else:
            want = {"prefill_attention": L * prefills, "decode_attention": L * dsteps,
                    "rmsnorm": (2 * L + 1) * per_forward}
        check_launch_counts(counts, want, f"stage-2 serving {'int8' if int8 else 'bf16'}")
        for r in recs:
            toks = r["tokens"]
            assert toks.shape == (1, 128) and toks.min() >= 0, toks.shape
            # the prompt padded to 64k positions, as the JAX CLI pads it; spliced, 64k + 1
            assert r["prompt_len"] % 64 == 1, r["prompt_len"]
        key = "int8" if int8 else "bf16"
        numbers[f"serve_{key}_ms_per_token"] = 1e3 * sum(r["decode_s"] for r in recs) / dsteps
        numbers[f"serve_{key}_prefill_ms"] = 1e3 * sum(r["prefill_s"] for r in recs) / prefills
        print(f"serving {key}: {prefills} prefills (spliced prompts of "
              f"{sorted({r['prompt_len'] for r in recs})} positions), {dsteps} decode steps; "
              f"launches {counts}; prefill {numbers[f'serve_{key}_prefill_ms']:.2f} ms, decode "
              f"{numbers[f'serve_{key}_ms_per_token']:.3f} ms/token (host clock around "
              f"synchronize); phase wall {wall:.1f} s")
        for name, n in counts.items():
            serve[name] += n
    by_path["two_stage_serve"] = serve

    fusion_train_check(root, ts, dev)
    fusion_serve_check(root, ts, dev)

    # CLIP and ViT at the published widths: stage 1 (no kernel of the
    # port: f32 towers, the text tower's attention the plain version as
    # the JAX package's use_flash=False), then a fusion finetune on them
    cv_args = ["--model", "clip_vit", "--dataset", "ptb_500", "--batch_size",
               str(ts.vision_batch), "--dev"]
    cv, counts, wall = run_cli(pretrain, cv_args)
    check_launch_counts(counts, {}, "CLIP + ViT pretraining")
    assert all(np.isfinite(cv["train_loss"])), cv
    numbers["clip_vit_pretrain_ms_per_step"] = cv["seconds"] / cv["steps"] * 1e3
    print(f"clip_vit pretraining: {cv['steps']} steps at batch {ts.vision_batch}, train loss "
          f"{cv['train_loss']}; {numbers['clip_vit_pretrain_ms_per_step']:.1f} ms a step with "
          f"its data (host clock); phase wall {wall:.1f} s")
    cvf_args = ["--model", "clip_vit_model", "--llm", ts.llm, "--dataset", "ptb_500", "--toy",
                "--batch_size", "6", "--pad_to_max", str(ts.pad_to_max), "--dev",
                "--first_check", os.path.basename(cv["directory"])]
    result, counts, wall = run_cli(finetune, cvf_args)
    cvf = result["training"]
    check_launch_counts(counts, train_counts(cvf["steps"], 2), "clip_vit_model training")
    assert cvf["steps"] == 2 and all(np.isfinite(cvf["train_loss"] + cvf["val_loss"])), cvf
    for name, n in counts.items():
        by_path["two_stage_train"][name] += n
    print(f"clip_vit_model finetuning: {cvf['steps']} train steps, 2 eval steps; train loss "
          f"{cvf['train_loss']}; phase wall {wall:.1f} s")
    print(f"phase 16: {json.dumps(numbers)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return by_path, numbers


# ---------------------------------------------------------- phase 17: --dis


@dataclasses.dataclass(frozen=True)
class Ddp:
    """The sizes of phase 17: full width on the card (the defaults), tiny for
    a rehearsal on the CPU."""

    llm: str = MODEL
    batch: int = 4  # the global batch: 2 a rank, the reference's batch per GPU
    pad_to_max: int = 1020  # S 1024, as phase 6
    pretrain_data: str = BIG["name"]
    pretrain_batch: int = 128  # phase 16's: 64 a rank
    finetune_pad_to_max: int = 1022
    tiny: bool = False


DDP = Ddp()
DDP_WORLD = 2
# the two-rank pretrain step against the one-process one: f32 convolutions
# with TF32 off on both sides, so the forward (the loss, the BatchNorm
# state's update) differs by f32 reduction order alone; the gradients are
# held against an f64 step (check_dis_step): each group within
# DDP_GRAD_RATIO times the one-process step's distance from it, plus
# DDP_F32_TOL.  The two f32 distances are two draws of the same amplified
# rounding (ratios 0.84-1.20 over six groups on an NVIDIA H100 80GB HBM3,
# PERF.md section 6); a gradient averaged over the ranks (1/W) is ~20x off
DDP_F32_TOL = 1e-4
DDP_GRAD_RATIO = 1.5


def rank_steps(n, batch, world, rank, epochs=2):
    """Steps of a --dev run in which ``rank`` holds rows of the global batch:
    ``n`` records, global batch ``batch``, at most 10 steps an epoch."""
    steps = [len(range(rank, min(batch, n - k * batch), world)) > 0
             for k in range(-(-n // batch))]
    return epochs * sum(steps[:10])


def dis_train_counts(layers, steps, evals, embeds_grad=False, replay=False):
    """One rank's launches: per train step each layer's attention forward and
    backward, 2L + 1 norms forward and 2L backward (2L + 1 where layer 0's
    input takes a gradient, the spliced embeddings); per eval step the
    forwards.  ``replay``: each layer's forward runs again in its backward
    (``--fsdp``: the layer under ``torch.utils.checkpoint``), its attention
    and its two norms."""
    again = int(replay) * steps
    return {"prefill_attention": layers * (steps + evals + again),
            "prefill_attention_bwd": layers * steps,
            "rmsnorm": (2 * layers + 1) * (steps + evals) + 2 * layers * again,
            "rmsnorm_bwd": (2 * layers + int(embeds_grad)) * steps}


def check_dis_ranks(out, expected, what):
    """Every rank of a --dis run: its exact launch counts, the same losses
    and steps as rank 0, and the checkpoints written by rank 0 alone, the
    crash save last.  ``expected``: each rank's launch counts."""
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == list(range(len(expected))), what
    summary = [r.get("training", r) for r in ranks]
    for r, want in zip(ranks, expected):
        check_launch_counts(r["launches"], want, f"{what}, rank {r['rank']}")
    for key in ("steps", "train_loss", "val_loss"):
        assert all(s.get(key) == summary[0].get(key) for s in summary), f"{what}: {key} differ"
    import numpy as np

    assert all(np.isfinite(summary[0]["train_loss"] + summary[0].get("val_loss", []))), what
    written = ranks[0]["written"]
    assert written and all(not r["written"] for r in ranks[1:]), f"{what}: written {written}"
    assert all(role.startswith("best_model") for role in written[:-1]), written


def _ddp_lm_model(root, vocab, merges, ddp, dev):
    """The main path's random model (seed 0), LoRA adapters with B != 0, and
    the step check's global batch (``ddp.batch`` training items)."""
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.train.step import _batch_tensors

    params, config, tok = build_model(ddp.llm, vocab, dev)
    lora = random_lora(config, 2, dev)
    batch = _batch_tensors(_training_items(root, vocab, merges, tok, ddp.batch, ddp.pad_to_max),
                           dev)
    return params, config, lora, batch


def ddp_lm_run(params, config, lora, batch, rows=None):
    """The port's train step (``train.step.compute_gradients``) on the global
    ``batch``, LoRA dropout on, its masks drawn for the global batch: (loss,
    the cross entropies at the labelled and at the valid positions of each
    row held, {LoRA group: gradient}).  With ``rows`` this rank's rows and
    the gradients summed over the ranks."""
    import torch

    from ecg_byte_tpu_torch.parallel.batches import shard_rows
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import compute_gradients, create_train_state

    dev = batch["input_ids"].device
    lora = _map_tree(lambda t: t.detach().clone(), lora)
    state = create_train_state(config, make_optimizer(config.hidden_size, 500),
                               torch.Generator(device=dev), peft=True, params=params, lora=lora)
    local = batch if rows is None else shard_rows(batch, rows)
    loss = compute_gradients(config, state, local, torch.Generator().manual_seed(0), rows=rows,
                             n_valid=int((batch["labels"][:, 1:] != -100).sum()))
    names = [(n, k) for n in lora["layers"][0] for k in ("a", "b")]
    grads = {f"LoRA {n}.{k}": torch.cat([layer[n][k].grad.float().flatten()
                                         for layer in lora["layers"]]).cpu() for n, k in names}
    ce_lab, ce_all = [], []
    with torch.no_grad():
        hidden = T.forward(params, config, local["input_ids"], local["attn_mask"],
                           local["position_ids"], lora=lora, return_hidden=True)
        for i in range(hidden.shape[0]):
            logits = T._unembed(params, config, hidden[i:i + 1])[0, :-1]
            lse = torch.logsumexp(logits, -1)
            labels, nxt = local["labels"][i, 1:], local["input_ids"][i, 1:]
            lab = lse - logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
            every = lse - logits.gather(1, nxt[:, None])[:, 0]
            ce_lab.append(lab[labels != -100].cpu())
            ce_all.append(every[valid_predictions(local["attn_mask"][i])].cpu())
            del logits
    return loss.item(), ce_lab, ce_all, grads


def _ddp_merl_model(root, ddp, dev):
    """``cli.pretrain --model resnet``'s backbone, head and loss (seed 0)
    and the step check's global batch: the first ``ddp.pretrain_batch``
    records of ``ddp.pretrain_data`` with their hash text embeddings."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import pretrain
    from ecg_byte_tpu_torch.data import ByteTextTokenizer, collate
    from ecg_byte_tpu_torch.data.two_stage import ECGCLIPPretrain, TwoStageConfig
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    args = pretrain.get_args(["--model", "resnet", "--dataset", ddp.pretrain_data]
                             + (["--tiny", "--image_size", "32"] if ddp.tiny else []))
    sigs, texts = align_signal_text_files(f"{data}/{ddp.pretrain_data}/ecg/train",
                                          f"{data}/{ddp.pretrain_data}/text/train")
    trainable, bn, loss_fn, _ = pretrain.build_backbone(
        args, torch.Generator(device=dev).manual_seed(0), np.load(sigs[0]).shape[-1])
    n = ddp.pretrain_batch
    ds = ECGCLIPPretrain(sigs[:n], texts[:n], tokenizer=ByteTextTokenizer(),
                         args=TwoStageConfig(model="resnet", dataset=ddp.pretrain_data))
    batch = collate([ds[i] for i in range(n)])
    batch["text_emb"] = loss_fn.text_encoder(batch.pop("resnet_input_ids"),
                                             batch.pop("resnet_att_mask")).float()
    return trainable, bn, loss_fn, pretrain.to_device(batch, dev)


def ddp_merl_run(trainable, bn, loss_fn, batch, rows=None):
    """The pretrain step's forward and backward (``cli.pretrain``'s loss:
    ResNet, MERL head, view dropout on) on the global ``batch``: (loss,
    {group: gradient}, the BatchNorm state's update).  With ``rows`` this
    rank's rows, BatchNorm and the contrastive losses over the global batch
    and the gradients summed over the ranks."""
    import torch

    from ecg_byte_tpu_torch.models.lora import leaves
    from ecg_byte_tpu_torch.parallel.batches import shard_rows
    from ecg_byte_tpu_torch.train.step import gradients

    dev = batch["norm_signal"].device
    trainable = _map_tree(lambda t: t.detach().clone().requires_grad_(True), trainable)
    local = batch if rows is None else shard_rows(batch, rows)
    out = {}

    def step_loss():
        loss, out["bn"] = loss_fn(trainable, bn, local, torch.Generator(device=dev).manual_seed(1),
                                  rows)
        return loss

    loss = gradients(leaves(trainable), step_loss)
    groups = {"head": leaves(trainable["head"])}
    for name, p in trainable["resnet"].items():
        groups.setdefault(f"resnet {name[:2]}", []).extend(leaves(p))
    grads = {k: torch.cat([t.grad.flatten() for t in v]).cpu() for k, v in groups.items()}
    update = torch.cat([(a - b).flatten() for a, b in zip(leaves(out["bn"]), leaves(bn))]).cpu()
    return loss.item(), grads, update


def _f64(model):
    """:func:`_ddp_merl_model`'s tuple in float64."""
    import torch

    trainable, bn, loss_fn, batch = model
    f64 = lambda t: t.double()  # noqa: E731
    return (_map_tree(f64, trainable), _map_tree(f64, bn), loss_fn,
            {k: v.double() if v.is_floating_point() else v for k, v in batch.items()})


def check_dis_step(got, want, ref, tol=DDP_F32_TOL):
    """A two-rank pretrain step (:func:`ddp_merl_run`) against the
    one-process step on the same global batch, in f32 (``want``) and in f64
    (``ref``).  The forward's results, the loss and the BatchNorm update
    (max |d| / max |one|), within ``tol`` of the one-process step's: f32
    reduction order alone.  Each gradient group no further from f64 (|d| /
    |f64|) than ``DDP_GRAD_RATIO`` times the one-process step's own
    distance, plus ``tol``: the backward through ResNet-101's BatchNorm
    layers turns f32 rounding into gradients percents apart (PERF.md,
    section 6).  Returns the errors."""
    import torch

    def rel(a, b):
        return (torch.linalg.vector_norm(a.double() - b.double())
                / torch.linalg.vector_norm(b.double())).item()

    (loss, grads, update), (w_loss, w_grads, w_update) = got, want
    errs = {"loss": abs(loss - w_loss) / abs(w_loss),
            "BatchNorm update": ((update - w_update).abs().max()
                                 / w_update.abs().max()).item()}
    bad = {k: e for k, e in errs.items() if not e <= tol}
    for k, r in ref[1].items():
        got_err, own = rel(grads[k], r), rel(w_grads[k], r)
        errs[f"gradient {k} vs f64 (one process)"] = (got_err, own)
        if not got_err <= DDP_GRAD_RATIO * own + tol:
            bad[f"gradient {k}"] = (got_err, own)
    assert not bad, f"two ranks against one process, beyond the bounds: {bad}"
    return errs


def _timed(step, reduce, n):
    """(ms per call of ``step``, ms per call of ``reduce``) with CUDA events:
    ``n`` calls of each after one warm-up call of ``step``."""
    import torch

    step()
    out = []
    for fn in (step, reduce):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return tuple(out)


def ddp_rank(root, vocab, merges, ddp, check, dev="cuda"):
    """One rank of phase 17's harness: with ``check``, the main path's and
    the pretrain step's forward and backward on one global batch, each
    rank holding its rows; then, on the card, the ms of a whole train step
    and of its gradient all-reduce (CUDA events) on the main path, and
    with ``check`` on the pretrain and the fusion paths too (``dev="cpu"``:
    the checks alone, for a rehearsal)."""
    import torch

    from ecg_byte_tpu_torch.cli import pretrain
    from ecg_byte_tpu_torch.models import fusion as F
    from ecg_byte_tpu_torch.models.lora import leaves
    from ecg_byte_tpu_torch.parallel import Rows, distributed
    from ecg_byte_tpu_torch.parallel.batches import shard_rows
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import apply_step, create_train_state, make_train_step

    timed = dev == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if timed else torch.device(dev)
    world, rank = distributed.world(), distributed.rank()
    out, times = {"times": {}}, {}
    params, config, lora, batch = _ddp_lm_model(root, vocab, merges, ddp, dev)
    rows = Rows.stride(len(batch["input_ids"]), world, rank)
    if check:
        out["lm"] = ddp_lm_run(params, config, lora, batch, rows)
        trainable, bn, loss_fn, mbatch = _ddp_merl_model(root, ddp, dev)
        out["merl"] = ddp_merl_run(trainable, bn, loss_fn, mbatch,
                                   Rows.stride(len(mbatch["norm_signal"]), world, rank))
        del trainable, bn, loss_fn, mbatch
    if not timed:
        return out

    def reduce(tree):
        return lambda: distributed.reduce_gradients_(leaves(tree), torch.zeros((), device=dev))

    opt = make_optimizer(config.hidden_size, 500)
    state = create_train_state(config, opt, torch.Generator(device=dev), peft=True, params=params,
                               lora=lora)
    step, gen = make_train_step(config, opt), torch.Generator().manual_seed(0)
    local, n_valid = shard_rows(batch, rows), int((batch["labels"][:, 1:] != -100).sum())
    times["lm"] = _timed(lambda: step(state, local, gen, rows, n_valid), reduce(state.trainable),
                         3)
    del params, lora, batch, state
    torch.cuda.empty_cache()
    if check:
        trainable, bn, loss_fn, batch = _ddp_merl_model(root, ddp, dev)
        rows = Rows.stride(len(batch["norm_signal"]), world, rank)
        for t in leaves(trainable):
            t.requires_grad_(True)
        opt, sched = make_optimizer(256, 500).build(leaves(trainable))
        local, state = shard_rows(batch, rows), {"bn": bn}
        drop = torch.Generator(device=dev).manual_seed(1)

        def step_loss():
            loss, state["bn"] = loss_fn(trainable, state["bn"], local, drop, rows)
            return loss

        def pretrain_step():  # cli.pretrain's step
            apply_step(leaves(trainable), step_loss, opt, sched, 1.0)

        times["merl"] = _timed(pretrain_step, reduce(trainable), 1)
        del trainable, bn, loss_fn, batch, opt, local, state
        torch.cuda.empty_cache()
        ts = dataclasses.replace(TWO_STAGE, llm=ddp.llm, tiny=ddp.tiny,
                                 pad_to_max=ddp.finetune_pad_to_max)
        params, config, tok, sig_id, encoders = _fusion_model(ts, dev)
        fusion, lora = _fusion_trainable(config, encoders, 0, dev)
        for t in leaves([params, encoders]):
            t.requires_grad_(False)
        trainable = {"lora": lora, "fusion": fusion}
        for t in leaves(trainable):
            t.requires_grad_(True)
        opt, sched = make_optimizer(config.hidden_size, 500).build(leaves(trainable))
        batch = _two_stage_items(root, tok, _finetune_args(ts), range(ddp.batch))
        rows = Rows.stride(len(batch["tokenized_signal"]), world, rank)
        count = F.label_count(batch["tokenized_signal"], batch["quantized_signal_ids_input"],
                              sig_id)
        local = pretrain.to_device(shard_rows(batch, rows), dev)

        def fusion_step():  # cli.finetune's step
            apply_step(leaves(trainable), lambda: F.fusion_lm_loss(
                params, config, fusion, "resnet_model", local, sig_id, encoders=encoders,
                lora=lora, dropout_generator=gen, rows=rows, count=count), opt, sched, 1.0)

        times["fusion"] = _timed(fusion_step, reduce(trainable), 3)
    out["times"] = times
    return out


@contextlib.contextmanager
def torchrun_env():
    """The environment torchrun gives the one rank of a one-process run (a
    free port on localhost), set for the block."""
    from ecg_byte_tpu_torch.cli.dist import _free_port

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def ddp_phase(root, vocab, merges, ddp=DDP, dev="cuda"):
    """Phase 17: ``--dis`` through the port's three training CLIs on the
    card: ``cli.main`` at W = 2 (both ranks on one card, gloo) and at W = 1
    (NCCL), ``cli.pretrain --model resnet`` and ``cli.finetune --model
    resnet_model`` at W = 2, each with exact launch counts per rank and
    checkpoints written by rank 0 alone (the W = 1 run in this process,
    from torchrun's environment); a two-rank harness whose main-path step
    is held to the one-process step and to f32 by :func:`hold_train_paths`
    and whose pretrain step is held to the one-process step in f32 and f64
    by :func:`check_dis_step`; the ms of each path's step and of its
    gradient all-reduce.  Returns the launch counts by path and the
    numbers.  (``dev="cpu"`` with ``Ddp(llm="tiny-llama", ...,
    tiny=True)`` rehearses it on the CPU, with ``N_TRAIN``, ``N_VAL``,
    ``_cli_args``, ``check_launch_counts`` and ``hold_train_paths``
    patched.)"""
    import torch

    from ecg_byte_tpu_torch.cli import finetune, pretrain
    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli.common import _PRESETS
    from ecg_byte_tpu_torch.parallel import distributed
    from ecg_byte_tpu_torch.parallel.spawn import spawn

    phase(f"17. --dis: cli.main at W = {DDP_WORLD} (one card, gloo) and W = 1 (NCCL), "
          f"B{ddp.batch} x {ddp.pad_to_max + 4} global; cli.pretrain --model resnet at B"
          f"{ddp.pretrain_batch}; cli.finetune --model resnet_model; the step held to one process")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cpu = dev == "cpu"
    extra = ["--device", "cpu"] if cpu else []
    tiny = ["--tiny", "--image_size", "32"] if ddp.tiny else []
    L = _PRESETS[ddp.llm]().num_layers
    two = ["--dis", "--gpus", ",".join(["0"] * DDP_WORLD), "--ports", "0"]
    n_train, n_val = (max(1, int(n * 0.25)) for n in (N_TRAIN, N_VAL))  # --toy
    numbers, by_path = {}, {}

    def run(cli, args):
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.chdir(root):
            out = cli.main(args + extra)
        assert launches() == dict.fromkeys(SOURCES, 0), "this process launched a kernel"
        return out, time.perf_counter() - t0

    def lm_counts(world, rank, embeds_grad=False):
        return dis_train_counts(L, rank_steps(n_train, ddp.batch, world, rank),
                                rank_steps(n_val, ddp.batch, world, rank), embeds_grad)

    def report(what, out, wall):
        s = out.get("training", out)
        numbers[f"{what}_ms_per_step_host"] = s["seconds"] / s["steps"] * 1e3
        print(f"{what}: {s['steps']} steps, train loss {s['train_loss']}, val loss "
              f"{s.get('val_loss')}; launches {[r['launches'] for r in out['ranks']]}; written "
              f"{[r['written'] for r in out['ranks']]}; {numbers[f'{what}_ms_per_step_host']:.1f}"
              f" ms a step with its data and evaluation (host clock); wall {wall:.1f} s")

    main_args = _cli_args() + ["--model", ddp.llm, "--peft", "--dev", "--toy", "--batch_size",
                               str(ddp.batch), "--pad_to_max", str(ddp.pad_to_max)]
    out, wall = run(cli_main, main_args + two)
    assert [r["backend"] for r in out["ranks"]] == ["gloo"] * DDP_WORLD, out["ranks"]
    want = [{**lm_counts(DDP_WORLD, r), "bpe_match": 2, "bpe_chain": 2} for r in range(DDP_WORLD)]
    check_dis_ranks(out, want, f"cli.main --dis, W = {DDP_WORLD}")
    report(f"cli.main W={DDP_WORLD}", out, wall)
    by_path["ddp_main"] = {k: sum(r["launches"][k] for r in out["ranks"]) for k in SOURCES}

    # one rank over NCCL, this process the rank as torchrun starts one
    zero_launches()
    t0 = time.perf_counter()
    with torchrun_env(), contextlib.chdir(root):
        out = cli_main.main(main_args + ["--dis", "--gpus", "0"] + extra)
    wall = time.perf_counter() - t0
    assert out["ranks"][0]["backend"] == ("gloo" if cpu else "nccl"), out["ranks"][0]["backend"]
    check_dis_ranks(out, [{**lm_counts(1, 0), "bpe_match": 2, "bpe_chain": 2}],
                    "cli.main --dis, W = 1 (torchrun's environment)")
    report("cli.main W=1", out, wall)
    for k in SOURCES:
        by_path["ddp_main"][k] += out["ranks"][0]["launches"][k]

    t0 = time.perf_counter()
    harness = spawn(ddp_rank, (root, vocab, merges, ddp, True, dev), world=DDP_WORLD,
                    devices=None if cpu else [0] * DDP_WORLD, timeout_s=900)
    with torchrun_env():
        if not cpu:
            torch.cuda.set_device(0)
        distributed.init(0, 1, "gloo" if cpu else "nccl", "env://")
        try:
            nccl = [ddp_rank(root, vocab, merges, ddp, False, dev)]
        finally:
            distributed.shutdown()
    print(f"harness: {DDP_WORLD} ranks (gloo) and 1 rank (NCCL, this process) in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in ("lm", "merl", "fusion"):
        for what, runs in ((f"W={DDP_WORLD} gloo", harness), ("W=1 NCCL", nccl)):
            for r, res in enumerate(runs):
                if path not in res["times"]:
                    continue
                step_ms, reduce_ms = res["times"][path]
                numbers[f"{path}_{what}_rank{r}_ms"] = step_ms
                numbers[f"{path}_{what}_rank{r}_allreduce_ms"] = reduce_ms
                print(f"{path} train step, {what}, rank {r}: {step_ms:.2f} ms (CUDA events), "
                      f"its gradient all-reduce {reduce_ms:.2f} ms = "
                      f"{100 * reduce_ms / step_ms:.1f}% of a step")

    # the main path's step: W = 2 against one process (kernels) and f32
    params, config, lora, batch = _ddp_lm_model(root, vocab, merges, ddp, torch.device(dev))
    one = ddp_lm_run(params, config, lora, batch)
    with plain_path():
        f32 = lambda t: t.float()  # noqa: E731
        ref = ddp_lm_run(_map_tree(f32, params), config.replace(dtype="float32"),
                         _map_tree(f32, lora), batch)
    del params, lora
    w2 = [res["lm"] for res in harness]
    rows = range(len(batch["input_ids"]))
    # global row g is rank g % W's row g // W
    kern = (w2[0][0], *(torch.cat([w2[g % DDP_WORLD][j][g // DDP_WORLD] for g in rows])
                        for j in (1, 2)), w2[0][3])
    assert all(w[0] == w2[0][0] for w in w2), [w[0] for w in w2]
    flat = [(x[0], torch.cat(x[1]), torch.cat(x[2]), x[3]) for x in (one, ref)]
    print(f"main-path step, B{len(rows)}: W = {DDP_WORLD} loss {kern[0]:.6f}, one process "
          f"{one[0]:.6f}, f32 {ref[0]:.6f}; W = {DDP_WORLD} against one process: " + ", ".join(
              f"{k} {(torch.linalg.vector_norm(kern[3][k] - one[3][k]) / torch.linalg.vector_norm(one[3][k])).item():.2e}"
              for k in one[3]))
    print(f"errors against f32 (W = {DDP_WORLD} in the kernel path's place / one process):")
    hold_train_paths([kern], [flat[0]], [flat[1]])

    # the pretrain step: W = 2 against one process in f32 and in f64
    model = _ddp_merl_model(root, ddp, torch.device(dev))
    one = ddp_merl_run(*model)
    torch.cuda.empty_cache()
    ref = ddp_merl_run(*_f64(model))
    del model
    torch.cuda.empty_cache()
    for r, res in enumerate(harness):
        errs = check_dis_step(res["merl"], one, ref)
        print(f"pretrain step, rank {r} of {DDP_WORLD} against one process: " + ", ".join(
            f"{k} {e:.2e}" if isinstance(e, float) else f"{k} {e[0]:.3e} ({e[1]:.3e})"
            for k, e in errs.items()) + f" (bounds: {DDP_F32_TOL}; {DDP_GRAD_RATIO}x + "
            f"{DDP_F32_TOL})")

    pre_args = ["--model", "resnet", "--dataset", ddp.pretrain_data, "--batch_size",
                str(ddp.pretrain_batch), "--dev"] + tiny
    out, wall = run(pretrain, pre_args + two)
    check_dis_ranks(out, [{}] * DDP_WORLD, f"cli.pretrain --dis, W = {DDP_WORLD}")
    report(f"cli.pretrain W={DDP_WORLD}", out, wall)

    ft_args = ["--model", "resnet_model", "--llm", ddp.llm, "--dataset", "ptb_500", "--toy",
               "--batch_size", str(ddp.batch), "--pad_to_max", str(ddp.finetune_pad_to_max),
               "--dev", "--first_check", os.path.basename(out["directory"])] + tiny
    out, wall = run(finetune, ft_args + two)
    check_dis_ranks(out, [lm_counts(DDP_WORLD, r, embeds_grad=True) for r in range(DDP_WORLD)],
                    f"cli.finetune --dis, W = {DDP_WORLD}")
    report(f"cli.finetune W={DDP_WORLD}", out, wall)
    by_path["ddp_finetune"] = {k: sum(r["launches"][k] for r in out["ranks"]) for k in SOURCES}
    numbers["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {json.dumps(numbers)}; phase wall {numbers['wall_s']:.1f} s")
    return by_path, numbers


# ------------------------------------------- phase 18: interpretation, translation, analysis

# Helsinki-NLP/opus-mt-de-en's published config: 73.9M stored parameters (295.8 MB
# of f32), the Marian translation model of the PTB-XL preprocessing
OPUS_MT_DE_EN = dict(vocab_size=58101, d_model=512, encoder_layers=6, decoder_layers=6,
                     num_heads=8, ffn_dim=2048, activation="swish", max_position_embeddings=512,
                     pad_token_id=58100, eos_token_id=0, decoder_start_token_id=58100)
# the translation on the card against the port's CPU run of the same
# directory: teacher-forced f32 logits within MARIAN_TOL of the largest
# |logit| (f32 on both, TF32 off; sums in another order through 12 layers)
MARIAN_TOL = 1e-4
# the layer and head mean of the interpretation: the streamed mean against
# the eager stack's mean (f32 sums in another order: the JAX package's
# bound, tests/test_interpret.py); each valid row's sum within one bf16 ulp
# of 1 (each probability rounded to bf16 after an exact f32 softmax)
MEAN_TOL = 2e-6
ROW_SUM_TOL = 2.0 ** -8


@dataclasses.dataclass(frozen=True)
class Slice:
    """The sizes of phase 18: full width on the card (the defaults), tiny
    for a rehearsal on the CPU."""

    model: str = MODEL
    batch: int = 4  # cli.main --dev at its default --pad_to_max 1000: S 1004
    interp_pad_to_max: int = 1020  # cli.interp_analysis's default: S 1024
    marian: tuple = tuple(OPUS_MT_DE_EN.items())
    sentences: int = 64  # two batches of translate_reports' 32
    # items of the train-step check at S 1004: one batch of the CLI's 4, as
    # phase 7 (the pooled cross entropy's ratio to plain spreads with fewer:
    # 1.00 and 1.27 over two items at S 1024 and 1004, 1.15 and 1.18 over
    # four, NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
    check_items: int = 4


SLICE = Slice()

_RHYTHMS = ("Sinusrhythmus", "Sinusbradykardie", "Sinustachykardie", "Vorhofflimmern")
_AXES = ("Linkstyp", "Steiltyp", "Indifferenztyp", "überdrehter Linkstyp")
_FINDINGS = ("normales EKG", "unvollständiger Rechtsschenkelblock", "linksanteriorer Hemiblock",
             "periphere Niedervoltage", "ST-Senkung in V5 und V6", "T-Negativierung in III",
             "AV-Block I. Grades", "ventrikuläre Extrasystolen", "Q-Zacken in II, III und aVF")


def german_reports(n):
    """``n`` PTB-XL-style German report sentences."""
    return [f"{_RHYTHMS[i % 4]}, {_AXES[i // 4 % 4]}, {_FINDINGS[i % 9]}"
            + (f", {_FINDINGS[(i + 4) % 9]}." if i % 3 else ".") for i in range(n)]


def write_random_marian(out_dir, texts, widths=OPUS_MT_DE_EN, seed=0):
    """A random opus-mt-style directory: ``config.json`` and
    ``model.safetensors`` (f32, HF's init std 0.02, written by the port's
    ``save_hf_marian``), a unigram ``source.spm`` (the port's ``write_spm``)
    holding every word and character of ``texts`` and a ``vocab.json`` of
    the model's vocabulary size.  Returns (config, tensor bytes written)."""
    import torch

    from ecg_byte_tpu_torch.models import marian
    from ecg_byte_tpu_torch.tokenizer import sp_model

    config = marian.MarianConfig(**dict(widths))
    params = marian.init_params(config, torch.Generator().manual_seed(seed))
    nbytes = marian.save_hf_marian(params, config, out_dir)
    words = sorted({w for t in texts for w in t.split()})
    chars = sorted({c for t in texts for c in t if not c.isspace()})
    pieces = [("<unk>", 0.0), ("▁", -2.0)] + [("▁" + w, -1.0) for w in words]
    pieces += [(c, -3.0) for c in chars]
    sp_model.write_spm(os.path.join(out_dir, "source.spm"), pieces)
    vocab = {"</s>": config.eos_token_id, "<pad>": config.pad_token_id}
    taken = set(vocab.values())
    free = (i for i in range(config.vocab_size) if i not in taken)
    for piece, _ in pieces:
        vocab[piece] = next(free)
    for i, tid in enumerate(free):
        vocab[f"▁t{i}"] = tid
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    return config, nbytes


def check_attention_mean(mean, stack_mean, mask, what):
    """Hold the streamed layer and head mean (B, S, S) to the eager stack's
    mean within MEAN_TOL; on every valid query row, each row sums to 1
    within ROW_SUM_TOL and its pad columns are 0 exactly (the causal future
    too).  Returns the largest |d|."""
    import torch

    d = (mean - stack_mean).abs().max().item()
    assert d <= MEAN_TOL, f"{what}: streamed mean {d:.3e} from the eager stack's mean"
    valid = mask.bool()
    rows = mean[valid]  # (valid rows, S)
    sums = (rows.double().sum(-1) - 1).abs().max().item()
    assert sums <= ROW_SUM_TOL, f"{what}: a valid row sums to 1 +- {sums:.3e}"
    b, s = mask.shape
    future = torch.ones(s, s, dtype=torch.bool, device=mean.device).triu(1)
    masked = (~valid[:, None, :] | future[None]) & valid[:, :, None]
    assert (mean[masked] == 0).all(), f"{what}: a valid row attends a pad or future column"
    return d, sums


def check_marian_streams(tokens, card, cpu, eos, pad, tol=MARIAN_TOL):
    """Hold the card's greedy ``tokens`` (B, T) and its teacher-forced f32
    logits ``card`` (B, T - 1, V) to the CPU's ``cpu``: the logits within
    ``tol`` of max|cpu|; each row's next token is the CPU's argmax (the pad
    token banned, as greedy decoding bans it) at every step up to its eos,
    or up to the first step whose CPU top-2 margin is under twice that
    bound (a near tie that the sums' order may decide).  Returns (max|d|,
    bound, steps held, rows cut at a near tie)."""
    import torch

    d = (card - cpu).abs().max().item()
    bound = tol * cpu.abs().max().item()
    assert d <= bound, f"translation logits: max|d| {d:.3e} past {bound:.3e}"
    cpu = cpu.clone()
    cpu[..., pad] = -float("inf")
    top2 = cpu.topk(2, dim=-1)
    held, ties = 0, 0
    for r in range(tokens.shape[0]):
        for t in range(tokens.shape[1] - 1):
            if (top2.values[r, t, 0] - top2.values[r, t, 1]).item() < 2 * bound:
                ties += 1
                break
            nxt = int(tokens[r, t + 1])
            assert int(top2.indices[r, t, 0]) == nxt, \
                f"translation row {r} step {t}: the card chose {nxt}, the CPU's argmax " \
                f"{int(top2.indices[r, t, 0])}"
            held += 1
            if nxt == eos:
                break
    return d, bound, held, ties


# the CUDA kernel that runs once for each launch its wrapper counts, by the
# demangled name torch.profiler records: the attention forwards, the dQ
# kernel of each backward (its dK/dV kernel follows it), the RMSNorm row
# kernels (rmsnorm_dw_sum_kernel follows a backward only where w trains)
TRACE_KERNELS = {
    "prefill_attention": r"fwd::fwd_kernel<\d+, (false|\(bool\)0)>",
    "prefill_attention_bwd": r"bwd::dq_kernel<\d+, (false|\(bool\)0)>",
    "flash_attention": r"fwd::fwd_kernel<\d+, (true|\(bool\)1)>",
    "flash_attention_bwd": r"bwd::dq_kernel<\d+, (true|\(bool\)1)>",
    "rmsnorm": r"rmsnorm_fwd_kernel<",
    "rmsnorm_bwd": r"rmsnorm_bwd_kernel<",
}
# ECG_BYTE_LOG_MEMORY=1: cli.main's readings of a training run, in order
# (ecg_byte_tpu/cli/main.py:174-178, :194-195, :394-395)
MEMORY_TAGS = ("after model build + ECG-token resize",
               "after train-state creation (params + opt state)", "after first training epoch")


class _Tee(io.TextIOBase):
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def trace_kernel_counts(path):
    """The CUDA kernel events of a Chrome trace file (``--profile``): their
    count by wrapper (:data:`TRACE_KERNELS`), and every kernel event's
    name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: sum(bool(re.search(p, n)) for n in names) for k, p in TRACE_KERNELS.items()}, names


def check_trace_counts(traced, counts, dev):
    """The kernels a trace holds, by wrapper, equal the wrappers' counts of
    the traced run; on the card the trace names the resident forward and
    backward and both RMSNorm kernels."""
    for name, n in traced.items():
        assert n == counts[name], f"the trace holds {n} {name} kernels, the counter {counts[name]}"
    if str(dev).startswith("cuda"):
        missing = [k for k in ("prefill_attention", "prefill_attention_bwd", "rmsnorm",
                               "rmsnorm_bwd") if not traced[k]]
        assert not missing, f"the trace names no {missing} kernel"


def check_memory_lines(text, total, tags=MEMORY_TAGS):
    """``ECG_BYTE_LOG_MEMORY=1``'s lines in ``text``: the readings ``tags``,
    in order, each a byte count in (0, total]; returns the counts."""
    lines = [ln for ln in text.splitlines() if ln.startswith("[memory] ")]
    got = tuple(ln[len("[memory] "):].split(": ", 1)[0] for ln in lines)
    assert got == tuple(tags), f"memory readings {got}, expected {tags}"
    values = [int(ln.rsplit("(", 1)[1].split()[0]) for ln in lines]
    assert all(0 < v <= total for v in values), f"memory readings {values} not in (0, {total}]"
    return values


def slice_phase(root, vocab, merges, checkpoint, sl=SLICE, dev="cuda"):
    """Phase 18: (a) ``cli.main --peft --dev`` at its default --pad_to_max
    1000 (S 1004, through ``attention.resident_padded``): exact launch
    counts, then the train step at S 1004 held to the plain path and f32 by
    :func:`hold_train_paths`; (b) ``cli.interp_analysis`` on phase 6's
    checkpoint at --pad_to_max 1020 (S 1024) from the device token cache:
    exact launch counts, then the first record's streamed mean held to the
    eager stack's, its rows and pad columns (:func:`check_attention_mean`),
    and the kernel path's mean no further from f32 than 1.25x the plain
    path's; (c) ``translate_reports`` on ``sl.sentences`` German sentences
    with a size-exact random opus-mt-de-en directory, held to the port's
    CPU run of it (:func:`check_marian_streams`); (d) both analysis CLIs on
    the ptb_500 files, without matplotlib.  Returns the launch counts by
    path and the phase's numbers.  (``dev="cpu"`` with a tiny ``Slice``
    rehearses it on the CPU, with ``N_TRAIN``, ``N_VAL``, ``N_TEST``,
    ``check_launch_counts`` and ``hold_train_paths`` patched.)"""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import interp_analysis, token_distribution, track_bpe_encoding
    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli.common import _PRESETS, build_model
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset, collate
    from ecg_byte_tpu_torch.data.preprocess import translate_reports
    from ecg_byte_tpu_torch.interpret import get_component_indices
    from ecg_byte_tpu_torch.models import marian
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.ops import attention
    from ecg_byte_tpu_torch.tokenizer import encode_text
    from ecg_byte_tpu_torch.tokenizer.analysis import quantize_file
    from ecg_byte_tpu_torch.tokenizer.sp_model import MarianSpTokenizer
    from ecg_byte_tpu_torch.train.checkpoint import load_weights
    from ecg_byte_tpu_torch.utils import viz_utils
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    s_train = 1000 + 4
    phase(f"18. cli.main at its default --pad_to_max 1000 (S {s_train}); cli.interp_analysis at "
          f"S {sl.interp_pad_to_max + 4}; translate_reports with a size-exact random "
          "opus-mt-de-en; the analysis CLIs")
    if cuda:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev_args = [] if cuda else ["--device", "cpu"]
    data_args = ["--dataset", "ptb_500", "--tokenizer_check", f"tokenizer_{NUM_MERGES}",
                 "--num_merges", str(NUM_MERGES), "--percentiles", "data/ptb_500_dataset_stats.npy"]
    by_path, out = {}, {}
    layers = _PRESETS[sl.model]().num_layers

    # (a) training at the CLI's default --pad_to_max: S 1004 through the padding,
    # traced (--profile) and with the memory readings (ECG_BYTE_LOG_MEMORY=1);
    # on --toy's quarter of the records, cut from all of them to hold the
    # script's time with the trace added
    zero_launches()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.chdir(root), contextlib.redirect_stdout(_Tee(sys.stderr, log)), \
            mock.patch.dict(os.environ, {"ECG_BYTE_LOG_MEMORY": "1"}):
        summary = cli_main.main(["--model", sl.model, *data_args, *dev_args, "--peft", "--dev",
                                 "--toy", "--batch_size", str(sl.batch), "--profile",
                                 "profile"])["training"]
    sync()
    counts = by_path["train_pad1000"] = launches()
    steps, evals = summary["steps"], -(-max(1, int(N_VAL * 0.25)) // sl.batch) * 2  # --toy
    check_launch_counts(counts, {
        "prefill_attention": layers * (steps + evals), "prefill_attention_bwd": layers * steps,
        "rmsnorm": (2 * layers + 1) * (steps + evals), "rmsnorm_bwd": 2 * layers * steps,
        "bpe_match": 2, "bpe_chain": 2}, "18a cli.main --pad_to_max 1000")
    assert all(np.isfinite(summary["train_loss"] + summary["val_loss"])), summary
    run_s = time.perf_counter() - t0
    print(f"18a cli.main --peft --dev --toy --batch_size {sl.batch} --profile (default --pad_to_max "
          f"1000): {steps} train steps and {evals} eval steps at S {s_train}, {run_s:.1f} s; "
          f"train loss {summary['train_loss']}, val loss {summary['val_loss']}; launches {counts}")
    # the trace holds the epoch loop: every launch but the token cache's
    t0 = time.perf_counter()
    (trace_path,) = glob.glob(os.path.join(root, "profile", "rank0.*.pt.trace.json"))
    traced, names = trace_kernel_counts(trace_path)
    check_trace_counts(traced, counts, dev)
    total = (torch.cuda.get_device_properties(dev).total_memory if cuda
             else os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    memory = check_memory_lines(log.getvalue(), total)
    assert "Profiler trace written to profile" in log.getvalue()
    print(f"18a --profile: {trace_path[len(root) + 1:]}, {os.path.getsize(trace_path) / 1e6:.1f} "
          f"MB, {len(names)} kernel events, {len(set(names))} kernels; by wrapper {traced}, equal "
          f"to the counters less the token cache's; read in {time.perf_counter() - t0:.1f} s; "
          f"ECG_BYTE_LOG_MEMORY: {memory} bytes (of {total}); the port's kernels in it: "
          f"{sorted({n for n in names if any(re.search(p, n) for p in TRACE_KERNELS.values())})}")
    out.update(profiled_run_s=run_s, trace_mb=os.path.getsize(trace_path) / 1e6,
               memory_bytes=memory)
    train_paths_phase(root, vocab, merges, TrainCheck(
        f"18a. train-step kernel path vs plain path at B1 x {s_train} (S not a multiple of 16: "
        "the padded route)", 1000, ("prefill_attention", "prefill_attention_bwd", "rmsnorm",
                                    "rmsnorm_bwd"), items=sl.check_items),
        model=sl.model, dev=dev)

    # (b) interpretation on phase 6's checkpoint
    phase(f"18b. cli.interp_analysis on phase 6's checkpoint at --pad_to_max "
          f"{sl.interp_pad_to_max}")
    if cuda:
        torch.cuda.empty_cache()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root), contextlib.redirect_stdout(sys.stderr), \
            mock.patch.object(viz_utils, "_pyplot", lambda: None):
        res = interp_analysis.main(["--model", sl.model, *data_args, *dev_args, "--checkpoint",
                                    checkpoint, "--pad_to_max", str(sl.interp_pad_to_max),
                                    "--seg_len", str(SEG_LEN)])
    sync()
    counts = by_path["interpret"] = launches()
    n = res["summary"]["records"]
    assert n == len(res["signal"]["sequences"]) == N_TEST, res["summary"]
    # 2L norms a record: mean_attention stops before the final norm and the head
    check_launch_counts(counts, {"rmsnorm": 2 * layers * n, "bpe_match": 1,
                                 "bpe_chain": 1}, "18b cli.interp_analysis")
    interp_s = time.perf_counter() - t0
    params, config, tok = build_model(sl.model, vocab, dev)
    params, lora = load_weights(os.path.join(root, "runs", "0", checkpoint), "best_model", params,
                                peft=True)
    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/test", f"{data}/ptb_500/text/test")
    ds = ECGTokenDataset(sigs[:1], texts[:1], vocab, merges, tokenizer=tok,
                         args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy",
                                         pad_to_max=sl.interp_pad_to_max))
    item = collate([ds[0]], pad_id=ds.pad_id)
    ids, mask, pos = (torch.from_numpy(np.asarray(item[k], np.int32)).to(dev)
                      for k in ("tokenized_signal", "attn_mask", "position_ids"))
    assert ids.shape[1] == sl.interp_pad_to_max + 4, ids.shape
    with torch.inference_mode():
        mean = T.mean_attention(params, config, ids, mask, pos, lora=lora)
        stack = T.forward(params, config, ids, mask, pos, lora=lora, return_attentions=True)[1]
        stack_mean = stack.float().mean(dim=(0, 2))
        del stack
        d_stack, d_sum = check_attention_mean(mean, stack_mean, mask, "18b")
        del stack_mean
        s0, q0, _ = get_component_indices(item["tokenized_signal"][0],
                                          item["quantized_signal_ids_input"][0], tok)
        cli_row = np.asarray(res["signal"]["attentions"][0])
        d_cli = np.abs(cli_row - mean[0, s0:q0, s0:q0].mean(0).cpu().numpy()).max()
        assert d_cli <= 1e-6, f"18b: the CLI's signal attention {d_cli:.3e} from mean_attention"
        with plain_path():
            plain = T.mean_attention(params, config, ids, mask, pos, lora=lora)
            f32 = lambda t: t.float()  # noqa: E731
            ref = T.mean_attention(_map_tree(f32, params), config.replace(dtype="float32"), ids,
                                   mask, pos, lora=_map_tree(f32, lora))

        def rel(a, b):
            return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

        ek, ep, ekp = rel(mean, ref), rel(plain, ref), rel(mean, plain)
    print(f"18b: {n} records, {res['summary']['forward_ms_per_record']:.2f} ms a record "
          f"(mean_attention, host clock), peak {res['summary']['peak_gib']} GiB, CLI "
          f"{interp_s:.1f} s; launches {counts}; record 0 at S {ids.shape[1]}: streamed mean "
          f"vs eager stack max|d| {d_stack:.3e} (bound {MEAN_TOL:.0e}), valid rows sum to 1 "
          f"+- {d_sum:.3e} (bound {ROW_SUM_TOL:.2e}), pad and future columns 0; the CLI's "
          f"signal row within {d_cli:.1e}; |d|/|ref| against f32: kernel path {ek:.3e}, plain "
          f"{ep:.3e} (bound 1.25x plain), kernel vs plain {ekp:.3e}")
    assert ek <= 1.25 * ep, f"18b: the kernel path's mean {ek:.3e} from f32, plain's {ep:.3e}"
    out.update(interp_ms_per_record=res["summary"]["forward_ms_per_record"],
               interp_peak_gib=res["summary"]["peak_gib"])
    del params, lora, plain, ref, mean

    # (c) translation with a size-exact random opus-mt-de-en
    phase(f"18c. translate_reports: {sl.sentences} German sentences, a random opus-mt-de-en "
          "directory")
    if cuda:
        torch.cuda.empty_cache()
    mdir = os.path.join(root, "opus-mt-de-en")
    reports = german_reports(sl.sentences)
    t0 = time.perf_counter()
    mconfig, nbytes = write_random_marian(mdir, reports, dict(sl.marian))
    write_s = time.perf_counter() - t0
    zero_launches()
    stats = {}
    t0 = time.perf_counter()
    texts = np.asarray(reports + ["", "  "], dtype=object)
    with contextlib.redirect_stdout(sys.stderr):
        got = translate_reports(texts, model_dir=mdir, device=dev, stats=stats)
    sync()
    wall = time.perf_counter() - t0
    assert launches() == dict.fromkeys(SOURCES, 0), "translation launched a kernel of the port"
    assert got.shape == texts.shape and all(isinstance(t, str) for t in got), got
    assert got[-1] == got[-2] == "" and stats["sentences"] == sl.sentences, stats
    tokenizer = MarianSpTokenizer(mdir)
    mparams, mconf = marian.load_hf_marian(mdir, dev)
    first = reports[:32]  # translate_reports' first batch
    enc = tokenizer(first, truncation=True, max_length=512)
    width = max(64, -(-enc["input_ids"].shape[1] // 64) * 64)
    src = np.pad(enc["input_ids"], ((0, 0), (0, width - enc["input_ids"].shape[1])),
                 constant_values=tokenizer.pad_token_id)
    src_mask = np.pad(enc["attention_mask"], ((0, 0), (0, width - enc["input_ids"].shape[1])))
    run = {}
    sync()
    t0 = time.perf_counter()
    tokens = marian.greedy_generate(mparams, mconf, src, src_mask, max_length=128, stats=run)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / run["steps"]
    src_t, mask_t = torch.from_numpy(src), torch.from_numpy(src_mask)
    with torch.inference_mode():
        card = marian.forward(mparams, mconf, src_t.to(dev), mask_t.to(dev),
                              tokens[:, :-1].long()).cpu()
        del mparams
        cparams, _ = marian.load_hf_marian(mdir, "cpu")
        cpu = marian.forward(cparams, mconf, src_t, mask_t, tokens[:, :-1].long().cpu())
        del cparams
    d, bound, held, ties = check_marian_streams(tokens.cpu(), card, cpu, mconf.eos_token_id,
                                                mconf.pad_token_id)
    decoded = tokenizer.batch_decode(tokens.cpu().numpy())
    assert list(got[:len(first)]) == decoded, "translate_reports differs from its greedy_generate"
    print(f"18c: {nbytes / 1e6:.1f} MB of f32 written in {write_s:.1f} s; translate_reports "
          f"{len(texts)} reports ({sl.sentences} sentences, {stats['batches']} batches, "
          f"{stats['decode_steps']} decode steps) in {wall:.2f} s: "
          f"{sl.sentences / wall:.1f} sentences/s (load included, host clock); greedy_generate "
          f"B{len(first)} x 128: {step_ms:.3f} ms a decode step; teacher-forced logits card vs CPU max|d| "
          f"{d:.3e} (bound {bound:.3e}); {held} greedy steps equal to the CPU's argmax, "
          f"{ties} rows cut at a near tie; no kernel launched")
    out.update(sentences_per_s=sl.sentences / wall, marian_step_ms=step_ms)

    # (d) the analysis CLIs, without matplotlib (the card's machine has none)
    phase("18d. cli.token_distribution and cli.track_bpe_encoding on ptb_500")
    t0 = time.perf_counter()
    tok_path = os.path.join(data, f"tokenizer_{NUM_MERGES}.pkl")
    stats_path = os.path.join(data, "ptb_500_dataset_stats.npy")
    with contextlib.redirect_stdout(sys.stderr), mock.patch.object(viz_utils, "_pyplot",
                                                                   lambda: None):
        counts_tok, lengths = token_distribution.main([
            "--tokenizer", tok_path, "--ecg_glob", f"{data}/ptb_500/ecg/train/*.npy",
            "--percentiles", stats_path, "--out_dir", os.path.join(root, "pngs")])
        ids_t, segmap = track_bpe_encoding.main([
            "--tokenizer", tok_path, "--ecg_file", sigs[0], "--percentiles", stats_path,
            "--out_dir", os.path.join(root, "pngs")])
    assert len(lengths) == N_TRAIN and sum(counts_tok.values()) == sum(lengths)
    percentiles = np.load(stats_path, allow_pickle=True).item()
    text = quantize_file(sigs[0], percentiles)
    assert ids_t == encode_text(text, merges)
    assert segmap[0][0] == 0 and segmap[-1][1] == len(text) == 12 * SEG_LEN
    assert all(e == s2 for (_, e), (s2, _) in zip(segmap, segmap[1:]))
    assert not os.path.exists(os.path.join(root, "pngs"))
    print(f"18d: {len(lengths)} files, {len(counts_tok)} distinct tokens, mean "
          f"{np.mean(lengths):.1f} a file; {len(text)} symbols -> {len(ids_t)} tokens, spans "
          f"tile the record; no plot drawn; {time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 18 {out['wall_s']:.1f} s")
    return by_path, out


# ------------------------------------------------ phase 19: --tp and --fsdp


@dataclasses.dataclass(frozen=True)
class Grid:
    """The sizes of phase 19: full width on the card (the defaults), tiny for
    a rehearsal on the CPU."""

    llm: str = MODEL
    batch: int = 4  # the global batch of the CLI runs and of the harness's B x 1024 step
    pad_to_max: int = 1020  # S 1024, as phase 6
    long_pad_to_max: int = 4092  # S 4096, as phase 10: the flash kernels
    # the harness's depth, and the tp decode check's: cut from 4 and from the
    # model's 16 to hold the script's time with phase 20 added
    layers: int = 2
    decode_layers: int = 4
    new_tokens: int = 16


GRID = Grid()
GRID_TP, GRID_FSDP = 2, 2  # the harness's grid: four ranks on one card
# what each collective of a step is, by the group it runs on
_GROUP_KINDS = ("tp", "fsdp", "data", "host")


def check_tp_stream(tp, one, margins, bound, what=("tp", "one process")):
    """The token stream of a tp group against one process's: equal, or where
    they part, one process's top-2 margin at that step (``margins[k]``) no
    wider than ``bound``, the logits' own error (a near tie flips either
    way).  Returns the first step where they part (None: equal).  ``what``
    names the two paths (phase 20: the folded and the classic tree)."""
    tp, one = [int(t) for t in tp], [int(t) for t in one]
    if tp == one:
        return None
    path, ref = what
    k = next(i for i, (a, b) in enumerate(zip(tp, one)) if a != b)
    print(f"{path} stream parts from {ref}'s at step {k}: {ref}'s top-2 margin "
          f"{margins[k]:.4e} against the logits bound {bound:.4e}")
    assert margins[k] <= bound, (f"the {path} stream parts at step {k}, where {ref}'s top-2 "
                                 f"margin {margins[k]:.4e} is wider than {bound:.4e}")
    return k


@contextlib.contextmanager
def recorded_collectives(log):
    """Log each collective that ``torch.distributed`` runs in the block: its
    function, tensor shapes and dtype, group and op (the port's collectives
    call them through the module, so the patch sees every one)."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    saved = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def call(*args, **kw):
            tensors = [a for a in args if hasattr(a, "shape")]
            log.append((name, [(tuple(t.shape), t.dtype, t.device) for t in tensors],
                        kw.get("group"), kw.get("op")))
            return saved[name](*args, **kw)
        return call

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def replay_collectives(log, kind_of, repeats=3):
    """ms of each kind of the collectives in ``log`` (one step's), replayed
    alone on fresh tensors of their shapes, every rank in the same order:
    host clock around ``torch.cuda.synchronize`` (gloo copies through the
    host)."""
    import torch
    import torch.distributed as dist

    out = {}
    for kind in _GROUP_KINDS:
        calls = [c for c in log if kind_of(c[2]) == kind]
        bufs = [[torch.zeros(shape, dtype=dt, device=d) for shape, dt, d in specs]
                for _, specs, _, _ in calls]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            for (name, _, group, op), b in zip(calls, bufs):
                kw = {"group": group} if op is None else {"group": group, "op": op}
                getattr(dist, name)(*b, **kw)
        torch.cuda.synchronize()
        out[kind] = ((time.perf_counter() - t0) * 1e3 / repeats, len(calls))
    return out


def cut_depth(params, config, layers):
    """``params`` and ``config`` cut to their first ``layers`` layers (all
    of them where the model has fewer)."""
    n = min(layers, config.num_layers)
    return {**params, "layers": params["layers"][:n]}, config.replace(num_layers=n)


def _grid_model(root, vocab, merges, g, dev, layers, n, pad_to_max):
    """The main path's random model (seed 0) cut to ``layers``, LoRA adapters
    with B != 0 (seed 2), and ``n`` training items at ``pad_to_max``."""
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.train.step import _batch_tensors

    params, config, tok = build_model(g.llm, vocab, dev)
    params, config = cut_depth(params, config, layers)
    lora = random_lora(config, 2, dev)
    batch = _batch_tensors(_training_items(root, vocab, merges, tok, n, pad_to_max), dev)
    return params, config, lora, batch


def grid_lm_run(params, config, lora, batch):
    """The port's train step's forward and backward (LoRA dropout on, its
    masks drawn for the global batch) on the global ``batch``, on this
    rank's grid (one process without one): the state sharded by the JAX
    specs, this rank's rows.  Returns (loss, [(global row, cross entropies
    at its labelled positions, at its valid positions)] of the rows it
    holds, {LoRA group: whole gradient}); the loss and gradients are the
    global batch's."""
    import torch

    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.parallel import Rows, mesh, sharding
    from ecg_byte_tpu_torch.parallel.batches import shard_rows
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import (
        _no_rows,
        compute_gradients,
        create_train_state,
        shard_train_state,
    )

    dev = batch["input_ids"].device
    opt = make_optimizer(config.hidden_size, 500)
    lora = _map_tree(lambda t: t.detach().clone(), lora)
    state = create_train_state(config, opt, torch.Generator(device=dev), peft=True, params=params,
                               lora=lora)
    state = shard_train_state(state, opt)
    total = len(batch["input_ids"])
    rows = Rows.stride(total, mesh.data_world(), mesh.data_rank())
    local = shard_rows(batch, rows)
    loss = compute_gradients(config, state, local, torch.Generator().manual_seed(0), rows=rows,
                             n_valid=int((batch["labels"][:, 1:] != -100).sum()))
    names = [(n, k) for n in lora["layers"][0] for k in ("a", "b")]
    grads = {f"LoRA {n}.{k}": torch.cat([
        sharding.gather(sharding.mark(layer[n][k].grad, layer[n][k])).float().flatten()
        for layer in state.trainable["layers"]]).cpu() for n, k in names}
    ces = []
    held = len(rows.index)
    # every rank of an fsdp group runs as many forwards and heads as the one
    # holding the most rows (a row no loss counts where it holds fewer), so
    # their gathers stay in step
    most = -(-total // mesh.data_world())
    run = local if held else _no_rows(local, rows)[0]
    with torch.no_grad():
        hidden = T.forward(state.base, config, run["input_ids"], run["attn_mask"],
                           run["position_ids"], lora=state.trainable, return_hidden=True)
        for i in range(most):
            j = min(i, held - 1) if held else 0  # past its rows: a row no result reads
            h = hidden[i:i + 1] if i < held else torch.zeros_like(hidden[:1])
            logits = T._unembed(state.base, config, h)[0, :-1]  # this rank's vocabulary columns
            labels, nxt = run["labels"][j, 1:], run["input_ids"][j, 1:]
            lab = vocab_ce(logits, labels.clamp_min(0), config.vocab_size)
            every = vocab_ce(logits, nxt, config.vocab_size)
            del logits
            if i < held:
                ces.append((rows.index[i], lab[labels != -100].cpu(),
                            every[valid_predictions(local["attn_mask"][i])].cpu()))
    return loss.item(), ces, grads


def vocab_ce(logits, targets, vocab):
    """The cross entropy of ``targets`` at each row of f32 ``logits`` (S, V),
    as logsumexp minus the target's logit; under ``--tp`` ``logits`` is this
    rank's block of the vocabulary (``transformer._unembed``), and the max,
    the sum of exponentials and the target's logit are reduced over the tp
    group, so no rank gathers the whole (S, V)."""
    import torch

    from ecg_byte_tpu_torch.parallel import distributed, mesh

    g = mesh.grid()
    lo = g.t * -(-vocab // g.tp)
    local = targets - lo
    held = (local >= 0) & (local < logits.shape[-1])
    lab = torch.where(held, logits.gather(1, local.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0],
                      0.0)
    m = logits.amax(-1)
    if g.tp > 1:
        distributed.all_reduce_(m, g.tp_group, "max")
    se = torch.exp(logits - m[:, None]).sum(-1)
    if g.tp > 1:
        distributed.all_reduce_(se, g.tp_group)
        distributed.all_reduce_(lab, g.tp_group)
    return m + torch.log(se) - lab


def _tp_prompt(root, vocab, merges, tok, dev):
    """The first test record as the CLI's serving prompt, left-padded to its
    bucket: (ids, mask), (1, S)."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/test", f"{data}/ptb_500/text/test")
    item = ECGTokenDataset(sigs[:1], texts[:1], vocab, merges, tokenizer=tok,
                           args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy",
                                           inference=True))[0]
    n = len(item["tokenized_signal"])
    s = bucket(n)
    ids = np.concatenate([np.full(s - n, tok.pad_token_id), item["tokenized_signal"]])
    mask = np.concatenate([np.zeros(s - n), np.ones(n)])
    return (torch.from_numpy(ids).long()[None].to(dev),
            torch.from_numpy(mask).to(torch.int32)[None].to(dev))


def tp_decode_run(params, config, ids, mask, new_tokens):
    """Greedy decode of the prompt on this rank's tp group (one process
    without one): (tokens (new_tokens,), the prefill's whole last-position
    logits (1, 1, V) on the host)."""
    import torch

    from ecg_byte_tpu_torch.infer import greedy_generate
    from ecg_byte_tpu_torch.models import transformer as T

    tokens = greedy_generate(params, config, ids, mask, max_new_tokens=new_tokens,
                             eos_token_id=-1, pad_token_id=0)[0]
    with torch.inference_mode():
        cache = T.init_kv_cache(config, 1, ids.shape[1], ids.device)
        logits, _, _ = T.prefill(params, config, ids, mask, cache)
        logits = T.gather_vocab(logits, config.vocab_size)
    return tokens.cpu(), logits[None].float().cpu()


def grid_rank(roots, g, dev="cuda"):
    """One rank of phase 19's harness (four ranks).  On T = 2 x F = 2: the
    main path's step at B x 1024 and at B1 x 4096 (:func:`grid_lm_run`) at
    ``g.layers`` layers, the kernels each launched; on the card the step's
    ms (CUDA events) and the ms of its tp, fsdp and data-group collectives
    (one step's, :func:`recorded_collectives`, replayed alone).  Then on T
    = 2 (dp 2 x tp 2) greedy decode of the serving prompt at
    ``g.decode_layers`` layers (:func:`tp_decode_run`), with its launches.  ``roots``: ((root,
    vocab, merges) of the 1,024 and of the 4,096-token data).  ``dev="cpu"``:
    the checks alone, for a rehearsal."""
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.parallel import Rows, distributed, mesh, sharding
    from ecg_byte_tpu_torch.parallel.batches import shard_rows
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
        shard_train_state,
    )

    timed = dev == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if timed else torch.device(dev)
    out = {"rank": distributed.rank(), "seconds": {}}
    t0 = time.perf_counter()
    grid = mesh.init(GRID_TP, GRID_FSDP)
    for key, (root, vocab, merges), n, pad in (("lm", roots[0], g.batch, g.pad_to_max),
                                               ("long", roots[1], 1, g.long_pad_to_max)):
        params, config, lora, batch = _grid_model(root, vocab, merges, g, dev, g.layers, n, pad)
        before = launches()
        out[key] = grid_lm_run(params, config, lora, batch)
        out[f"{key}_launches"] = {k: v - before[k] for k, v in launches().items()}
        if timed and key == "lm":
            opt = make_optimizer(config.hidden_size, 500)
            state = create_train_state(config, opt, torch.Generator(device=dev), peft=True,
                                       params=params, lora=_map_tree(lambda t: t.clone(), lora))
            state = shard_train_state(state, opt)
            step, gen = make_train_step(config, opt), torch.Generator().manual_seed(0)
            rows = Rows.stride(n, grid.data_world, grid.data_rank)
            local, n_valid = shard_rows(batch, rows), int((batch["labels"][:, 1:] != -100).sum())
            log = []
            with recorded_collectives(log):  # the warm-up step
                step(state, local, gen, rows, n_valid)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(2):
                step(state, local, gen, rows, n_valid)
            end.record()
            torch.cuda.synchronize()
            out["step_ms"] = start.elapsed_time(end) / 2
            kinds = {id(grid.tp_group): "tp", id(grid.fsdp_group): "fsdp",
                     id(grid.data_group): "data", id(grid.dp_group): "data"}
            out["collectives"] = replay_collectives(log, lambda grp: kinds.get(id(grp), "host"),
                                                    repeats=1)
            del state
        del params, lora, batch
        if timed:
            torch.cuda.empty_cache()
        out["seconds"][key] = time.perf_counter() - t0
    mesh.reset()
    mesh.init(GRID_TP, 1)  # dp 2 x tp 2: each tp group decodes the prompt
    root, vocab, merges = roots[0]
    params, config, tok = build_model(g.llm, vocab, dev)
    params, config = cut_depth(params, config, g.decode_layers)
    params = sharding.shard_tree(params, sharding.param_splits(params))
    ids, mask = _tp_prompt(root, vocab, merges, tok, dev)
    before = launches()
    out["decode"] = tp_decode_run(params, config, ids, mask, g.new_tokens)
    out["decode_launches"] = {k: v - before[k] for k, v in launches().items()}
    out["decode_cache_heads"] = config.num_kv_heads // mesh.tp_size()
    out["seconds"]["decode"] = time.perf_counter() - t0
    return out


def grid_phase(root, vocab, merges, long, g=GRID, dev="cuda"):
    """Phase 19: ``--tp`` and ``--fsdp`` on the card, the ranks sharing it
    over gloo.  ``cli.main --dis --gpus 0,0 --tp 2`` and ``--fsdp 2``, each
    with exact launch counts per rank (:func:`check_dis_ranks`), its
    checkpoint the whole tree in the one-process shapes, served by
    ``cli.main --inference``; the four-rank harness (:func:`grid_rank`)
    whose steps are held to one process and f32 by
    :func:`hold_train_paths`, and whose tp decode is held by
    :func:`hold_logits` and :func:`check_tp_stream`.  The one-process tree
    is phase 17's W = 1 checkpoint, in the same run directory.  ``long``:
    (root, vocab, merges) of the 4,096-token data.  Returns the launch
    counts by path and the numbers.  (``dev="cpu"`` with a tiny ``Grid`` rehearses it
    on the CPU, with ``N_TRAIN``, ``N_VAL``, ``_cli_args``,
    ``check_launch_counts``, ``hold_train_paths``, ``hold_logits`` and
    ``serve_phase`` patched.)"""
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli.common import _PRESETS, build_model
    from ecg_byte_tpu_torch.models.lora import leaves
    from ecg_byte_tpu_torch.parallel.spawn import spawn

    phase(f"19. --tp / --fsdp: cli.main --dis --gpus 0,0 at --tp 2 and at --fsdp 2, B{g.batch} x "
          f"{g.pad_to_max + 4}; a T = {GRID_TP} x F = {GRID_FSDP} harness at {g.layers} layers "
          f"(B{g.batch} x {g.pad_to_max + 4}, B1 x {g.long_pad_to_max + 4}); tp decode at "
          f"{g.decode_layers} layers, {g.new_tokens} tokens")
    t_phase = time.perf_counter()
    cpu = dev == "cpu"
    extra = ["--device", "cpu"] if cpu else []
    L = _PRESETS[g.llm]().num_layers
    n_train, n_val = (max(1, int(n * 0.25)) for n in (N_TRAIN, N_VAL))  # --toy
    numbers, by_path = {}, {}
    main_args = _cli_args() + ["--model", g.llm, "--peft", "--dev", "--toy", "--batch_size",
                               str(g.batch), "--pad_to_max", str(g.pad_to_max)]
    args = cli_main.get_args(main_args)
    args.epochs = 2  # --dev, as cli.main.run sets it
    best = os.path.join(root, cli_main.make_run_dir(args), "best_model.pt")
    one = torch.load(best, map_location="cpu", weights_only=True)["state"]
    shapes = {name: [tuple(t.shape) for t in leaves(one[name])] for name in ("trainable", "base")}
    del one
    for key, flags, replay in (("grid_tp", ["--tp", "2"], False),
                               ("grid_fsdp", ["--fsdp", "2"], True)):
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.chdir(root):
            out = cli_main.main(main_args + ["--dis", "--gpus", "0,0", "--ports", "0"] + flags
                                + extra)
        wall = time.perf_counter() - t0
        assert launches() == dict.fromkeys(SOURCES, 0), "this process launched a kernel"
        assert [r["backend"] for r in out["ranks"]] == ["gloo"] * 2, out["ranks"]
        # every rank takes every step (T = 2: the same rows; F = 2: a rank
        # without rows runs a row no loss counts)
        want = {**dis_train_counts(L, rank_steps(n_train, g.batch, 1, 0),
                                   rank_steps(n_val, g.batch, 1, 0), replay=replay),
                "bpe_match": 2, "bpe_chain": 2}
        check_dis_ranks(out, [want] * 2, f"cli.main --dis {' '.join(flags)}")
        s = out["training"]
        numbers[f"{key}_ms_per_step_host"] = s["seconds"] / s["steps"] * 1e3
        print(f"{key}: {s['steps']} steps, train loss {s['train_loss']}, val loss "
              f"{s['val_loss']}; launches {[r['launches'] for r in out['ranks']]}; written "
              f"{[r['written'] for r in out['ranks']]}; "
              f"{numbers[f'{key}_ms_per_step_host']:.1f} ms a step with its data and evaluation "
              f"(host clock); wall {wall:.1f} s")
        by_path[key] = {k: sum(r["launches"][k] for r in out["ranks"]) for k in SOURCES}
        saved = torch.load(os.path.join(root, out["training"]["directory"], "best_model.pt"),
                           map_location="cpu", weights_only=True)["state"]
        got = {name: [tuple(t.shape) for t in leaves(saved[name])] for name in ("trainable", "base")}
        assert got == shapes, f"{key}: the checkpoint is not the one-process tree"
        del saved
        serve = dataclasses.replace(SERVE_GRID, key=f"serve_{key}",
                                    serve_title=f"19. serve {key}'s checkpoint")
        by_path[serve.key], numbers[f"serve_{key}_ms_per_token"] = serve_phase(
            root, os.path.basename(out["training"]["directory"]), serve)

    # the four-rank harness, against one process and f32
    t0 = time.perf_counter()
    roots = ((root, vocab, merges), long)
    harness = spawn(grid_rank, (roots, g, dev), world=GRID_TP * GRID_FSDP,
                    devices=None if cpu else [0] * (GRID_TP * GRID_FSDP), timeout_s=600)
    print(f"harness: {len(harness)} ranks (gloo) in {time.perf_counter() - t0:.1f} s; rank 0's "
          f"clock at the end of each part: {harness[0]['seconds']}")
    for r in harness:
        for key, kernels in (("lm", ("prefill_attention", "prefill_attention_bwd", "rmsnorm",
                                      "rmsnorm_bwd")),
                             ("long", ("flash_attention", "flash_attention_bwd", "rmsnorm",
                                       "rmsnorm_bwd")),
                             ("decode", ("prefill_attention", "decode_attention", "rmsnorm"))):
            counts = r[f"{key}_launches"]
            if not cpu:
                assert all(counts[k] > 0 for k in kernels), (r["rank"], key, counts)
        # greedy_generate's prefill and new_tokens - 1 steps, and the prefill
        # whose logits are held
        ld = min(g.decode_layers, L)
        want = {"prefill_attention": 2 * ld, "decode_attention": ld * (g.new_tokens - 1),
                "rmsnorm": (2 * ld + 1) * (g.new_tokens + 1)}
        check_launch_counts(r["decode_launches"], want, f"tp decode, rank {r['rank']}")
        by_path.setdefault("grid_harness", dict.fromkeys(SOURCES, 0))
        for key in ("lm_launches", "long_launches", "decode_launches"):
            for k in SOURCES:
                by_path["grid_harness"][k] += r[key][k]
        assert r["decode_cache_heads"] == _PRESETS[g.llm]().num_kv_heads // GRID_TP
        if "step_ms" in r:
            numbers[f"harness_rank{r['rank']}_step_ms"] = r["step_ms"]
            col = r["collectives"]
            for kind, (ms, n) in col.items():
                numbers[f"harness_rank{r['rank']}_{kind}_ms"] = ms
            print(f"T = {GRID_TP} x F = {GRID_FSDP} train step B{g.batch} x {g.pad_to_max + 4}, "
                  f"{g.layers} layers, rank {r['rank']}: {r['step_ms']:.2f} ms (CUDA events); its "
                  "collectives replayed alone: " + ", ".join(
                      f"{kind} {ms:.2f} ms ({n} calls, {100 * ms / r['step_ms']:.1f}%)"
                      for kind, (ms, n) in col.items()))
    for key, (data, pad, n) in (("lm", ((root, vocab, merges), g.pad_to_max, g.batch)),
                                ("long", (long, g.long_pad_to_max, 1))):
        params, config, lora, batch = _grid_model(*data, g, torch.device(dev), g.layers, n, pad)
        one = grid_lm_run(params, config, lora, batch)
        with plain_path():
            f32 = lambda t: t.float()  # noqa: E731
            ref = grid_lm_run(_map_tree(f32, params), config.replace(dtype="float32"),
                              _map_tree(f32, lora), batch)
        del params, lora, batch
        if not cpu:
            torch.cuda.empty_cache()

        def flat(res):
            rows = sorted(res[1], key=lambda x: x[0])
            return (res[0], torch.cat([x[1] for x in rows]), torch.cat([x[2] for x in rows]),
                    res[2])

        assert all(r[key][0] == harness[0][key][0] for r in harness), [r[key][0] for r in harness]
        kern = (harness[0][key][0], *(torch.cat([x[j] for x in sorted(
            [c for r in harness if r["rank"] % GRID_TP == 0 for c in r[key][1]],
            key=lambda c: c[0])]) for j in (1, 2)), harness[0][key][2])
        one, ref = flat(one), flat(ref)
        print(f"{key} step: T = {GRID_TP} x F = {GRID_FSDP} loss {kern[0]:.6f}, one process "
              f"{one[0]:.6f}, f32 {ref[0]:.6f}; against one process: " + ", ".join(
                  f"{k} {(torch.linalg.vector_norm(kern[3][k] - one[3][k]) / torch.linalg.vector_norm(one[3][k])).item():.2e}"
                  for k in one[3]))
        print("errors against f32 (the grid in the kernel path's place / one process):")
        hold_train_paths([kern], [one], [ref])

    print(f"the one-process and f32 steps held, {time.perf_counter() - t_phase:.1f} s into "
          "the phase")
    # tp decode against one process: the prefill logits and the streams
    params, config, tok = build_model(g.llm, vocab, torch.device(dev))
    params, config = cut_depth(params, config, g.decode_layers)
    ids, mask = _tp_prompt(root, vocab, merges, tok, torch.device(dev))
    one_tokens, one_logits = tp_decode_run(params, config, ids, mask, g.new_tokens)
    with plain_path():
        f32 = lambda t: t.float()  # noqa: E731
        params32 = _map_tree(f32, params)
        _, ref_logits = tp_decode_run(params32, config.replace(dtype="float32"), ids, mask, 1)
        del params32
    margins = teacher_margins(params, config, ids, mask, one_tokens)
    del params
    bound = 2 * (one_logits - ref_logits).abs().max().item()
    for r in harness:
        tokens, logits = r["decode"]
        print(f"tp decode, rank {r['rank']}: prompt {ids.shape[1]} tokens, tokens "
              f"{tokens.tolist()}; one process {one_tokens.tolist()}")
        hold_logits(logits, one_logits, ref_logits)
        check_tp_stream(tokens, one_tokens, margins, bound)
    numbers["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {json.dumps(numbers)}; phase wall {numbers['wall_s']:.1f} s")
    return by_path, numbers


def teacher_margins(params, config, ids, mask, tokens):
    """One process's top-2 logit margin at each step of its greedy
    ``tokens`` on the prompt (prefill, then each token fed back)."""
    return top2_margins(teacher_logits(params, config, ids, mask, tokens))


def top2_margins(logits):
    """The top-2 margin of each row of (steps, V) logits."""
    top = logits.topk(2, -1).values
    return (top[:, 0] - top[:, 1]).tolist()


def teacher_logits(params, config, ids, mask, tokens, cache_dtype=None):
    """The f32 logits (len(tokens), V) on the host of the prompt (prefill)
    and of each of ``tokens`` but the last fed back (decode steps), with a
    KV cache of ``cache_dtype`` (None: the model's)."""
    import torch

    from ecg_byte_tpu_torch.models import transformer as T

    s, n = ids.shape[1], len(tokens)
    dev = ids.device
    with torch.inference_mode():
        cache = T.init_kv_cache(config, 1, s + n, dev, dtype=cache_dtype)
        logits, cache, pos = T.prefill(params, config, ids, mask, cache)
        out = [logits]
        cache_mask = torch.cat([mask, torch.zeros(1, n, dtype=torch.int32, device=dev)], 1)
        pos = pos.to(torch.int32)
        for k in range(n - 1):
            cache_mask[:, s + k] = 1
            logits, cache = T.decode_step(params, config, tokens[k:k + 1].to(dev), pos, s + k,
                                          cache, cache_mask)
            out.append(logits)
            pos = pos + 1
    return torch.stack(out)[:, 0].float().cpu()


SERVE_GRID = ServePath(
    "serve_grid", "19. serve: cli.main --inference --peft --toy on a grid's checkpoint",
    "", ("--toy",), NUM_MERGES, {"prefill_attention": LAYERS}, {"decode_attention": LAYERS},
    NORMS, records=max(1, int(N_TEST * 0.25)), min_prompt=1024)


# ------------------------------------------- phase 20: norm-folded, and profiled


@dataclasses.dataclass(frozen=True)
class Fold:
    """The sizes of phase 20: full width on the card (the defaults), tiny for
    a rehearsal on the CPU."""

    model: str = MODEL
    batch: int = 4  # the LoRA step at B4 x 1024, phase 6's shape
    pad_to_max: int = 1020
    new_tokens: int = 32  # each greedy stream
    # the norm weights moved off 1 by this times N(0, 1), as
    # tests/test_norm_fold.py:_setup moves them (a fold by 1 moves nothing)
    norm_shift: float = 0.3


FOLD = Fold()


def off_one_norms(params, seed, shift):
    """``params`` with every RMSNorm weight plus ``shift`` N(0, 1) draws
    (a generator seeded with ``seed`` on the weights' device)."""
    import torch

    gen = torch.Generator(device=params["final_norm"].device).manual_seed(seed)

    def moved(w):
        return (w.float() + shift * torch.randn(w.shape, generator=gen, device=w.device)).to(
            w.dtype)

    layers = [{**layer, "attn_norm": moved(layer["attn_norm"]),
               "mlp_norm": moved(layer["mlp_norm"])} for layer in params["layers"]]
    return {**params, "layers": layers, "final_norm": moved(params["final_norm"])}


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def check_forced_argmax(logits, tokens, margins, bound, what):
    """Teacher-forced on the reference's greedy ``tokens``, (steps, V)
    ``logits`` of another path: at each step its argmax is the reference's
    token, or the reference's top-2 margin there (``margins[k]``) is within
    ``bound``, the logits' own error.  Returns the steps where they
    differ."""
    got = logits.argmax(-1).tolist()
    differ = [k for k, (a, b) in enumerate(zip(got, tokens)) if a != int(b)]
    wide = [(k, margins[k]) for k in differ if margins[k] > bound]
    assert not wide, f"{what}: argmax differs at (step, margin) {wide}, wider than {bound:.4e}"
    return differ


# phase 20b: the folded tree's served logits no further from the folded
# tree in f32 than this times the classic tree's from the classic tree in
# f32 (the rule of phases 5 and 9 for a kernel path against its plain one)
FOLD_LOGITS_RATIO = 1.25


def hold_folded_logits(kern, ref, ratio, what):
    """Teacher-forced (steps, V) logits of a served path (``kern[tree]``)
    and of the same tree in f32 on the plain versions (``ref[tree]``), for
    the classic and the folded tree, on one stream.  Distances are the
    largest over the steps of max|d|/max|ref|.  Held: (i) the folded path
    no further from its tree in f32 than ``ratio`` x the classic path from
    its; (ii) the fold itself, the folded tree in f32 against the classic
    tree in f32, within 1.25x the classic path's distance (the fold's bf16
    weights move the function less than the served arithmetic does).
    Returns the distances and the classic path's largest |d| from f32 in
    the prefill's row."""
    import torch

    def dist(a, b):
        return step_errors(a[:, None], b[:, None]).max().item()

    assert all(torch.isfinite(x).all() for x in (*kern.values(), *ref.values()))
    d = {"classic_vs_f32": dist(kern["classic"], ref["classic"]),
         "folded_vs_f32": dist(kern["folded"], ref["folded"]),
         "fold_in_f32": dist(ref["folded"], ref["classic"]),
         "folded_vs_classic_f32": dist(kern["folded"], ref["classic"]),
         "classic_prefill_abs": (kern["classic"][0] - ref["classic"][0]).abs().max().item()}
    c = max(d["classic_vs_f32"], 1e-30)
    print(f"{what}: {len(kern['classic'])} teacher-forced rows, worst max|d|/max|f32|: classic "
          f"path vs classic f32 {d['classic_vs_f32']:.3e}; folded path vs folded f32 "
          f"{d['folded_vs_f32']:.3e} (ratio {d['folded_vs_f32'] / c:.3f}, held <= {ratio}); "
          f"folded f32 vs classic f32 {d['fold_in_f32']:.3e} (ratio {d['fold_in_f32'] / c:.3f}, "
          f"held <= 1.25); folded path vs classic f32 {d['folded_vs_classic_f32']:.3e} (ratio "
          f"{d['folded_vs_classic_f32'] / c:.3f}, printed)")
    assert d["folded_vs_f32"] <= ratio * d["classic_vs_f32"], \
        f"{what}: the folded path further from its f32 tree than {ratio}x the classic path"
    assert d["fold_in_f32"] <= 1.25 * d["classic_vs_f32"], \
        f"{what}: the fold moves the f32 logits more than 1.25x the classic path's error"
    return d


def check_folded_counts(folded, classic, per_norm, what):
    """A folded path launches what the classic path launches, but RMSNorm:
    ``per_norm`` (kernel -> (folded, classic)) exactly."""
    for name, n in classic.items():
        want = per_norm[name] if name in per_norm else (n, n)
        assert (folded[name], n) == want, \
            f"{what}: {name} launched {folded[name]} folded and {n} classic times, expected {want}"


def fold_phase(root, vocab, merges, f=FOLD, dev="cuda"):
    """Phase 20: the norm-folded path (``transformer.fold_norm_scales``) on
    the card.  (a) One LoRA step at B4 x 1024 on the folded tree and on the
    classic one, both on the kernels: RMSNorm once a forward and once a
    backward on the folded tree (2L + 1 and 2L on the classic one), every
    other kernel as often.  :func:`hold_train_paths` holds (i) the folded
    step on the kernels to its plain versions and the folded tree in f32
    (the rule of phases 7 and 13 on the loss, the labelled and the valid
    positions and every LoRA group), and (ii) the folded tree in f32 to the classic tree
    in f32, within 1.25x of the classic kernel path's distance from it: the
    fold's bf16 weights move the function less than bf16 arithmetic does.
    (iii) The folded kernel path's distance from the classic tree in f32
    over the classic kernel path's is printed, not held: the fold rounds
    w W to bf16 and JAX's order rounds each product, the row scale and
    their product to bf16, so it exceeds 1.25 (ROADMAP.md, limits of the
    checks).  Then each train step timed, in turns.  (b) Greedy decode of
    the first test record (the serving bucket) on both trees, bf16 and the
    int8 copy with the int8 KV cache.  Teacher-forced on the classic
    stream (the prefill and each fed-back token), each tree's served
    logits against the same tree in f32 on the plain versions
    (:func:`hold_folded_logits`): the folded path within
    ``FOLD_LOGITS_RATIO`` x the classic path's distance, and the folded
    tree in f32 within 1.25x of it from the classic tree in f32.  Each
    folded stream equals the classic one, or parts where the classic
    tree's top-2 margin is within twice its prefill logits' largest error
    (:func:`check_tp_stream`, phase 19's rule), and teacher-forced the
    folded tree's argmax differs only at such steps
    (:func:`check_forced_argmax`).  Returns the launch counts by path and
    the numbers.  (``dev="cpu"`` with a tiny ``Fold`` rehearses
    it on the CPU, with ``hold_train_paths`` patched.)"""
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.infer import greedy_generate
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.models.quantized import quantize_lm_int8
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import (
        _batch_tensors,
        create_train_state,
        make_train_step,
    )

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    s = f.pad_to_max + 4
    phase(f"20. norm-folded: a LoRA step at B{f.batch} x {s} and greedy decode (bf16, int8) on "
          "fold_norm_scales' tree against the classic tree")
    if cuda:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    params, config, tok = build_model(f.model, vocab, dev)
    params = off_one_norms(params, 0, f.norm_shift)
    fparams, fconfig = T.fold_norm_scales(params, config)
    L = config.num_layers
    assert fconfig.norm_folded and config.tie_word_embeddings  # Llama-3.2-1B keeps final_norm
    by_path, numbers = {}, {}

    # (a) the LoRA step
    batch = _batch_tensors(_training_items(root, vocab, merges, tok, f.batch, f.pad_to_max), dev)
    assert batch["input_ids"].shape == (f.batch, s), batch["input_ids"].shape
    lora = random_lora(config, 2, dev)
    zero_launches()
    folded, by_path["fold_train"] = lora_loss_and_grads(fparams, lora, fconfig, batch)
    classic, by_path["fold_train_classic"] = lora_loss_and_grads(params, lora, config, batch)
    refs = {}
    with plain_path():
        folded_plain, _ = lora_loss_and_grads(fparams, lora, fconfig, batch)
        f32 = lambda t: t.float()  # noqa: E731
        for key, (p, c) in (("folded", (fparams, fconfig)), ("classic", (params, config))):
            p32 = _map_tree(f32, p)
            refs[key], _ = lora_loss_and_grads(p32, _map_tree(f32, lora),
                                               c.replace(dtype="float32"), batch)
            del p32
    per_norm = {"rmsnorm": (1, 2 * L + 1), "rmsnorm_bwd": (1, 2 * L)} if cuda else {}
    check_folded_counts(by_path["fold_train"], by_path["fold_train_classic"], per_norm,
                        "20a LoRA step")
    print(f"20a: the LoRA step at B{f.batch} x {s}, launches folded "
          f"{_nonzero(by_path['fold_train'])}, classic {_nonzero(by_path['fold_train_classic'])}")
    # the rule of phases 7 and 13 on the loss, the cross entropy pooled at
    # the labelled and at the valid positions and every LoRA group
    print("20a (i) the folded step on the kernels and on the plain versions, against the "
          "folded tree in f32 (the rule of phases 7 and 13 on the folded tree):")
    hold_train_paths([folded], [folded_plain], [refs["folded"]])
    print("20a (ii) the fold itself: the folded tree in f32 in the kernel path's place, against "
          "the classic tree in f32, beside the classic kernel path (the fold's bf16 weights move "
          "the function less than bf16 arithmetic does):")
    hold_train_paths([refs["folded"]], [classic], [refs["classic"]])
    ratios = path_error_ratios(folded, classic, refs["classic"])
    numbers["folded_vs_classic_error_ratios"] = ratios
    print("20a (iii) the folded step on the kernels against the classic tree in f32, over the "
          "classic kernel path's distance (not held: the fold rounds w W to bf16 and scales each "
          "product in bf16 after its rounding): " + ", ".join(
              f"{k} {v:.3f}" for k, v in ratios.items()))
    del folded, folded_plain, classic, refs
    if cuda:
        optimizer = make_optimizer(config.hidden_size, 500)
        trees = {"classic": (params, config), "folded": (fparams, fconfig)}
        ms = {}
        for key in ("classic", "folded", "folded", "classic"):
            p, c = trees[key]
            torch.cuda.empty_cache()  # each turn from the same allocator state
            state = create_train_state(c, optimizer, torch.Generator(device=dev).manual_seed(0),
                                       peft=True, params=p)
            _, step_ms, _ = time_train_step(make_train_step(c, optimizer), state, batch,
                                            torch.Generator().manual_seed(1), key)
            ms.setdefault(key, []).append(step_ms)
            del state
        for key, v in ms.items():
            numbers[f"train_{key}_ms"] = sum(v) / len(v)
            numbers[f"train_{key}_ms_turns"] = v
        print(f"20a train step B{f.batch} x {s} (CUDA events, in turns classic, folded, folded, "
              f"classic): folded {ms['folded']} ms, classic {ms['classic']} "
              f"ms; means {numbers['train_folded_ms']:.2f} and {numbers['train_classic_ms']:.2f}")
    del batch, lora

    # (b) greedy decode, bf16 and the int8 copy
    ids, mask = _tp_prompt(root, vocab, merges, tok, dev)
    for key, int8 in (("bf16", False), ("int8", True)):
        trees = {"classic": (params, config), "folded": (fparams, fconfig)}
        if int8:
            trees = {k: (quantize_lm_int8(p, c), c) for k, (p, c) in trees.items()}
        out = {}
        for name, (p, c) in trees.items():
            zero_launches()
            stats = {}
            tokens = greedy_generate(p, c, ids, mask, max_new_tokens=f.new_tokens,
                                     eos_token_id=-1, pad_token_id=0, int8_kv=int8,
                                     stats=stats)[0].cpu()
            by_path[f"fold_serve_{key}" + ("" if name == "folded" else "_classic")] = launches()
            out[name] = (tokens, stats)
        per_norm = {"rmsnorm": (f.new_tokens, (2 * L + 1) * f.new_tokens)} if cuda else {}
        check_folded_counts(by_path[f"fold_serve_{key}"], by_path[f"fold_serve_{key}_classic"],
                            per_norm, f"20b greedy decode, {key}")
        # both trees teacher-forced on the classic tree's stream: row 0 the prefill
        classic_tokens = out["classic"][0]
        forced = {name: teacher_logits(p, c, ids, mask, classic_tokens,
                                       cache_dtype=torch.int8 if int8 else None)
                  for name, (p, c) in trees.items()}
        assert forced["classic"].argmax(-1).tolist() == classic_tokens.tolist()
        # each tree in f32 (its bf16 weights in f32, an f32 cache) on the
        # plain versions over the same stream
        with plain_path():
            ref = {}
            for name, (p, c) in (("classic", (params, config)), ("folded", (fparams, fconfig))):
                p32 = _map_tree(lambda t: t.float(), p)
                ref[name] = teacher_logits(p32, c.replace(dtype="float32"), ids, mask,
                                           classic_tokens)
                del p32
        d = hold_folded_logits(forced, ref, FOLD_LOGITS_RATIO, f"20b {key}")
        numbers.update({f"decode_{key}_{k}": v for k, v in d.items()})
        margins = top2_margins(forced["classic"])
        bound = 2 * d["classic_prefill_abs"]
        print(f"20b {key}: prompt {ids.shape[1]} tokens; streams folded "
              f"{out['folded'][0].tolist()}, classic {classic_tokens.tolist()}; the classic "
              f"tree's top-2 margins {[round(m, 4) for m in margins]}")
        parted = check_tp_stream(out["folded"][0], classic_tokens, margins, bound,
                                 ("folded", "the classic tree"))
        differ = check_forced_argmax(forced["folded"], classic_tokens, margins, bound,
                                     f"20b {key}, the folded tree teacher-forced")
        print(f"20b {key}: teacher-forced on the classic stream, the folded tree's argmax "
              f"differs at steps {differ} of {len(classic_tokens)}, each where the classic "
              f"tree's top-2 margin is within the bound {bound:.4e}")
        numbers[f"decode_{key}_forced_differ"] = len(differ)
        for name, (_, st) in out.items():
            numbers[f"decode_{key}_{name}_ms_per_token"] = (
                1e3 * st["decode_s"] / max(st["decode_steps"], 1))
        numbers[f"decode_{key}_parted_at"] = parted
        print(f"20b {key} decode (host clock): folded "
              f"{numbers[f'decode_{key}_folded_ms_per_token']:.3f} ms/token, classic "
              f"{numbers[f'decode_{key}_classic_ms_per_token']:.3f}; launches folded "
              f"{_nonzero(by_path[f'fold_serve_{key}'])}, classic "
              f"{_nonzero(by_path[f'fold_serve_{key}_classic'])}")
    numbers["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 20: {json.dumps(numbers)}; phase wall {numbers['wall_s']:.1f} s")
    return by_path, numbers


def _recorded_calls(name, calls):
    """A stand-in for the kernel ``name``'s plain version that keeps a copy
    of each call's arguments in ``calls``."""
    plain = {"prefill_attention": _plain_attention, "rmsnorm": _plain_rmsnorm}[name]

    def call(*args):
        calls.append(tuple(a.detach().clone() if hasattr(a, "detach") else a for a in args))
        return plain(*args)
    return call


def _plain_attention(qg, k, v, mask):
    from ecg_byte_tpu_torch.ops.attention import grouped_attention

    return grouped_attention(qg, k, v, mask)


def _reordered_attention(qg, k, v, mask):
    """The plain attention with each q.k summed over the head dimension in
    reverse order: as exact as the plain version, its f32 sums rounded
    otherwise, so a few probabilities round to the other bf16 neighbour."""
    return _plain_attention(qg.flip(-1), k.flip(-1), v, mask).contiguous()


def _emulated_attention(qg, k, v, mask, *, online=True, tile=64, tensor_cores=False):
    """The plain attention with the resident kernel's softmax arithmetic in
    PyTorch: p = 2^((s - m) log2 e) x (1 / l), and with ``online`` the row
    sum l as the kernel's first pass forms it, over ``tile`` keys at a time
    rescaled by 2^((m_old - m_new) log2 e) as the running max m steps
    (without, the sum of the final terms).  With ``tensor_cores`` q.k and
    P.V too as the kernel takes them, bf16 products with f32 accumulators on
    the tensor cores (cuBLAS)."""
    import torch

    ct, log2e = torch.float32, 1.4426950408889634
    b, s, kh, g, d = qg.shape
    if tensor_cores:
        logits = _tensor_core_scores(qg, k)
    else:
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(ct), k.to(ct)) * d**-0.5
    ok = torch.ones((s, s), dtype=torch.bool, device=qg.device).tril()
    ok = ok & mask[:, None, None, None, :].bool()
    logits = logits.masked_fill(~ok, -1e30)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp2((logits - m) * log2e)
    if online:
        run_m = torch.full_like(m, -1e30)
        l = torch.zeros_like(m)
        for t0 in range(0, s, tile):
            part = logits[..., t0:t0 + tile]
            m_new = torch.maximum(run_m, part.amax(-1, keepdim=True))
            l = l * torch.exp2((run_m - m_new) * log2e) + torch.exp2(
                (part - m_new) * log2e).sum(-1, keepdim=True)
            run_m = m_new
    else:
        l = e.sum(-1, keepdim=True)
    p = (e * (1 / l)).to(qg.dtype)
    if tensor_cores:
        return torch.einsum("bkgqs,bskd->bqkgd", p, v).contiguous()
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(ct), v.to(ct))
    return out.to(qg.dtype).contiguous()


def _tensor_core_pv(qg, k, v, mask):
    """The plain attention with P.V as a bf16 product on the tensor cores
    (cuBLAS, f32 accumulators, bf16 out) in place of the f32 product."""
    import torch

    from ecg_byte_tpu_torch.ops.attention import grouped_probs

    return torch.einsum("bkgqs,bskd->bqkgd", grouped_probs(qg, k, mask), v).contiguous()


def _tensor_core_logits(q, k):
    """q . k^T of bf16 batches (N, M, D) and (N, T, D) as cuBLAS's bf16
    product with f32 output: the tensor cores with f32 accumulators, never
    rounded to bf16."""
    import torch

    return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)


def tensor_core_logits_missing(dev):
    """None where this torch computes :func:`_tensor_core_logits` on
    ``dev``, else why not (the CPU backend has no such product)."""
    import torch

    x = torch.zeros(1, 16, 16, dtype=torch.bfloat16, device=dev)
    try:
        _tensor_core_logits(x, x)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return None


def _tensor_core_scores(qg, k):
    """The scaled (B, KH, G, S, S) logits of attention from
    :func:`_tensor_core_logits` over (batch row, KV head) batches."""
    b, s, kh, g, d = qg.shape
    q2 = qg.permute(0, 2, 3, 1, 4).reshape(b * kh, g * s, d)
    k2 = k.permute(0, 2, 1, 3).reshape(b * kh, s, d)
    return _tensor_core_logits(q2, k2).view(b, kh, g, s, s) * d**-0.5


def _tensor_core_qk(qg, k, v, mask):
    """The plain attention with its logits from :func:`_tensor_core_scores`,
    masked and softmaxed as ``grouped_probs`` does, and P.V as the plain
    version."""
    import torch

    from ecg_byte_tpu_torch.ops.attention import masked_probs

    probs = masked_probs(_tensor_core_scores(qg, k), mask, qg.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.to(qg.dtype).contiguous()


def _plain_rmsnorm(x, w, eps):
    from ecg_byte_tpu_torch.ops.rmsnorm import rmsnorm_plain

    return rmsnorm_plain(x, w, eps)


TENSOR_CORE_QK = "q.k on the tensor cores"
KERNEL_EMULATED = "kernel softmax, q.k and P.V on the tensor cores"
# attention without a kernel, each as exact as the plain version per call:
# its q.k sums reordered; the kernel's softmax arithmetic with the final
# row sum; the kernel's softmax arithmetic with its first pass's row sum;
# P.V accumulated on the tensor cores; q.k on the tensor cores (cuBLAS,
# f32 out), the rest plain; the kernel's softmax with both products on the
# tensor cores
_ATTENTION_WITNESSES = {
    "reordered": _reordered_attention,
    "kernel softmax, exact sum": functools.partial(_emulated_attention, online=False),
    "kernel softmax, online sum": _emulated_attention,
    "P.V on the tensor cores": _tensor_core_pv,
    TENSOR_CORE_QK: _tensor_core_qk,
    KERNEL_EMULATED: functools.partial(_emulated_attention, tensor_cores=True),
}
# the witnesses that need torch.bmm(..., out_dtype=) on the card
_CARD_WITNESSES = (TENSOR_CORE_QK, KERNEL_EMULATED)


def _forward_variant(variant):
    def call(qg, k, v, mask):
        from ecg_byte_tpu_torch.ops.attention_resident import resident_attention_dot

        return resident_attention_dot(qg, k, v, mask, variant)
    return call


# the ways of csrc/attention_bwd_tc.cuh to sum the score product
# (attention_resident.SCORE_DOTS), and the resident forward kernel with its
# arithmetic changed (attention_resident.FORWARD_VARIANTS): launched by
# --blame alone, counted by resident_attention_dot.launches
SCORE_DOTS = ("chain", "split", "fma")
FORWARD_VARIANTS = ("chain scores", "split scores", "fma scores", "fma scores, fma P.V, expf")
_FORWARD_VARIANTS = {f"kernel, {v}": _forward_variant(v) for v in FORWARD_VARIANTS}


def _pad_rows_from(valid_fn, pad_fn):
    """Attention with ``valid_fn``'s output at the valid query rows and
    ``pad_fn``'s at the left-pad rows (every key of such a row masked)."""
    def call(qg, k, v, mask):
        import torch

        pad = ~mask.bool()[:, :, None, None, None]
        return torch.where(pad, pad_fn(qg, k, v, mask), valid_fn(qg, k, v, mask)).contiguous()
    return call


# the kernel and plain with their left-pad rows swapped; the kernel is its
# chain-scores variant, the main path's arithmetic bit for bit, whose wrapper
# the step's patch of resident_attention leaves alone
_PAD_ROW_SWAPS = {
    "plain, its left-pad rows from the kernel": _pad_rows_from(
        _plain_attention, _forward_variant("chain scores")),
    "the kernel, its left-pad rows from plain": _pad_rows_from(
        _forward_variant("chain scores"), _plain_attention),
}


def per_call_errors(name, calls):
    """For each recorded call of the forward kernel ``name``: the kernel's
    and the plain version's distance from the same call in f64 over the
    rows of valid positions, |d|/|f64|, the kernel's from the plain
    version's, and the share of output elements where the two differ; a
    witness of ``_ATTENTION_WITNESSES`` or a variant of
    ``_FORWARD_VARIANTS`` in the kernel's place, with the share where it
    differs from the kernel: [(kernel, plain, kernel vs plain, share, share
    vs the kernel)]."""
    import torch

    from ecg_byte_tpu_torch.ops import attention_resident, rmsnorm

    stand_in = {**_ATTENTION_WITNESSES, **_FORWARD_VARIANTS}
    out = []
    for args in calls:
        f64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                    for a in args)
        if name in stand_in or name == "prefill_attention":
            card = attention_resident.resident_attention(*args)
            kern = card if name == "prefill_attention" else stand_in[name](*args)
            plain, ref = _plain_attention(*args), _plain_attention(*f64)
            rows = args[3][0].bool()  # B1: the valid query positions
            kern, plain, ref, card = (x[:, rows] for x in (kern, plain, ref, card))
        else:
            kern = card = rmsnorm.rmsnorm(*args)
            plain, ref = _plain_rmsnorm(*args), _plain_rmsnorm(*f64)
        n = torch.linalg.vector_norm(ref).item()
        out.append(tuple(torch.linalg.vector_norm(x.double() - ref).item() / n
                         for x in (kern, plain))
                   + (torch.linalg.vector_norm((kern - plain).double()).item() / n,
                      (kern != plain).float().mean().item(), (kern != card).float().mean().item()))
    return out


def signed_ulp_bias(got, exact, magnitude=None):
    """The mean signed error of f32 ``got`` against ``exact`` (f64), in f32
    ulps of |exact| (2^(e - 24) for |exact| in [2^(e - 1), 2^e)), over the
    elements where exact > 0 and where exact < 0: (bias for s > 0, bias for
    s < 0).  Rounding toward zero reads about -0.5 and +0.5, rounding to
    nearest about 0.  With ``magnitude`` (the sum of the terms' absolute
    values), only over the elements whose sum cancels by at most 4x
    (|exact| >= magnitude / 4): where it cancels more, an error of a few
    ulps of the terms is many ulps of |s| and outweighs the rest."""
    import torch

    exact = exact.double()
    _, e = torch.frexp(exact)
    err = (got.double() - exact) / torch.ldexp(torch.ones_like(exact), e - 24)
    keep = torch.ones_like(exact, dtype=torch.bool) if magnitude is None else (
        exact.abs() * 4 >= magnitude)
    return err[keep & (exact > 0)].mean().item(), err[keep & (exact < 0)].mean().item()


def score_tiles(qg, k, mask, rows=64):
    """Tile pairs of one B1 attention call for the score product alone: for
    each KV head, its valid positions' query rows (the G heads of a
    position in a row) and key rows, cut into ``rows``-row tiles, query
    tile t paired with key tile t: q, k (T, rows, D)."""
    import torch

    valid = mask[0].bool()
    d = qg.shape[-1]
    qs, ks = [], []
    for h in range(k.shape[2]):
        keys = k[0, valid, h]
        n = keys.shape[0] // rows * rows
        qs.append(qg[0, valid, h].reshape(-1, d)[:n])
        ks.append(keys[:n])
    return (torch.cat(qs).view(-1, rows, d).contiguous(),
            torch.cat(ks).view(-1, rows, d).contiguous())


def score_biases(calls, tensor_cores):
    """For each recorded attention call, the signed bias
    (:func:`signed_ulp_bias`) of the score product summed each way of
    ``SCORE_DOTS`` (``attention_resident.attention_scores``; on the CPU the
    plain f32 product) and, with ``tensor_cores``, of cuBLAS's bf16 product
    with f32 output, against the f64 dot, on :func:`score_tiles` where the
    dot cancels by at most 4x: {way: [(bias for s > 0, bias for s < 0) per
    call]}."""
    import torch

    from ecg_byte_tpu_torch.ops.attention_resident import attention_scores

    ways = {f"kernel {dot}": functools.partial(attention_scores, dot=dot) for dot in SCORE_DOTS}
    if tensor_cores:
        ways["cuBLAS bf16 product"] = _tensor_core_logits
    out = {w: [] for w in ways}
    for qg, k, _, mask in calls:
        q, kk = score_tiles(qg, k, mask)
        exact = torch.einsum("trd,tsd->trs", q.double(), kk.double())
        magnitude = torch.einsum("trd,tsd->trs", q.double().abs(), kk.double().abs())
        for w, fn in ways.items():
            out[w].append(signed_ulp_bias(fn(q, kk), exact, magnitude))
    return out


def blame_phase(root, vocab, merges, f=FOLD, items=4, dev="cuda", long=None, long_items=2,
                long_pad_to_max=int(LONG_TRAIN_ARGS[-1])):
    """``python3 chip_smoke.py --blame``: which kernel takes the LoRA step's
    kernel path away from f32 at the valid positions when the norm weights
    are off 1 (phase 20's trees), and why.  Phase 7's ``items`` items at B1
    x 1024, each with its own LoRA B: for the norms moved by
    ``f.norm_shift`` and at 1, the classic and the folded tree on the
    kernels, then with one kernel at a time on the card and the others
    plain, each step's distance from the tree in f32 over the plain path's
    (:func:`path_error_ratios`); the same ratio with the resident forward
    summing its scores each way of ``SCORE_DOTS`` (``_FORWARD_VARIANTS``,
    the only kernel on the card), and for attention without a kernel
    (``_ATTENTION_WITNESSES``: the plain version with its q.k sums
    reordered, with the kernel's softmax arithmetic, with P.V or q.k on
    the tensor cores; the last needs ``torch.bmm(..., out_dtype=)`` on the
    card, and prints why where it cannot run); and the folded tree's plain
    path over the classic tree's, from the classic tree in f32.  First
    every call of the two forward kernels in item 0's classic step (norms
    moved), the kernel (and the variants and witnesses) and plain against
    the same call in f64 (:func:`per_call_errors`), and the score
    product's signed bias against the f64 dot each way
    (:func:`score_biases`).  With ``long`` (root, vocab, merges of the long
    data), last the flash path: ``long_items`` items at B1 x
    ``long_pad_to_max + 4``, norms moved, the classic tree on the kernels
    over the plain path.  Prints; holds nothing."""
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.ops import attention, attention_resident, rmsnorm
    from ecg_byte_tpu_torch.train.step import _batch_tensors

    phase(f"blame: the LoRA step's kernels one at a time, {items} items at B1 x "
          f"{f.pad_to_max + 4}, norm weights moved by {f.norm_shift} N(0, 1) and at 1")
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    missing = tensor_core_logits_missing(dev)
    for name in _CARD_WITNESSES if missing else ():
        print(f"witness {name}: needs torch.bmm(..., out_dtype=torch.float32) on the card, not "
              f"run here ({missing})", flush=True)
    witnesses = {k: fn for k, fn in _ATTENTION_WITNESSES.items()
                 if not (missing and k in _CARD_WITNESSES)}
    train = ("prefill_attention", "prefill_attention_bwd", "rmsnorm", "rmsnorm_bwd")
    f32 = lambda t: t.float()  # noqa: E731

    def items_of(root, vocab, merges, n, pad_to_max):
        base, config, tok = build_model(f.model, vocab, dev)
        data = _batch_tensors(_training_items(root, vocab, merges, tok, n, pad_to_max), dev)
        return (base, config, [{k: v[i:i + 1] for k, v in data.items()} for i in range(n)],
                [random_lora(config, 2 + i, dev) for i in range(n)])

    def pooled(params, config, batches, loras, kernels=train, attention_fn=None):
        ls = loras if config.dtype != "float32" else [_map_tree(f32, lo) for lo in loras]
        # the backward kernel takes the forward's output, which the plain
        # forward leaves strided
        plain_fwd = mock.patch.object(
            attention_resident, "resident_attention",
            attention_fn or (lambda *a: _plain_attention(*a).contiguous()))
        with plain_path([k for k in SOURCES if k not in kernels]), \
                (contextlib.nullcontext() if "prefill_attention" in kernels else plain_fwd):
            xs = [lora_loss_and_grads(params, lo, config, b)[0] for lo, b in zip(ls, batches)]
        return (sum(x[0] for x in xs), torch.cat([x[1] for x in xs]),
                torch.cat([x[2] for x in xs]), {g: torch.cat([x[3][g] for x in xs])
                                                 for g in xs[0][3]},
                torch.cat([x[4] for x in xs]))

    def show(label, r):
        print(f"{label}: " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()), flush=True)

    base, config, batches, loras = items_of(root, vocab, merges, items, f.pad_to_max)
    params = off_one_norms(base, 0, f.norm_shift)
    for name, module, attr in (("prefill_attention", attention_resident, "resident_attention"),
                               ("rmsnorm", rmsnorm, "rmsnorm")):
        calls = []
        with plain_path(), mock.patch.object(module, attr, _recorded_calls(name, calls)):
            lora_loss_and_grads(params, loras[0], config, batches[0])
        names = (name, *_FORWARD_VARIANTS, *witnesses) if module is attention_resident else (name,)
        for n in names:
            errs = per_call_errors(n, calls)
            mean = [sum(e[j] for e in errs) / len(errs) for j in range(5)]
            print(f"{n}, item 0's classic step at shift {f.norm_shift}, {len(errs)} calls: "
                  "per call |d|/|f64| kernel / plain, kernel vs plain, share of elements unequal "
                  "to plain, to the kernel "
                  f"{[' / '.join(f'{x:.3e}' for x in e) for e in errs]}; mean "
                  f"{' / '.join(f'{x:.3e}' for x in mean)}", flush=True)
        if module is attention_resident:
            for way, b in score_biases(calls, not missing).items():
                pos = sum(x[0] for x in b) / len(b)
                neg = sum(x[1] for x in b) / len(b)
                print(f"score product, {way}, item 0's classic step at shift {f.norm_shift}, "
                      f"{len(b)} calls: signed error against the f64 dot in f32 ulps of |s| where "
                      "|s| >= sum |q_d k_d| / 4, "
                      f"s > 0 / s < 0, per call {[f'{p:+.3f} / {q:+.3f}' for p, q in b]}; mean "
                      f"{pos:+.4f} / {neg:+.4f}", flush=True)
        del calls
    variants_before = attention_resident.resident_attention_dot.launches
    for shift in (f.norm_shift, 0.0):
        params = off_one_norms(base, 0, shift) if shift else base
        fparams, fconfig = T.fold_norm_scales(params, config)
        runs = {}
        for tree, (p, c) in (("classic", (params, config)), ("folded", (fparams, fconfig))):
            ref = runs[tree, "f32"] = pooled(_map_tree(f32, p), c.replace(dtype="float32"),
                                             batches, loras, ())
            plain = runs[tree, "plain"] = pooled(p, c, batches, loras, ())
            for on in (train,) + tuple((k,) for k in train):
                show(f"shift {shift}, {tree} tree, on the card {'all' if on == train else on[0]}"
                     ": kernel / plain distance from f32",
                     path_error_ratios(pooled(p, c, batches, loras, on), plain, ref))
            for name, fn in _FORWARD_VARIANTS.items():
                show(f"shift {shift}, {tree} tree, on the card prefill_attention as the "
                     f"{name} alone: kernel / plain distance from f32",
                     path_error_ratios(pooled(p, c, batches, loras, (), fn), plain, ref))
            for name, fn in _PAD_ROW_SWAPS.items():
                show(f"shift {shift}, {tree} tree, attention {name}: its distance from f32 over "
                     "the plain path's",
                     path_error_ratios(pooled(p, c, batches, loras, (), fn), plain, ref))
            # witnesses without any kernel, everything else plain
            for name, fn in witnesses.items():
                show(f"shift {shift}, {tree} tree, no kernel, attention {name}: its distance "
                     "from f32 over the plain path's",
                     path_error_ratios(pooled(p, c, batches, loras, (), fn), plain, ref))
        # the fold's own arithmetic, no kernel: both trees on the plain versions
        show(f"shift {shift}, folded plain / classic plain distance from the classic tree in f32",
             path_error_ratios(runs["folded", "plain"], runs["classic", "plain"],
                               runs["classic", "f32"]))
        del runs, fparams
    if cuda:
        assert attention_resident.resident_attention_dot.launches > variants_before
    del base, params, batches, loras
    if long is None:
        return
    # the flash path (S >= attention.FLASH_MIN_SEQ), norms moved, classic tree
    base, config, batches, loras = items_of(*long, long_items, long_pad_to_max)
    s = batches[0]["input_ids"].shape[1]
    assert s >= attention.FLASH_MIN_SEQ, (s, attention.FLASH_MIN_SEQ)
    params = off_one_norms(base, 0, f.norm_shift)
    flash = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")
    ref = pooled(_map_tree(f32, params), config.replace(dtype="float32"), batches, loras, ())
    plain = pooled(params, config, batches, loras, ())
    before = launches()
    kern = pooled(params, config, batches, loras, flash)
    if cuda:
        assert all(launches()[k] > before[k] for k in flash[:2]), (before, launches())
    show(f"flash path, {long_items} items at B1 x {s}, shift {f.norm_shift}, classic tree, on the "
         "card all: kernel / plain distance from f32", path_error_ratios(kern, plain, ref))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    name, smi = device_phase()
    build_phase()
    if sys.argv[1:] == ["--blame"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            long_root = os.path.join(root, "long")
            blame_phase(root, *make_data(root),
                        long=(long_root, *make_data(long_root, **LONG)))
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        vocab, merges = make_data(root)
        _, big_merges = make_data(root, **BIG)
        print(f"datasets and tokenizers ({NUM_MERGES} and {BIG['num_merges']} merges) made on "
              f"the host in {time.perf_counter() - t0:.1f} s")
        long_root = os.path.join(root, "long")
        t0 = time.perf_counter()
        long_vocab, long_merges = make_data(long_root, **LONG)
        lens = prompt_lengths(long_root, long_vocab, long_merges)
        print(f"long data: {LONG['n_train']} train, {LONG['n_val']} val, {LONG['n_test']} test "
              f"records of 12 x {LONG['seg_len']}, {LONG['num_merges']} merges, made on the host "
              f"in {time.perf_counter() - t0:.1f} s; serving prompts of {lens} tokens")
        assert min(lens) >= 4096, f"a long prompt has fewer than 4,096 tokens: {lens}"
        report = kernels_phase(root, merges, big_merges, (bucket(lens[0]), lens[0]))
        by_path = {}
        by_path["train"], train = train_phase(root, vocab, merges)
        ms = {}  # decode ms/token by serving path
        for path in (SERVE, SERVE_INT8):
            by_path[path.key], ms[path.key] = serve_phase(root, train["checkpoint"], path)
        for path in (SERVE, SERVE_INT8):
            paths_phase(root, vocab, merges, path)
        train_paths_phase(root, vocab, merges, TRAIN_CHECK)
        by_path["train_long"], long_train = long_train_phase(long_root, long_vocab, long_merges)
        by_path[SERVE_LONG.key], ms[SERVE_LONG.key] = serve_phase(
            long_root, long_train["checkpoint"], SERVE_LONG)
        paths_phase(long_root, long_vocab, long_merges, SERVE_LONG)
        train_paths_phase(long_root, long_vocab, long_merges, LONG_TRAIN_CHECK)
        hf_counts, hf = hf_phase(root, vocab, merges)
        by_path.update(hf_counts)
        pre_counts, pre = preprocess_phase(root)
        by_path.update(pre_counts)
        two_counts, two = two_stage_phase(root)
        by_path.update(two_counts)
        ddp_counts, ddp = ddp_phase(root, vocab, merges)
        by_path.update(ddp_counts)
        slice_counts, sl = slice_phase(root, vocab, merges, train["checkpoint"])
        by_path.update(slice_counts)
        grid_counts, grid = grid_phase(root, vocab, merges, (long_root, long_vocab, long_merges))
        by_path.update(grid_counts)
        fold_counts, fold = fold_phase(root, vocab, merges)
        by_path.update(fold_counts)
    for mod in ("jax", "ecg_byte_tpu", "safetensors", "tokenizers", "transformers", "regex",
                "ml_dtypes", "sklearn", "pandas", "pywt", "wfdb", "PIL", "optax"):
        assert mod not in sys.modules, f"{mod} was imported"
    kernels = []
    for kname, (route, source, replaces) in SOURCES.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": sum(counts[kname] for counts in by_path.values()),
            "launches_by_path": {path: counts[kname] for path, counts in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"host_trie_ms": r["host_trie_ms"]} if "host_trie_ms" in r else {}),
            "rows": [{k: v for k, v in row.items() if k != "max_abs_err"} for row in r["rows"]],
        })
    print(f"train step {train['ms_per_step']:.2f} ms, {train['tokens_per_s']:.0f} tokens/s, "
          f"peak {train['peak_gib']:.2f} GiB; decode {ms['serve']:.3f} ms/token bf16, "
          f"{ms['serve_int8']:.3f} ms/token int8 (host clock)")
    print(f"long path: train step B1 x 4096 {long_train['ms_per_step']:.2f} ms, "
          f"{long_train['tokens_per_s']:.0f} tokens/s, peak {long_train['peak_gib']:.2f} GiB; "
          f"decode {ms['serve_long']:.3f} ms/token bf16 (host clock)")
    print(f"--hf_weights: vocab {hf['vocab']:,}, build {hf['build_s']:.1f} s, train step "
          f"{hf['ms_per_step']:.2f} ms, {hf['tokens_per_s']:.0f} tokens/s; prefill "
          f"{hf['prefill_ms']:.2f} ms, decode {hf['ms_per_token']:.3f} ms/token (host clock); "
          f"BERTScore {hf['scorer_ms_per_pair']:.2f} ms a pair")
    print(f"preprocess: {pre['device_ms_per_batch']:.3f} ms a {PREPROCESS_BATCH}-record batch on the "
          f"device (bound {pre['bound_ms']:.3f}); cli.preprocess_ecg {pre['records_per_s_2500']:.1f} "
          f"records/s at seg_len 2500 (host clock); operators built in "
          f"{pre['operator_build_s']:.1f} s; cli.sample_ecg {pre['sample_s']:.1f} s")
    print(f"two-stage: pretrain step {two['pretrain_ms']:.2f} ms at B{TWO_STAGE.pretrain_batch} x "
          f"(12, 2500); fusion train step {two['finetune_ms']:.2f} ms at B{TWO_STAGE.finetune_batch}"
          f" x {TWO_STAGE.pad_to_max + 2} (CUDA events); decode {two['serve_bf16_ms_per_token']:.3f}"
          f" ms/token bf16, {two['serve_int8_ms_per_token']:.3f} int8 (host clock)")
    print(f"--dis: main-path step {ddp['lm_W=2 gloo_rank0_ms']:.2f} ms a rank at W = 2 on one "
          f"card (all-reduce {ddp['lm_W=2 gloo_rank0_allreduce_ms']:.2f} ms), "
          f"{ddp['lm_W=1 NCCL_rank0_ms']:.2f} ms at W = 1 over NCCL (all-reduce "
          f"{ddp['lm_W=1 NCCL_rank0_allreduce_ms']:.2f} ms); phase 17 {ddp['wall_s']:.1f} s")
    print(f"phase 18: interpretation {sl['interp_ms_per_record']:.2f} ms a record at S "
          f"{SLICE.interp_pad_to_max + 4}, peak {sl['interp_peak_gib']:.2f} GiB; translation "
          f"{sl['sentences_per_s']:.1f} sentences/s, {sl['marian_step_ms']:.3f} ms a decode step "
          f"at B32 (host clock); phase 18 {sl['wall_s']:.1f} s")
    h = [grid.get(f"harness_rank{r}_step_ms") for r in range(GRID_TP * GRID_FSDP)]
    print(f"--tp / --fsdp: harness step at T = {GRID_TP} x F = {GRID_FSDP}, {GRID.layers} layers, "
          f"B{GRID.batch} x {GRID.pad_to_max + 4}: {h} ms a rank (CUDA events); rank 0's "
          f"collectives: tp {grid['harness_rank0_tp_ms']:.2f} ms, fsdp "
          f"{grid['harness_rank0_fsdp_ms']:.2f} ms, data {grid['harness_rank0_data_ms']:.2f} ms; "
          f"phase 19 {grid['wall_s']:.1f} s")
    print(f"norm-folded: train step B{FOLD.batch} x {FOLD.pad_to_max + 4} "
          f"{fold['train_folded_ms']:.2f} ms (classic {fold['train_classic_ms']:.2f}; CUDA "
          f"events); decode {fold['decode_bf16_folded_ms_per_token']:.3f} ms/token bf16 "
          f"(classic {fold['decode_bf16_classic_ms_per_token']:.3f}), "
          f"{fold['decode_int8_folded_ms_per_token']:.3f} int8 (classic "
          f"{fold['decode_int8_classic_ms_per_token']:.3f}; host clock); phase 20 "
          f"{fold['wall_s']:.1f} s; 18a traced with --profile in {sl['profiled_run_s']:.1f} s, "
          f"{sl['trace_mb']:.1f} MB")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
