#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines, in the order they run:

1. Device: the card, its power limit, TF32 off.
2. Build: the CUDA kernels compile from ``ecg_byte_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and the host BPE library from
   ``ecg_byte_tpu_torch/csrc/host``.
3. Kernels vs plain: each kernel against its plain PyTorch version at the
   main paths' widths, with the tolerance stated, timed in turns with the
   plain version and one PyTorch library call that computes the same
   function (a yardstick the port never calls), beside the card's bound.
6. Train: ``ecg_byte_tpu_torch.cli.main`` trains a random Llama-3.2-1B at
   full width with LoRA (``--peft --online_encode --dev``, batch 4 x 1024)
   on a synthetic dataset; exact launch counts of the four training
   kernels; then the train step timed alone.
4. Serve: ``cli.main --inference --peft`` serves the checkpoint phase 6
   wrote, LoRA merged; every serving kernel's launch count.
5. Serving kernel path vs plain path: one prompt plus 32 teacher-forced
   tokens through prefill and decode_step; the logits must agree.
7. Train-step kernel path vs plain path: loss and LoRA gradients at
   B1 x 1024 with the kernels, with the plain versions and in f32.

Every check raises, so any failure exits non-zero.  The next-to-last line
is a JSON object with each kernel's measurements, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Neither JAX nor ``ecg_byte_tpu`` is imported (the end
asserts it).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
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
N_TEST = 10  # --dev decodes 10 records per seed
TEACHER_FORCED = 32
TRAIN_ARGS = ["--peft", "--online_encode", "--dev", "--batch_size", "4", "--pad_to_max", "1020"]
PEAK_FLOPS = 989e12  # dense bf16, H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

SOURCES = {  # kernel -> (route, source, the TPU kernel it replaces)
    "prefill_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_prefill.cu",
                          "ecg_byte_tpu/ops/attention_resident.py:73"),
    "prefill_attention_bwd": ("cuda", "ecg_byte_tpu_torch/csrc/attention_prefill_bwd.cu",
                              "ecg_byte_tpu/ops/attention_resident.py:86"),
    "decode_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_decode.cu",
                         "ecg_byte_tpu/ops/attention_decode.py:90"),
    "rmsnorm": ("triton", "ecg_byte_tpu_torch/ops/rmsnorm.py", "ecg_byte_tpu/ops/rmsnorm.py:59"),
    "rmsnorm_bwd": ("triton", "ecg_byte_tpu_torch/ops/rmsnorm.py",
                    "ecg_byte_tpu/ops/rmsnorm.py:66"),
}
SERVE_KERNELS = ("prefill_attention", "decode_attention", "rmsnorm")


def phase(name):
    print(f"\n== {name}", flush=True)


# ------------------------------------------------------------------ helpers


def bf16_ulp(y):
    """One bf16 ulp of each value of ``y``: 2^(exponent - 7)."""
    import torch

    _, e = torch.frexp(y.float())  # y = m * 2^e, 0.5 <= |m| < 1
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def time_in_turns(fns, iters):
    """Mean ms per call of each function with CUDA events, after a warm-up,
    in the palindrome order f0, f1, .., fn, fn, .., f1, f0."""
    import torch

    def run(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    times = [0.0] * len(fns)
    for i in order:
        times[i] += run(fns[i]) / 2
    return times


def bound_ms(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention_bwd(got, want, shape):
    """Hold the kernel's (dq, dk, dv) against the plain backward's and
    return the largest max|d|.  Each must be finite and within two bounds:
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

    print(f"prefill_attention_bwd {shape} against plain:")
    err = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), f"K1 bwd {shape}: non-finite {name}"
        diff = (a - w).abs()
        max_rel = diff.max().item() / w.abs().max().item()
        norm_rel = (torch.linalg.vector_norm(a - w) / torch.linalg.vector_norm(w)).item()
        print(f"  {name}: max|d|/max|ref| {max_rel:.3e} (bound 4e-2 = "
              f"{4e-2 * w.abs().max().item():.3e}); |d|/|ref| {norm_rel:.3e} (bound 1e-3); "
              f"median |ref| {w.abs().median().item():.3e}")
        assert max_rel <= 4e-2, f"K1 bwd {shape} {name}: max|d|/max|ref| {max_rel:.3e}"
        assert norm_rel <= 1e-3, f"K1 bwd {shape} {name}: |d|/|ref| {norm_rel:.3e}"
        err = max(err, diff.max().item())
    return err


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


@functools.lru_cache(maxsize=1)
def _counters():
    from ecg_byte_tpu_torch.ops import attention_decode, attention_resident, rmsnorm

    # the wrappers themselves, taken before any plain_path() swap
    return {
        "prefill_attention": attention_resident.resident_attention,
        "prefill_attention_bwd": attention_resident.resident_attention_bwd,
        "decode_attention": attention_decode.decode_attention_fused,
        "rmsnorm": rmsnorm.rmsnorm,
        "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
    }


def launches():
    return {name: fn.launches for name, fn in _counters().items()}


def zero_launches():
    for fn in _counters().values():
        fn.launches = 0


@contextlib.contextmanager
def plain_path(kernels=tuple(SOURCES)):
    """Swap the plain PyTorch versions in for the named kernel wrappers
    (the autograd functions look their wrappers up when called)."""
    from ecg_byte_tpu_torch.ops import attention, attention_decode, attention_resident, rmsnorm

    _counters()
    swaps = {
        "prefill_attention": (attention_resident, "resident_attention", attention.grouped_attention),
        "prefill_attention_bwd": (attention_resident, "resident_attention_bwd",
                                  attention_resident.resident_attention_bwd_plain),
        "decode_attention": (attention_decode, "decode_attention_fused", attention.decode_attention),
        "rmsnorm": (rmsnorm, "rmsnorm", rmsnorm.rmsnorm_plain),
        "rmsnorm_bwd": (rmsnorm, "rmsnorm_bwd", rmsnorm.rmsnorm_bwd_plain),
    }
    with contextlib.ExitStack() as stack:
        for name in kernels:
            stack.enter_context(mock.patch.object(*swaps[name]))
        yield


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def make_data(root, *, n_train=N_TRAIN, n_val=2, n_test=N_TEST, seg_len=SEG_LEN,
              num_merges=NUM_MERGES):
    """Synthetic ptb_500 tree and BPE tokenizer under ``root/data`` (host
    only, no card needed); returns (vocab, merges)."""
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import make_synthetic
    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
    from ecg_byte_tpu_torch.tokenizer import BpeTokenizer

    data = os.path.join(root, "data")
    with contextlib.redirect_stdout(sys.stderr):
        make_synthetic.main(["--data_root", data, "--n_train", str(n_train), "--n_val",
                             str(n_val), "--n_test", str(n_test), "--seg_len", str(seg_len),
                             "--seed", "0"])
    stats = np.load(os.path.join(data, "ptb_500_dataset_stats.npy"), allow_pickle=True).item()
    with open(os.path.join(data, f"sampled_ecg_files_{n_train}.txt")) as f:
        train = [np.load(p) for p in f.read().split()]
    corpus = "".join(
        quantized_to_string(normalize_quantize(
            torch.from_numpy(s), stats["percentile_1"], stats["percentile_99"])[1])
        for s in train
    )
    bpe = BpeTokenizer.train(corpus, num_merges)
    bpe.save(os.path.join(data, f"tokenizer_{num_merges}.pkl"))
    return bpe.vocab, bpe.merges


def _cli_args(num_merges=NUM_MERGES):
    return ["--model", MODEL, "--dataset", "ptb_500", "--tokenizer_check",
            f"tokenizer_{num_merges}", "--num_merges", str(num_merges),
            "--percentiles", "data/ptb_500_dataset_stats.npy"]


def _training_items(root, vocab, merges, tokenizer, n):
    """The first ``n`` packed training items (S = pad_to_max + 4 = 1024)."""
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset, collate
    from ecg_byte_tpu_torch.train.runner import model_batch
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    data = os.path.join(root, "data")
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/train", f"{data}/ptb_500/text/train")
    ds = ECGTokenDataset(sigs[:n], texts[:n], vocab, merges, tokenizer=tokenizer,
                         args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy",
                                         pad_to_max=1020))
    pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
    return model_batch(collate([ds[i] for i in range(n)], pad_id=pad_id))


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


def kernels_phase():
    import torch
    import torch.nn.functional as F

    from ecg_byte_tpu_torch.ops import attention, attention_decode, attention_resident, rmsnorm

    phase("3. kernels vs plain (and one library call as yardstick)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    report = {name: {"max_abs_err": 0.0, "rows": []} for name in SOURCES}

    def record(name, shape, err, times, flops, nbytes, main):
        ms, plain_ms, library_ms = times
        b_ms, b_by = bound_ms(flops, nbytes)
        row = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"{name} {shape}: max|d| {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB)")
        entry = report[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["rows"].append(row)
        if main:
            entry.update({k: v for k, v in row.items() if k != "max_abs_err"})

    def sdpa_inputs(qg, k, v, mask):
        """(B, H, S, D) views for SDPA and the boolean causal & pad mask."""
        b, s, kh, g, d = qg.shape
        q4 = qg.reshape(b, s, kh * g, d).transpose(1, 2).contiguous()
        k4, v4 = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        return q4, k4, v4, (causal[None] & mask.bool()[:, None, :])[:, None]

    # K1 forward: (B, S, H, KH, D), 37 left-pad positions.  B1 S1024 is the
    # serving path's prefill, B4 S1024 the training path's.
    for b, s, h, kh, d in [(1, 1024, 32, 8, 64), (1, 2048, 32, 8, 64), (4, 1024, 32, 8, 64),
                           (1, 1024, 25, 25, 64), (1, 256, 8, 1, 256)]:
        with torch.inference_mode():
            qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, :37] = 0
            got = attention_resident.resident_attention(qg, k, v, mask)
            want = attention.grouped_attention(qg, k, v, mask)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), "K1: non-finite output"
            valid = mask.bool()
            g_, w_ = got.float()[valid], want.float()[valid]
            # the tolerance of tests/test_attention_resident.py: bf16 P.V
            # rounding and another summation order
            assert torch.allclose(g_, w_, atol=2e-2, rtol=2e-2), "K1 disagrees with plain"
            q4, k4, v4, bmask = sdpa_inputs(qg, k, v, mask)
            times = time_in_turns([
                lambda: attention_resident.resident_attention(qg, k, v, mask),
                lambda: attention.grouped_attention(qg, k, v, mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                       enable_gqa=True),
            ], 10 if b * s <= 2048 else 4)
            pairs = (mask * mask.cumsum(-1)).sum().item() * h  # valid causal (q, t) pairs
            nbytes = 2 * (2 * qg.numel() + k.numel() + v.numel()) + 4 * mask.numel()
            record("prefill_attention", [b, s, h, kh, d], (g_ - w_).abs().max().item(), times,
                   4 * d * pairs, nbytes, main=(b, s, h) == (4, 1024, 32))

    # K1 backward at the training shape and the gpt2 / gemma shapes; the
    # output gradient is zero on left-pad rows, as on the training path
    for b, s, h, kh, d in [(4, 1024, 32, 8, 64), (1, 1024, 25, 25, 64), (1, 256, 8, 1, 256)]:
        qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[:, :37] = 0
        with torch.no_grad():
            out = attention_resident.resident_attention(qg, k, v, mask)
            gout = randn(*qg.shape) * mask[:, :, None, None, None].to(torch.bfloat16)
            got = attention_resident.resident_attention_bwd(qg, k, v, mask, out, gout)
            want = attention_resident.resident_attention_bwd_plain(qg, k, v, mask, out, gout)
            torch.cuda.synchronize()
            err = check_attention_bwd(got, want, [b, s, h, kh, d])
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
               main=(b, h) == (4, 32))

    # K2: (B, S_max, H, KH, D), unfilled tail and left padding
    for b, s, h, kh, d in [(1, 1152, 32, 8, 64), (4, 1152, 32, 8, 64),
                           (1, 1152, 25, 25, 64), (4, 1152, 25, 25, 64)]:
        with torch.inference_mode():
            q, kc, vc = randn(b, 1, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, -s // 4:] = 0
            mask[0, :3] = 0
            got = attention_decode.decode_attention_fused(q, kc, vc, mask)
            want = attention.decode_attention(q, kc, vc, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert torch.isfinite(got.float()).all() and err <= 2e-2, f"K2 max|d| {err}"
            q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            bmask = mask.bool()[:, None, None, :]
            times = time_in_turns([
                lambda: attention_decode.decode_attention_fused(q, kc, vc, mask),
                lambda: attention.decode_attention(q, kc, vc, mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bmask,
                                                       enable_gqa=True),
            ], 100)
            n_valid = mask.sum().item()  # the cache rows this call must read
            nbytes = 2 * (2 * n_valid * kh * d + 2 * q.numel()) + 4 * mask.numel()
            record("decode_attention", [b, s, h, kh, d], err, times, 4 * d * h * n_valid,
                   nbytes, main=(b, h) == (1, 32))

    # K3 forward: rows x 2048; the decode row is the serving path's commonest call
    for shape in [(4096, 2048), (1024, 2048), (1, 2048)]:
        with torch.inference_mode():
            x = randn(*shape)
            w = torch.randn(shape[-1], generator=gen, device=dev)
            got = rmsnorm.rmsnorm(x, w, 1e-5)
            want = rmsnorm.rmsnorm_plain(x, w, 1e-5)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            assert (diff <= bf16_ulp(want)).all(), "K3 off by more than 1 bf16 ulp"
            wb = w.to(torch.bfloat16)
            times = time_in_turns([
                lambda: rmsnorm.rmsnorm(x, w, 1e-5),
                lambda: rmsnorm.rmsnorm_plain(x, w, 1e-5),
                lambda: F.rms_norm(x, (shape[-1],), wb, 1e-5),
            ], 200)
            record("rmsnorm", list(shape), diff.max().item(), times, 4 * x.numel(),
                   4 * x.numel() + 4 * w.numel(), main=shape[0] == 4096)

    # K3 backward: the training path's (4096, 2048) and a ragged row count;
    # dx as check_rmsnorm_bwd_dx says, dw relative 1e-3 (summation order);
    # timed as the LoRA path runs it, without dw (the norm weights are
    # frozen)
    for shape in [(4096, 2048), (1000, 2048)]:
        x, gout = randn(*shape), randn(*shape)
        w = torch.randn(shape[-1], generator=gen, device=dev)
        with torch.no_grad():
            dx, dw = rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, True)
            pdx, pdw = rmsnorm.rmsnorm_bwd_plain(x, w, gout, 1e-5, True)
            torch.cuda.synchronize()
            err = check_rmsnorm_bwd_dx(dx, pdx, x, w, gout, 1e-5, list(shape))
            dw_rel = ((dw - pdw).abs().max() / pdw.abs().max()).item()
            assert dw_rel <= 1e-3, f"K3 bwd dw relative {dw_rel:.3e}"
            print(f"rmsnorm_bwd {list(shape)}: dw max|d|/max|dw| {dw_rel:.3e}")
        xl = x.detach().requires_grad_(True)
        yl = F.rms_norm(xl, (shape[-1],), w.to(torch.bfloat16), 1e-5)
        times = time_in_turns([
            lambda: rmsnorm.rmsnorm_bwd(x, w, gout, 1e-5, False),
            lambda: rmsnorm.rmsnorm_bwd_plain(x, w, gout, 1e-5, False),
            lambda: torch.autograd.grad(yl, xl, gout, retain_graph=True),
        ], 50)
        del yl
        record("rmsnorm_bwd", list(shape), err, times, 8 * x.numel(),
               6 * x.numel() + 4 * w.numel(), main=shape[0] == 4096)
    return report


def train_phase(root, vocab, merges):
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.models.lora import leaves
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step

    phase("6. train: cli.main --peft --online_encode --dev, random Llama-3.2-1B at full width")
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root):
        result = cli_main.main(_cli_args() + TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    summary = result["training"]
    steps, evals = summary["steps"], 2  # two epochs, one validation batch each
    print(f"launches {counts}; {steps} train steps, {evals} eval steps; "
          f"{summary['tokens']} tokens in {summary['seconds']:.1f} s; phase wall {wall:.1f} s")
    layers = 16
    # per train step every layer's attention forward and backward, 2L + 1
    # norms forward; 2L norm backwards, as layer 0's input norm reads the
    # frozen embedding and nothing asks for its gradient; per eval step the
    # forwards alone
    expected = {"prefill_attention": layers * (steps + evals),
                "prefill_attention_bwd": layers * steps,
                "decode_attention": 0,
                "rmsnorm": (2 * layers + 1) * (steps + evals),
                "rmsnorm_bwd": 2 * layers * steps}
    assert steps == 12, f"{steps} train steps"
    for name, n in counts.items():
        assert n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
    losses = summary["train_loss"] + summary["val_loss"]
    assert all(np.isfinite(losses)), losses
    print(f"train loss per epoch {summary['train_loss']}, val loss {summary['val_loss']}")

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
    del best, lora, bs

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
        step = make_train_step(config, opt, remat=remat)
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
        timed[remat] = (ms, peak)
        print(f"train step B{b} x S{s}, remat {remat}: {ms:.2f} ms/step = "
              f"{b * s / ms * 1e3:.0f} tokens/s (CUDA events over 5 steps after 2 warm-up); "
              f"loss {loss.item():.4f}; peak device memory {peak:.2f} GiB")
    profile_steps(make_train_step(config, opt), state, batch, gen)
    ms, peak = timed["none"]
    return counts, {"ms_per_step": ms, "tokens_per_s": b * s / ms * 1e3, "peak_gib": peak,
                    "checkpoint": os.path.basename(summary["directory"])}


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
    groups = {"attention backward (dq_kernel, dkv_kernel)": ("dq_kernel", "dkv_kernel"),
              "attention forward (prefill_attention_kernel)": ("prefill_attention_kernel",),
              "rmsnorm (triton)": ("rmsnorm_fwd", "rmsnorm_bwd", "sum_partials"),
              "matmuls (cuBLAS)": ("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas")}
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
        group = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        totals[group] += us
    busy_ms = sum(totals.values()) / 1e3
    print(f"profile of {n} train steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} (upper bound)")
    for g, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / n:8.2f} ms/step  {100 * us / 1e3 / busy_ms:5.1f}%  {g}")
    print("  top kernels (ms/step, calls/step):")
    for us, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {us / 1e3 / n:8.3f}  {count / n:6.1f}  {key[:110]}")


def serve_phase(root, checkpoint):
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.models import llama_3_2_1b

    phase("4. serve: cli.main --inference --peft on phase 6's checkpoint (LoRA merged)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(root):
        result = cli_main.main(_cli_args() + [
            "--inference", "--dev", "--peft", "--checkpoint", checkpoint, "--eval_batch_size", "1",
        ])
    wall = time.perf_counter() - t0
    counts = launches()
    serving, records = result["serving"], result["records"]
    prefills, steps = serving["records"], serving["decode_steps"]
    forwards = prefills + steps
    layers = 16
    print(f"launches {counts}; {prefills} prefills, {steps} decode steps")
    expected = {"prefill_attention": layers * prefills, "prefill_attention_bwd": 0,
                "decode_attention": layers * steps, "rmsnorm": (2 * layers + 1) * forwards,
                "rmsnorm_bwd": 0}
    assert prefills == 5 * N_TEST, f"{prefills} records decoded"
    for name, n in counts.items():
        assert n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
        assert n > 0 or name not in SERVE_KERNELS
    vocab_size = llama_3_2_1b().vocab_size  # the ECG tokens fit inside it
    for r in records:
        toks = r["tokens"]
        assert toks.shape == (1, 128) and toks.min() >= 0 and toks.max() < vocab_size
    assert min(serving["prompt_lens"]) >= 1024, serving["prompt_lens"]
    ms_step = serving["decode_ms_per_step"]
    print(f"bucketed prompt lengths {serving['prompt_lens']}; prefill "
          f"{serving['prefill_ms_mean']:.2f} ms/record; decode {ms_step:.3f} ms/token "
          f"= {1e3 / ms_step:.1f} tok/s at batch 1 (host clock around synchronize)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"phase wall {wall:.1f} s")
    return counts


def paths_phase(root, vocab, merges):
    import numpy as np
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    phase(f"5. serving kernel path vs plain path: one prompt + {TEACHER_FORCED} teacher-forced tokens")
    dev = torch.device("cuda")
    data = os.path.join(root, "data")
    params, config, tok = build_model(MODEL, vocab, dev)
    sigs, texts = align_signal_text_files(f"{data}/ptb_500/ecg/test", f"{data}/ptb_500/text/test")
    item = ECGTokenDataset(
        sigs[:1], texts[:1], vocab, merges, tokenizer=tok,
        args=DataConfig(percentiles=f"{data}/ptb_500_dataset_stats.npy", inference=True),
    )[0]
    n = len(item["tokenized_signal"])
    s = -(-n // 128) * 128  # left-padded to the bucket, as the CLI does
    ids = np.concatenate([np.full(s - n, tok.pad_token_id), item["tokenized_signal"]])
    mask = np.concatenate([np.zeros(s - n), np.ones(n)])
    ids = torch.from_numpy(ids).long()[None].to(dev)
    mask = torch.from_numpy(mask).to(torch.int32)[None].to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    forced = torch.randint(0, config.vocab_size, (TEACHER_FORCED,), generator=gen, device=dev)

    @torch.inference_mode()
    def run(params, config):
        cache = T.init_kv_cache(config, 1, s + TEACHER_FORCED, dev)
        logits, cache, pos = T.prefill(params, config, ids, mask, cache)
        out = [logits]
        cache_mask = torch.cat(
            [mask, torch.zeros(1, TEACHER_FORCED, dtype=torch.int32, device=dev)], 1)
        pos = pos.to(torch.int32)
        for step in range(TEACHER_FORCED):
            cache_mask[:, s + step] = 1
            logits, cache = T.decode_step(
                params, config, forced[step:step + 1], pos, s + step, cache, cache_mask)
            out.append(logits)
            pos = pos + 1
        return torch.stack(out)  # (1 + TEACHER_FORCED, 1, V)

    def rel(a, b):
        """max|a - b| / max|b| at each step."""
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).cpu()

    before = launches()
    kern = run(params, config)
    mid = launches()
    with plain_path():
        plain = run(params, config)
        # the same weights computed in f32 by the plain versions: the
        # reference both bf16 paths are held against
        ref = run(_map_tree(lambda t: t.float(), params), config.replace(dtype="float32"))
    after = launches()
    assert all(mid[k] > before[k] for k in SERVE_KERNELS), "the kernel run launched no kernel"
    assert after == mid, "the plain runs launched a kernel"
    assert all(torch.isfinite(x).all() for x in (kern, plain, ref))
    d_kp, d_pr, d_kr = rel(kern, plain), rel(plain, ref), rel(kern, ref)
    print(f"prompt {n} tokens bucketed to {s}; max|dlogits|/max|logits| over "
          f"{d_kp.numel()} steps, worst / mean:")
    print(f"  kernel path vs plain path    {d_kp.max().item():.3e} / {d_kp.mean().item():.3e}")
    print(f"  plain path vs f32 reference  {d_pr.max().item():.3e} / {d_pr.mean().item():.3e}")
    print(f"  kernel path vs f32 reference {d_kr.max().item():.3e} / {d_kr.mean().item():.3e}")
    for name in SERVE_KERNELS:  # how far one kernel alone moves the logits
        with plain_path([k for k in SERVE_KERNELS if k != name]):
            only = run(params, config)
        print(f"  only {name} as kernel, vs plain path: worst {rel(only, plain).max().item():.3e}")
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    print(f"greedy argmax of kernel and plain paths agrees at {agree} of {d_kp.numel()} "
          "positions (near-ties under random weights may flip; not asserted)")
    # Any bf16 rounding difference, even RMSNorm's rare 1-ulp ones, grows
    # through 16 random layers to about the bf16 path's own error against
    # f32; the bound is therefore relative to that error.
    assert d_kr.max() <= 1.25 * d_pr.max(), "kernel path further from f32 than the plain path"
    assert d_kp.max() <= 2 * d_pr.max(), "kernel and plain paths differ beyond the bf16 error"


def train_paths_phase(root, vocab, merges):
    import torch

    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.models import lora as lora_lib
    from ecg_byte_tpu_torch.train.step import _batch_tensors, _loss_from_batch

    phase("7. train-step kernel path vs plain path: loss and LoRA gradients at B1 x 1024")
    dev = torch.device("cuda")
    params, config, tok = build_model(MODEL, vocab, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    lora = lora_lib.init_lora(config, gen, dev)
    for layer in lora["layers"]:  # B != 0, so that dA != 0
        for ab in layer.values():
            ab["b"] = (1e-2 * torch.randn(ab["b"].shape, generator=gen, device=dev)).to(ab["b"].dtype)
    batch = _batch_tensors(_training_items(root, vocab, merges, tok, 1), dev)
    names = [(name, k) for name in lora["layers"][0] for k in ("a", "b")]

    def run(params, lora, config):
        lora = _map_tree(lambda t: t.detach().clone().requires_grad_(True), lora)
        loss = _loss_from_batch(config, params, lora, batch, None)  # dropout off
        loss.backward()
        grads = {nk: torch.cat([layer[nk[0]][nk[1]].grad.float().flatten()
                                for layer in lora["layers"]]) for nk in names}
        return loss.item(), grads

    before = launches()
    kern = run(params, lora, config)
    mid = launches()
    with plain_path():
        plain = run(params, lora, config)
        f32 = lambda t: t.float()  # noqa: E731
        ref = run(_map_tree(f32, params), _map_tree(f32, lora), config.replace(dtype="float32"))
    after = launches()
    train_kernels = ("prefill_attention", "prefill_attention_bwd", "rmsnorm", "rmsnorm_bwd")
    assert all(mid[k] > before[k] for k in train_kernels), (before, mid)
    assert after == mid, "the plain runs launched a kernel"

    def errs(path):
        loss_err = abs(path[0] - ref[0]) / abs(ref[0])
        g_err = {nk: (torch.linalg.vector_norm(path[1][nk] - ref[1][nk])
                      / torch.linalg.vector_norm(ref[1][nk])).item() for nk in names}
        return loss_err, g_err

    (lk, gk), (lp, gp) = errs(kern), errs(plain)
    print(f"losses: kernel {kern[0]:.6f}, plain {plain[0]:.6f}, f32 {ref[0]:.6f}; "
          f"relative error vs f32: kernel {lk:.3e}, plain {lp:.3e}")
    print("LoRA gradient groups, |dgrad|/|grad| vs f32 (kernel / plain):")
    for nk in names:
        print(f"  {nk[0]}.{nk[1]}: {gk[nk]:.3e} / {gp[nk]:.3e}")
    # the rule of phase 5: the kernel path no further from f32 than 1.25x
    # the plain path's own bf16 error
    bad = [f"{nk[0]}.{nk[1]}" for nk in names if gk[nk] > 1.25 * gp[nk]]
    assert lk <= 1.25 * lp or lk <= 1e-6, f"loss error {lk:.3e} vs plain {lp:.3e}"
    assert not bad, f"gradient groups further from f32 than 1.25x the plain path: {bad}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    name, smi = device_phase()
    build_phase()
    report = kernels_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        vocab, merges = make_data(root)
        train_counts, train = train_phase(root, vocab, merges)
        serve_counts = serve_phase(root, train["checkpoint"])
        paths_phase(root, vocab, merges)
        train_paths_phase(root, vocab, merges)
    for mod in ("jax", "ecg_byte_tpu"):
        assert mod not in sys.modules, f"{mod} was imported"
    kernels = []
    for kname, (route, source, replaces) in SOURCES.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": train_counts[kname] + serve_counts[kname],
            "launches_by_path": {"train": train_counts[kname], "serve": serve_counts[kname]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            "rows": [{k: v for k, v in row.items() if k != "max_abs_err"} for row in r["rows"]],
        })
    print(f"train step {train['ms_per_step']:.2f} ms, {train['tokens_per_s']:.0f} tokens/s, "
          f"peak {train['peak_gib']:.2f} GiB")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
