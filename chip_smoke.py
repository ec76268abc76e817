#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines:

1. Device: the card, its power limit, TF32 off.
2. Build: the CUDA kernels compile from ``ecg_byte_tpu_torch/csrc``.
3. Kernels vs plain: each kernel against its plain PyTorch version at the
   serving path's widths, with the tolerance stated, timed in turns.
4. Main path: ``ecg_byte_tpu_torch.cli.main --inference`` on a synthetic
   dataset with a random Llama-3.2-1B at full width; every kernel's launch
   counter must show the path went through it.
5. Kernel path vs plain path: one prompt plus 32 teacher-forced tokens
   through prefill and decode_step with the kernels and with the plain
   versions swapped in; the logits must agree.

Every check raises, so any failure exits non-zero.  The next-to-last line
is a JSON object with each kernel's measurements, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  No JAX is imported (the last phase asserts it).
"""

from __future__ import annotations

import contextlib
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
N_TEST = 10  # --dev decodes 10 records per seed
TEACHER_FORCED = 32


def phase(name):
    print(f"\n== {name}", flush=True)


# ------------------------------------------------------------------ helpers


def bf16_ulp(y):
    """One bf16 ulp of each value of ``y``: 2^(exponent - 7)."""
    import torch

    _, e = torch.frexp(y.float())  # y = m * 2^e, 0.5 <= |m| < 1
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def time_in_turns(plain_fn, kernel_fn, iters):
    """Mean ms per call with CUDA events, in turns plain, kernel, kernel,
    plain after a warm-up; returns (kernel_ms, plain_ms)."""
    import torch

    def run(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    plain_fn(), kernel_fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain_fn), run(kernel_fn), run(kernel_fn), run(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


@contextlib.contextmanager
def plain_path(kernels=("prefill_attention", "decode_attention", "rmsnorm")):
    """Swap the plain PyTorch versions in for the named kernel wrappers."""
    from ecg_byte_tpu_torch.ops import attention, attention_decode, attention_resident, rmsnorm

    swaps = {
        "prefill_attention": (attention_resident, "resident_attention", attention.grouped_attention),
        "decode_attention": (attention_decode, "decode_attention_fused", attention.decode_attention),
        "rmsnorm": (rmsnorm, "rmsnorm", rmsnorm.rmsnorm_plain),
    }
    with contextlib.ExitStack() as stack:
        for name in kernels:
            stack.enter_context(mock.patch.object(*swaps[name]))
        yield


def _to_f32(x):
    return {k: v.float() for k, v in x.items()} if isinstance(x, dict) else x.float()


def counters():
    from ecg_byte_tpu_torch.ops import attention_decode, attention_resident, rmsnorm

    return {
        "prefill_attention": attention_resident.resident_attention,
        "decode_attention": attention_decode.decode_attention_fused,
        "rmsnorm": rmsnorm.rmsnorm,
    }


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

    phase("2. build")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"CUDA kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_info.get('seconds', 0.0):.1f} s)")
    for line in _cuda.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())


def kernels_phase():
    import torch

    from ecg_byte_tpu_torch.ops import attention, attention_decode, attention_resident, rmsnorm

    phase("3. kernels vs plain")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    report = {}

    def record(name, shape, err, ms, plain_ms, main):
        print(f"{name} {shape}: max|d| {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(shape=shape, ms=ms, plain_ms=plain_ms)

    with torch.inference_mode():
        # K1: (B, S, H, KH, D), 37 left-pad positions; the first is the main path's
        for b, s, h, kh, d in [(1, 1024, 32, 8, 64), (1, 2048, 32, 8, 64),
                               (1, 1024, 25, 25, 64), (1, 256, 8, 1, 256)]:
            qg, k, v = randn(b, s, kh, h // kh, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, :37] = 0
            got = attention_resident.resident_attention(qg, k, v, mask)
            want = attention.grouped_attention(qg, k, v, mask)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), "K1: non-finite output"
            valid = mask.bool()
            g, w = got.float()[valid], want.float()[valid]
            # the tolerance of tests/test_attention_resident.py: bf16 P.V
            # rounding and another summation order
            assert torch.allclose(g, w, atol=2e-2, rtol=2e-2), "K1 disagrees with plain"
            ms, plain_ms = time_in_turns(
                lambda: attention.grouped_attention(qg, k, v, mask),
                lambda: attention_resident.resident_attention(qg, k, v, mask), 10)
            record("prefill_attention", [b, s, h, kh, d], (g - w).abs().max().item(),
                   ms, plain_ms, main=(s, h) == (1024, 32))

        # K2: (B, S_max, H, KH, D), unfilled tail and left padding
        for b, s, h, kh, d in [(1, 1152, 32, 8, 64), (4, 1152, 32, 8, 64),
                               (1, 1152, 25, 25, 64), (4, 1152, 25, 25, 64)]:
            q, kc, vc = randn(b, 1, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[:, -s // 4:] = 0
            mask[0, :3] = 0
            got = attention_decode.decode_attention_fused(q, kc, vc, mask)
            want = attention.decode_attention(q, kc, vc, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert torch.isfinite(got.float()).all() and err <= 2e-2, f"K2 max|d| {err}"
            ms, plain_ms = time_in_turns(
                lambda: attention.decode_attention(q, kc, vc, mask),
                lambda: attention_decode.decode_attention_fused(q, kc, vc, mask), 100)
            record("decode_attention", [b, s, h, kh, d], err, ms, plain_ms,
                   main=(b, h) == (1, 32))

        # K3: rows x 2048; the decode row is the main path's commonest call
        for shape in [(1024, 2048), (1, 2048)]:
            x = randn(*shape)
            w = torch.randn(shape[-1], generator=gen, device=dev)
            got = rmsnorm.rmsnorm(x, w, 1e-5)
            want = rmsnorm.rmsnorm_plain(x, w, 1e-5)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            assert (diff <= bf16_ulp(want)).all(), "K3 off by more than 1 bf16 ulp"
            ms, plain_ms = time_in_turns(lambda: rmsnorm.rmsnorm_plain(x, w, 1e-5),
                                         lambda: rmsnorm.rmsnorm(x, w, 1e-5), 200)
            record("rmsnorm", list(shape), diff.max().item(), ms, plain_ms,
                   main=shape[0] == 1)
    return report


def make_dataset(root):
    """Synthetic ptb_500 tree, BPE tokenizer and a random full-width model's
    checkpoint under ``root``."""
    import numpy as np
    import torch

    from ecg_byte_tpu.tokenizer import BpeTokenizer
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
    from ecg_byte_tpu_torch.train.checkpoint import save_checkpoint

    subprocess.run(
        [sys.executable, "-m", "ecg_byte_tpu.cli.make_synthetic", "--data_root", "data",
         "--n_train", "24", "--n_val", "2", "--n_test", str(N_TEST),
         "--seg_len", str(SEG_LEN), "--seed", "0"],
        cwd=root, env=dict(os.environ, PYTHONPATH=REPO), check=True,
        capture_output=True, timeout=300,
    )
    stats = np.load(os.path.join(root, "data/ptb_500_dataset_stats.npy"),
                    allow_pickle=True).item()
    with open(os.path.join(root, "data/sampled_ecg_files_24.txt")) as f:
        train = [np.load(os.path.join(root, p)) for p in f.read().split()]
    corpus = "".join(
        quantized_to_string(normalize_quantize(
            torch.from_numpy(s), stats["percentile_1"], stats["percentile_99"])[1])
        for s in train
    )
    bpe = BpeTokenizer.train(corpus, NUM_MERGES)
    bpe.save(os.path.join(root, f"data/tokenizer_{NUM_MERGES}.pkl"))
    params, config, _ = build_model(MODEL, bpe.vocab, torch.device("cuda"))
    save_checkpoint(os.path.join(root, "runs/0/ckpt"), "best_model", params)
    return bpe.vocab, config


def main_path_phase(root):
    import torch

    from ecg_byte_tpu_torch.cli import main as cli_main

    phase("4. main path: cli.main --inference, random Llama-3.2-1B at full width")
    vocab, config = make_dataset(root)
    print(f"{MODEL}: {config.num_layers} layers, hidden {config.hidden_size}, "
          f"{config.num_heads}/{config.num_kv_heads} heads of {config.head_dim}, "
          f"vocab {config.vocab_size}, {config.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.chdir(root):
        result = cli_main.main([
            "--inference", "--dev", "--model", MODEL, "--dataset", "ptb_500",
            "--tokenizer_check", f"tokenizer_{NUM_MERGES}", "--num_merges", str(NUM_MERGES),
            "--percentiles", "data/ptb_500_dataset_stats.npy", "--checkpoint", "ckpt",
            "--eval_batch_size", "1",
        ])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    serving, records = result["serving"], result["records"]
    prefills, steps = serving["records"], serving["decode_steps"]
    forwards = prefills + steps
    print(f"launches {launches}; {prefills} prefills, {steps} decode steps")
    expected = {"prefill_attention": config.num_layers * prefills,
                "decode_attention": config.num_layers * steps,
                "rmsnorm": (2 * config.num_layers + 1) * forwards}
    assert prefills == 5 * N_TEST, f"{prefills} records decoded"
    for name, n in launches.items():
        assert n > 0 and n == expected[name], f"{name}: {n} launches, expected {expected[name]}"
    for r in records:
        toks = r["tokens"]
        assert toks.shape == (1, 128) and toks.min() >= 0 and toks.max() < config.vocab_size
    assert min(serving["prompt_lens"]) >= 1024, serving["prompt_lens"]
    ms_step = serving["decode_ms_per_step"]
    print(f"bucketed prompt lengths {serving['prompt_lens']}; prefill "
          f"{serving['prefill_ms_mean']:.2f} ms/record; decode {ms_step:.3f} ms/token "
          f"= {1e3 / ms_step:.1f} tok/s at batch 1 (host clock around synchronize)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"phase wall {wall:.1f} s")
    return launches, serving


def paths_phase(root):
    import numpy as np
    import torch

    from ecg_byte_tpu.tokenizer import load_vocab_and_merges
    from ecg_byte_tpu.utils.file_utils import align_signal_text_files
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset
    from ecg_byte_tpu_torch.models import transformer as T

    phase(f"5. kernel path vs plain path: one prompt + {TEACHER_FORCED} teacher-forced tokens")
    dev = torch.device("cuda")
    data = os.path.join(root, "data")
    vocab, merges = load_vocab_and_merges(os.path.join(data, f"tokenizer_{NUM_MERGES}.pkl"))
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

    before = {k: fn.launches for k, fn in counters().items()}
    kern = run(params, config)
    mid = {k: fn.launches for k, fn in counters().items()}
    with plain_path():
        plain = run(params, config)
        # the same weights computed in f32 by the plain versions: the
        # reference both bf16 paths are held against
        params32 = {k: ([{n: _to_f32(x) for n, x in layer.items()} for layer in v]
                        if k == "layers" else v.float()) for k, v in params.items()}
        ref = run(params32, config.replace(dtype="float32"))
        del params32
    after = {k: fn.launches for k, fn in counters().items()}
    assert all(mid[k] > before[k] for k in mid), "the kernel run launched no kernel"
    assert after == mid, "the plain runs launched a kernel"
    assert all(torch.isfinite(x).all() for x in (kern, plain, ref))
    d_kp, d_pr, d_kr = rel(kern, plain), rel(plain, ref), rel(kern, ref)
    print(f"prompt {n} tokens bucketed to {s}; max|dlogits|/max|logits| over "
          f"{d_kp.numel()} steps, worst / mean:")
    print(f"  kernel path vs plain path    {d_kp.max().item():.3e} / {d_kp.mean().item():.3e}")
    print(f"  plain path vs f32 reference  {d_pr.max().item():.3e} / {d_pr.mean().item():.3e}")
    print(f"  kernel path vs f32 reference {d_kr.max().item():.3e} / {d_kr.mean().item():.3e}")
    for name in counters():  # how far one kernel alone moves the logits
        with plain_path([k for k in counters() if k != name]):
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
        launches, serving = main_path_phase(root)
        paths_phase(root)
    assert "jax" not in sys.modules, "JAX was imported"
    sources = {
        "prefill_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_prefill.cu",
                              "ecg_byte_tpu/ops/attention_resident.py:73"),
        "decode_attention": ("cuda", "ecg_byte_tpu_torch/csrc/attention_decode.cu",
                             "ecg_byte_tpu/ops/attention_decode.py:90"),
        "rmsnorm": ("triton", "ecg_byte_tpu_torch/ops/rmsnorm.py",
                    "ecg_byte_tpu/ops/rmsnorm.py:59"),
    }
    kernels = []
    for kname, (route, source, replaces) in sources.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "shape": r["shape"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
