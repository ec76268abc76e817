#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19's grid paths over NCCL, each rank on a card of
its own: ``python3 tools/grid_nccl.py`` on a machine with four cards.

Phase 19 runs its ranks on one card, over gloo; this runs the same paths
where ``parallel/distributed.choose_backend`` picks NCCL (the
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` route of
``distributed.all_gather`` and ``reduce_scatter``): ``cli.main --dis --gpus
0,1`` at ``--tp 2`` and at ``--fsdp 2`` (exact launch counts per rank, rank
0 alone writing), then phase 19's four-rank harness (``chip_smoke.grid_rank``,
T = 2 x F = 2) on cards 0-3: each rank's losses, step ms (CUDA events) and
the ms of its tp, fsdp and data-group collectives replayed alone, and its
tp decode; last, the one-process step on card 0, its loss and each LoRA
group's distance from the grid's.  Data are made as chip_smoke makes them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    name, smi = cs.device_phase()
    print("cards", torch.cuda.device_count(), flush=True)
    cs.build_phase()
    from ecg_byte_tpu_torch.cli import main as cli_main
    from ecg_byte_tpu_torch.cli.common import _PRESETS
    from ecg_byte_tpu_torch.parallel.spawn import spawn
    with tempfile.TemporaryDirectory(prefix="run19n_") as root:
        vocab, merges = cs.make_data(root)
        long_root = os.path.join(root, "long")
        long_vocab, long_merges = cs.make_data(long_root, **cs.LONG)
        g = cs.GRID
        L = _PRESETS[g.llm]().num_layers
        n_train, n_val = (max(1, int(n * 0.25)) for n in (cs.N_TRAIN, cs.N_VAL))
        args = cs._cli_args() + ["--model", g.llm, "--peft", "--dev", "--toy", "--batch_size",
                                 str(g.batch), "--pad_to_max", str(g.pad_to_max)]
        for flags, replay in ((["--tp", "2"], False), (["--fsdp", "2"], True)):
            cs.zero_launches()
            t1 = time.perf_counter()
            with contextlib.chdir(root):
                out = cli_main.main(args + ["--dis", "--gpus", "0,1", "--ports", "0"] + flags)
            wall = time.perf_counter() - t1
            assert [r["backend"] for r in out["ranks"]] == ["nccl"] * 2, out["ranks"]
            want = {**cs.dis_train_counts(L, cs.rank_steps(n_train, g.batch, 1, 0),
                                          cs.rank_steps(n_val, g.batch, 1, 0), replay=replay),
                    "bpe_match": 2, "bpe_chain": 2}
            cs.check_dis_ranks(out, [want] * 2, f"NCCL cli.main {flags}")
            s = out["training"]
            print(f"NCCL {flags}: {s['steps']} steps, train loss {s['train_loss']}, "
                  f"{s['seconds'] / s['steps'] * 1e3:.1f} ms a step with its data and evaluation "
                  f"(host clock); wall {wall:.1f} s", flush=True)
        t1 = time.perf_counter()
        harness = spawn(cs.grid_rank, (((root, vocab, merges), (long_root, long_vocab, long_merges)),
                                       g, "cuda"), world=4, backend="nccl", devices=[0, 1, 2, 3],
                        timeout_s=600)
        print(f"NCCL harness in {time.perf_counter() - t1:.1f} s", flush=True)
        for r in harness:
            print(f"rank {r['rank']}: lm loss {r['lm'][0]:.6f}, long loss {r['long'][0]:.6f}, "
                  f"step {r['step_ms']:.2f} ms; collectives "
                  + ", ".join(f"{k} {ms:.2f} ms ({n} calls)" for k, (ms, n) in
                              r["collectives"].items())
                  + f"; decode {r['decode'][0].tolist()}", flush=True)
        for key, (data, pad, n) in (("lm", ((root, vocab, merges), g.pad_to_max, g.batch)),
                                    ("long", ((long_root, long_vocab, long_merges),
                                              g.long_pad_to_max, 1))):
            params, config, lora, batch = cs._grid_model(*data, g, torch.device("cuda"), g.layers,
                                                         n, pad)
            one = cs.grid_lm_run(params, config, lora, batch)
            print(f"{key}: one process {one[0]:.6f}, NCCL grid {harness[0][key][0]:.6f}; "
                  + ", ".join(f"{k} {(torch.linalg.vector_norm(harness[0][key][2][k] - v) / torch.linalg.vector_norm(v)).item():.2e}"
                              for k, v in one[2].items()), flush=True)
            del params, lora, batch
            torch.cuda.empty_cache()
    print(smi)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
