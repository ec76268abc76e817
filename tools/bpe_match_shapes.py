#!/usr/bin/env python3
"""Time the BPE match kernel's launch choices at the shapes the token cache
launches it, on one CUDA card: ``python3 tools/bpe_match_shapes.py``.

``data/datasets._build_token_cache`` encodes a dataset 64 records at a
time, so a call is (64, N) but for a split's last batch: N = 6,000 for
12 x 500 records (``ptb_500``, 400 merges), N = 30,000 for 12 x 2,500
(3,500 merges).  At each such shape, and at chip_smoke's (256, 30000), it
times (CUDA graphs) every segment length (16, 32, 64) at 4, 8 and 16 warps
a block, each held to the plain version exactly first; then, at
``bpe_match.choose_sweep``'s choice, the table layouts the design dropped:
full rows only, staged as far as shared memory holds them (the rest read
through L1), and no rows staged.  Data and tokenizers are made as
chip_smoke makes them.  The card's name and power limit come first; the
last line is a JSON object of every reading.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SHAPES_6000 = (2, 24, 64)  # records of 12 x 500
SHAPES_30000 = (1, 6, 12, 64, 256)  # records of 12 x 2,500
VARIANTS = [(seg, warps) for seg in (16, 32, 64) for warps in (4, 8, 16)]


def time_shape(label, q, table, full_only):
    """Every (segment, warps) at this q, exact first; then the chosen one
    over ``full_only``, the same automaton in full rows (None: ``table``
    has nothing but full rows), staged as far as they fit and not at all
    (a table with compact rows is always staged whole)."""
    from ecg_byte_tpu_torch.ops import bpe_match

    want = bpe_match.longest_match_plain(q, table)
    b, n = q.shape
    runs = [(f"{s}/{w}", q, table, s, w, -1) for s, w in VARIANTS]
    chosen = bpe_match.choose_sweep(b, n)
    tag = f"{chosen[0]}/{chosen[1]}"
    if full_only is None:
        runs.append((f"{tag} unstaged", q, table, *chosen, 0))
    else:
        runs.append((f"{tag} full rows only", q, full_only, *chosen, -1))
        runs.append((f"{tag} full rows unstaged", q, full_only, *chosen, 0))
    for name, q_, t, s, w, h in runs:
        cs.check_match(bpe_match.sweep_match(q_, t, s, w, h), want, f"{label} {name}")
    ms = cs.time_graphed([lambda r=r: bpe_match.sweep_match(*r[1:]) for r in runs])
    best = min(zip(ms[:len(VARIANTS)], VARIANTS))
    print(f"{label} ({b}, {n}): {cs.sweep_layout(table.sweep)}; choose_sweep {chosen}, best "
          f"{best[1]} at {best[0]:.4f} ms; " +
          ", ".join(f"{r[0]} {t:.4f}" for r, t in zip(runs, ms)), flush=True)
    return {"shape": [b, n], "chosen": list(chosen),
            "device_ms": {r[0]: t for r, t in zip(runs, ms)}}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bpe_match_shapes: no CUDA device", file=sys.stderr)
        return 1
    from ecg_byte_tpu_torch.cli.make_synthetic import make_signal
    from ecg_byte_tpu_torch.ops import bpe_encode
    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize

    _, smi = cs.device_phase()
    cs.build_phase()
    dev = torch.device("cuda")
    readings = []
    with tempfile.TemporaryDirectory(prefix="bpe_match_shapes_") as root:
        _, merges = cs.make_data(root)
        _, big_merges = cs.make_data(root, **cs.BIG)
        _, p1, p99 = cs.load_split(root, "ptb_500")
        rng = np.random.default_rng(1)
        small = np.stack([make_signal(rng, i % 2 == 0, cs.SEG_LEN) for i in range(64)])
        big, big_p1, big_p99 = cs.load_split(root, cs.BIG["name"])
        for label, signals, lo, hi, vocab, sizes in (
                ("400 merges", small, p1, p99, merges, SHAPES_6000),
                ("3,500 merges", big, big_p1, big_p99, big_merges, SHAPES_30000)):
            table = bpe_encode.build_automaton(vocab, dev)
            full_only = None
            if table.sweep.full < table.sweep.states:
                full_only = bpe_encode.build_automaton(vocab, dev, sweep_budget=1 << 30)
            sig = torch.from_numpy(signals).to(dev)
            q_all = normalize_quantize(sig, lo, hi)[1].reshape(len(signals), -1).contiguous()
            for b in sizes:
                readings.append(time_shape(label, q_all[:b].contiguous(), table, full_only))
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
