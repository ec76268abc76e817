"""``--tp`` and ``--fsdp`` through ``cli.main`` on the CPU: four gloo ranks
(``--device cpu --gpus 0,0,0,0 --tp 2 --fsdp 2``) against one process.

- 7 training records at a global batch of 4 (dp x F = 2 data ranks, 2 rows
  each; the second batch of each epoch is short), LoRA dropout on: the
  steps and tokens are one process's, the per-epoch losses within rtol
  1e-5 and the same on every rank; ``best_model`` is the whole tree, its
  adapters within 1e-6 of one process's largest and its base equal; every checkpoint written by rank 0
  alone, as often as one process writes it; and ``cli.main --inference``
  serves it;
- the refusals, before any rank starts: a T that does not divide the KV
  heads, a T x F that does not divide the world, and a global batch that
  dp x F does not divide.

The ranks run one torch thread each; each test fails past
``TIME_LIMIT_S``, its ranks killed (the fixtures of
``tests/test_torch_ddp_cli.py``).
"""

import os
import shutil

import numpy as np
import pytest
from test_torch_ddp_cli import MAIN, _close_trees, _tree, data, run_in  # noqa: F401

from ecg_byte_tpu_torch.cli import main as cli_main
from ecg_byte_tpu_torch.train import checkpoint

GRID = ["--dis", "--gpus", "0,0,0,0", "--ports", "0", "--tp", "2", "--fsdp", "2"]


def test_cli_main_tp_fsdp_matches_one_process_and_serves(run_in):  # noqa: F811
    before = len(checkpoint.written)
    one = cli_main.main(MAIN)["training"]
    roles = checkpoint.written[before:]
    one_best = _tree(os.path.join(one["directory"], "best_model.pt"))
    shutil.rmtree("runs")
    out = cli_main.main(MAIN + GRID)
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        got = r["training"]
        assert got["steps"] == one["steps"] == 4 and got["tokens"] == one["tokens"]
        np.testing.assert_allclose(got["train_loss"], one["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["val_loss"], one["val_loss"], rtol=1e-5)
        assert got["train_loss"] == ranks[0]["training"]["train_loss"]
        assert got["val_loss"] == ranks[0]["training"]["val_loss"]
    assert ranks[0]["written"] == roles and "crash_model" in roles
    assert all(r["written"] == [] for r in ranks[1:])
    best = _tree(os.path.join(out["training"]["directory"], "best_model.pt"))
    # the whole tree, in the one-process shapes
    for name in ("trainable", "base"):
        assert [t.shape for t in checkpoint.leaves(best[name])] == [
            t.shape for t in checkpoint.leaves(one_best[name])]
    _close_trees(best["trainable"], one_best["trainable"], 1e-6)
    _close_trees(best["base"], one_best["base"], 0.0)
    served = cli_main.main(MAIN + ["--inference", "--checkpoint",
                                   os.path.basename(out["training"]["directory"])])
    assert served["serving"]["records"] > 0


@pytest.mark.parametrize("extra,message", [
    (["--gpus", "0,0,0", "--tp", "3"], "--tp 3 must divide the model's num_kv_heads (2)"),
    (["--gpus", "0,0,0", "--tp", "2"], "--tp 2 x --fsdp 1 = 2 must divide the 3 ranks of --dis"),
    (["--gpus", "0,0,0,0", "--tp", "2", "--fsdp", "2", "--batch_size", "3"],
     "--batch_size 3 is the global batch; --dis over 4 ranks at --tp 2 splits it over dp x "
     "fsdp = 2 ranks and needs a multiple of 2"),
], ids=["kv-heads", "world", "batch"])
def test_cli_main_grid_refuses(run_in, extra, message):  # noqa: F811
    with pytest.raises(SystemExit, match=message.replace("(", r"\(").replace(")", r"\)")):
        cli_main.main(MAIN + ["--dis", "--ports", "0"] + extra)
