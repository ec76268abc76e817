"""On the card, at each cell's own size: the control (the reference in fp8
in the program's place) and each planted fault fail the cell's committed
limits on three seeds, and the program passes them.  Skips without the
cards a cell needs; run on the card with
``python -m pytest bench_port/tests -m card``."""

import pytest

from bench_port import calibrate, harness

CELLS = [(w["name"], w["chips"]) for w in harness.benchmark()["workloads"]]
SEEDS = [2147483801, 2147483802, 2147483803]


@pytest.mark.card
@pytest.mark.parametrize("cell, chips", CELLS, ids=[c for c, _ in CELLS])
def test_control_and_faults_fail_at_the_cells_size(cell, chips, card):
    import torch

    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    limits = harness.load_json(harness.workload_file(cell))["limits"]
    if chips == 1:
        rows = calibrate._all_seeds(0, 1, cell, SEEDS, set(SEEDS), "cuda")
    else:
        rows = harness.with_ranks(chips, "cuda", calibrate._all_seeds,
                                  (cell, SEEDS, set(SEEDS), "cuda"))
    for row in rows:
        ok, check = harness.judge({k: row[k] for k in limits}, limits)
        assert ok == (row["kind"] == "program"), (row["seed"], row["kind"], check)
