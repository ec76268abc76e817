"""Every name in ``BENCHMARK.json`` resolves to its file, and a
configuration, traffic mix, metric reader and window loop are added as new
files, with no existing file edited."""

import json
import os
import time

import pytest

from bench_port import harness
from bench_port.spec import spec
from tiny import make_here

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    work = harness.load_json(harness.workload_file(cell))
    assert work["config"] == entry["config"] and work["chips"] == entry["chips"]
    assert os.path.exists(harness.driver_file(work["driver"]))
    cfg = harness.load_json(harness.config_file(work["config"]))
    s = spec(cfg)
    assert os.path.exists(os.path.join(harness.HERE, "arch", f"{s.model_type}.py"))
    assert set(work["limits"]) and all(v > 0 for v in work["limits"].values())
    reported = harness.metrics_for(BENCH, cell, "end_to_end")
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    layer = harness.metrics_for(BENCH, cell, "per_layer")
    assert layer and all(m["moves"] in [r["name"] for r in reported] for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_resolves(metric):
    reader = harness.load_module(harness.metric_file(metric), "t_" + metric.replace(".", "_"))
    assert callable(reader.read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_names_its_source_and_cuts(entry):
    root = os.path.dirname(harness.HERE)
    cfg = harness.load_json(os.path.join(root, entry["file"]))
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["published"]) | {"vocab_size"}
    assert harness.config_file(entry["name"]) == os.path.join(root, entry["file"])


def test_a_cell_is_added_as_new_files_only(tmp_path):
    """A new configuration, traffic mix, window loop and metric reader: the
    harness finds each by its name and runs the cell."""
    here = make_here(tmp_path / "bench")
    with open(os.path.join(here, "configs", "tiny-llama.json")) as f:
        cfg = json.load(f)
    cfg.update(num_hidden_layers=3, source="a new configuration")
    with open(os.path.join(here, "configs", "tiny-llama-3.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "workloads", "tiny-llama.lora.json")) as f:
        work = json.load(f)
    work.update(config="tiny-llama-3", driver="train_twice", batch=2)
    with open(os.path.join(here, "workloads", "tiny-llama-3.new.json"), "w") as f:
        json.dump(work, f)
    with open(os.path.join(here, "drivers", "train_twice.py"), "w") as f:
        f.write("from bench_port.drivers.train import *  # noqa: F401,F403\n"
                "from bench_port.drivers import train as _t\n\n\n"
                "def measure(sess, seconds):\n"
                "    out = _t.measure(sess, seconds)\n"
                "    out['twice'] = 2\n"
                "    return out\n")
    with open(os.path.join(here, "metrics", "twice.new.py"), "w") as f:
        f.write("def read(run):\n    return run.window.get('twice')\n")
    bench = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "train_tokens_per_s", "unit": "tokens/s"}],
             "per_layer": [{"name": "twice.new", "unit": "count"}]}
    view = {}
    orig = harness.read_metrics

    def capture(entries, run, here=harness.HERE):
        view["window"] = run.window
        return orig(entries, run, here)

    r = harness.run("tiny-llama-3.new", 12, 0.2, False, device="cpu", t0=time.perf_counter(),
                    bench=bench, here=here)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "train_tokens_per_s"}
    run = type("Run", (), {"window": {"twice": 2}})
    reader = harness.load_module(harness.metric_file("twice.new", here), "t_twice")
    assert harness.read_metrics([{"name": "twice.new", "unit": "count"}], run, here) == {
        "twice.new": {"value": 2, "unit": "count"}}
    assert reader.read(run) == 2
