"""Toy cells for the CPU tests: the benchmark's code beside the toy
configurations and workloads of ``fixtures/``."""

import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def make_here(root, extra=()):
    """A copy of the benchmark's code beside the toy configurations and
    workloads of ``fixtures/``."""
    for d in ("drivers", "metrics", "arch", *extra):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, d))
    for d in ("configs", "workloads"):
        shutil.copytree(os.path.join(HERE, "fixtures", d), os.path.join(root, d))
    return str(root)


TINY_CELLS = ("tiny-gpt2.lora", "tiny-llama.lora", "tiny-llama.serve")
TINY_BENCH = {
    "end_to_end": [{"name": "setup_s", "unit": "s"},
                   {"name": "train_tokens_per_s", "unit": "tokens/s",
                    "workloads": list(TINY_CELLS[:2])},
                   {"name": "serve_tokens_per_s", "unit": "tokens/s",
                    "workloads": list(TINY_CELLS[2:])}],
    "per_layer": [],
}
