"""Epoch runners ``trainer`` and ``validater``: the port of
``ecg_byte_tpu/train/runner.py``.

The same semantics: per-epoch shuffling via ``set_epoch``, a None batch
skipped, ``--dev`` stopping after 10 steps, a ``best_train_model`` save
every 50k steps unless ``--toy``, and the average loss of the epoch.  The
step loss stays on the device: it accumulates as a device tensor and the
host reads it once per ``log_every``-step window and once at the end.

Two deliberate differences: no ``tqdm`` progress bar (the machine with the
card has no tqdm), and an exception from a step propagates.  The JAX
runner prints and skips it, which would hide a failing kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ecg_byte_tpu_torch.train.checkpoint import save_checkpoint


def model_batch(raw: Dict) -> Dict:
    """Adapt a dataset batch to the train-step input contract."""
    return {
        "input_ids": np.asarray(raw["tokenized_signal"], np.int32),
        "attn_mask": np.asarray(raw["attn_mask"], np.int32),
        "labels": np.asarray(raw["quantized_signal_ids_input"], np.int32),
        "position_ids": np.asarray(raw["position_ids"], np.int32),
    }


def _run_epoch(batches, run_fn, *, dev: bool, log_fn, log_every: int, key: str, epoch: int,
               after_step=None):
    n_batches, dev_count, tokens = 0, 0, 0
    total_loss = 0.0  # host float, updated once per window
    window_sum, window_n = None, 0  # device accumulator
    for step, batch in enumerate(batches):
        if batch is None:
            print(f"Skipping invalid batch at step {step}")
            continue
        inputs = model_batch(batch)
        loss = run_fn(inputs)
        tokens += inputs["input_ids"].size
        window_sum = loss if window_sum is None else window_sum + loss
        window_n += 1
        n_batches += 1
        if window_n >= log_every:
            w = window_sum.item()  # the only device -> host sync
            total_loss += w
            if log_fn is not None:
                log_fn({f"{key}_step_loss": w / window_n, "epoch": epoch,
                        f"{key}_step": step, "window_size": window_n})
            window_sum, window_n = None, 0
        if after_step is not None:
            after_step(step)
        if dev:
            dev_count += 1
            if dev_count == 10:
                break
    if window_sum is not None:
        total_loss += window_sum.item()
    avg = total_loss / n_batches if n_batches > 0 else float("inf")
    return {"average_loss": avg, "steps": n_batches, "tokens": tokens}


def trainer(state, step_fn: Callable, dataloader, rng, *, epoch: int,
            directory_path: Optional[str] = None, dev: bool = False, toy: bool = False,
            log_fn: Optional[Callable] = None, desc: str = "Training", log_every: int = 32):
    """Run one training epoch; returns ``(state, {"average_loss", "steps",
    "tokens"})``."""
    dataloader.set_epoch(epoch)
    holder = {"state": state}

    def run(batch):
        holder["state"], loss = step_fn(holder["state"], batch, rng)
        return loss

    def after_step(step):
        if (step + 1) % 50000 == 0 and not toy and directory_path:
            save_checkpoint(directory_path, f"best_train_model_{epoch}_{step}",
                            holder["state"], epoch=epoch)

    print(f"{desc}: epoch {epoch + 1}, {len(dataloader)} batches")
    out = _run_epoch(dataloader, run, dev=dev, log_fn=log_fn, log_every=log_every,
                     key="train", epoch=epoch, after_step=after_step)
    return holder["state"], out


def validater(state, eval_fn: Callable, dataloader, *, epoch: int, dev: bool = False,
              log_fn: Optional[Callable] = None, desc: str = "Validating",
              log_every: int = 32):
    """Run one validation pass; returns ``{"average_loss", "steps", "tokens"}``."""
    print(f"{desc}: epoch {epoch + 1}, {len(dataloader)} batches")
    return _run_epoch(dataloader, lambda batch: eval_fn(state, batch), dev=dev,
                      log_fn=log_fn, log_every=log_every, key="val", epoch=epoch)
