"""Plots of ``ecg_byte_tpu/utils/viz_utils.py``, drawn only where matplotlib
is installed (the machine with the card has none), and the training loss
record, ``train_val_loss.json``, written always."""

from __future__ import annotations

import json
import os


def _pyplot():
    """matplotlib's pyplot on the file backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_train_val_loss(train_loss, val_loss, directory_path: str) -> None:
    os.makedirs(directory_path, exist_ok=True)
    with open(os.path.join(directory_path, "train_val_loss.json"), "w") as f:
        json.dump({"train_loss": list(train_loss), "val_loss": list(val_loss)}, f)
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(8, 5))
    plt.plot(train_loss, label="train")
    plt.plot(val_loss, label="val")
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend()
    plt.title("Training and validation loss")
    plt.tight_layout()
    plt.savefig(os.path.join(directory_path, "train_val_loss.png"))
    plt.close()


def plot_original_vs_decoded(decoded_signal, original_array, lead_index: int = 0,
                             out_dir: str = "./pngs") -> None:
    """One lead of a record and of its BPE round trip, as a PNG."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    plt.figure(figsize=(12, 4))
    plt.plot(original_array[lead_index], label="original", alpha=0.8)
    plt.plot(decoded_signal[lead_index], label="decoded", alpha=0.8)
    plt.legend()
    plt.title(f"Original vs decoded, lead {lead_index}")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "original_vs_decoded.png"))
    plt.close()
