"""The training loss record: ``train_val_loss.json`` always, the PNG plot of
``ecg_byte_tpu/utils/viz_utils.plot_train_val_loss`` where matplotlib is
installed (the machine with the card has none)."""

from __future__ import annotations

import json
import os


def plot_train_val_loss(train_loss, val_loss, directory_path: str) -> None:
    os.makedirs(directory_path, exist_ok=True)
    with open(os.path.join(directory_path, "train_val_loss.json"), "w") as f:
        json.dump({"train_loss": list(train_loss), "val_loss": list(val_loss)}, f)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
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
