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


def plot_attention_on_signal(signal, attention_array, lead_index: int, sample_count: int,
                             out_dir: str = "./pngs/attention") -> None:
    """One lead's trace with its attention weight filled underneath."""
    plt = _pyplot()
    if plt is None:
        return
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    fig, ax1 = plt.subplots(figsize=(12, 4))
    ax1.plot(signal[lead_index], color="tab:blue", lw=0.8)
    ax1.set_ylabel("amplitude")
    ax2 = ax1.twinx()
    att = attention_array[lead_index]
    ax2.fill_between(np.arange(len(att)), att, color="tab:red", alpha=0.3)
    ax2.set_ylabel("attention")
    plt.title(f"Attention over signal, lead {lead_index}, sample {sample_count}")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, f"attn_sample{sample_count}_lead{lead_index}.png"))
    plt.close()


def plot_text_attention_weights(tokens, attention, sample_count: int,
                                out_dir: str = "./pngs/attention") -> None:
    """A bar per text token, its attention weight."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    n = min(len(tokens), len(attention))
    plt.figure(figsize=(max(6, n * 0.4), 4))
    plt.bar(range(n), attention[:n])
    plt.xticks(range(n), tokens[:n], rotation=90, fontsize=6)
    plt.ylabel("attention")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, f"text_attn_sample{sample_count}.png"))
    plt.close()


def plot_token_rank_frequency(token_counts, out_dir: str = "./pngs") -> None:
    """Token frequencies against their rank, log-log."""
    plt = _pyplot()
    if plt is None:
        return
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    freqs = sorted(token_counts.values(), reverse=True)
    plt.figure(figsize=(6, 4))
    plt.loglog(np.arange(1, len(freqs) + 1), freqs)
    plt.xlabel("rank")
    plt.ylabel("frequency")
    plt.title("Token rank-frequency")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "token_rank_frequency.png"))
    plt.close()


def plot_token_length_distribution(token_lengths, out_dir: str = "./pngs") -> None:
    """A histogram of the tokens per ECG."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    plt.figure(figsize=(6, 4))
    plt.hist(token_lengths, bins=50)
    plt.xlabel("tokens per ECG")
    plt.ylabel("count")
    plt.title("Encoded length distribution")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, "token_length_distribution.png"))
    plt.close()


def plot_bpe_segments(signal, segment_map, lead_index: int, seg_len: int,
                      out_dir: str = "./pngs") -> None:
    """Coloured spans over one lead: the samples each BPE token covers."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    plt.figure(figsize=(12, 4))
    plt.plot(signal[lead_index], color="black", lw=0.6)
    cmap = plt.get_cmap("tab20")
    lead_start = lead_index * seg_len
    lead_end = lead_start + seg_len
    for i, (start, end) in enumerate(segment_map):
        s = max(start, lead_start) - lead_start
        e = min(end, lead_end) - lead_start
        if e <= 0 or s >= seg_len or e <= s:
            continue
        plt.axvspan(s, e, color=cmap(i % 20), alpha=0.25)
    plt.title(f"BPE token spans, lead {lead_index}")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, f"bpe_segments_lead{lead_index}.png"))
    plt.close()
