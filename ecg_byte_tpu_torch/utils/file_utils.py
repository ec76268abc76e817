"""File pairing and sampling: the port's copy of ``ecg_byte_tpu/utils/file_utils.py``.

Signal and text files pair by the ``(\\d+)_(\\d+)`` index in their names,
sorted on the index intersection; fractional subsampling uses
``random.sample``.
"""

from __future__ import annotations

import glob
import os
import random
import re
from typing import List, Optional, Tuple


def ensure_directory_exists(directory_path: str) -> None:
    os.makedirs(directory_path, exist_ok=True)


def _extract_indices(filename: str) -> Optional[Tuple[int, int]]:
    match = re.search(r"(\d+)_(\d+)", os.path.basename(filename))
    return tuple(map(int, match.groups())) if match else None


def align_signal_text_files(signal_dir: str, text_dir: str) -> Tuple[List[str], List[str]]:
    """Pair ecg_*.npy with text_*.json by shared (instance, segment) index."""
    signal_dict = {
        idx: f for f in glob.glob(os.path.join(signal_dir, "*.npy"))
        if (idx := _extract_indices(f)) is not None
    }
    text_dict = {
        idx: f for f in glob.glob(os.path.join(text_dir, "*.json"))
        if (idx := _extract_indices(f)) is not None
    }
    common = sorted(set(signal_dict) & set(text_dict))
    return [signal_dict[i] for i in common], [text_dict[i] for i in common]


def sample_N_percent_from_lists(list1, list2=None, N: float = 0.05):
    if list2 is not None and len(list1) != len(list2):
        raise ValueError("Both lists must have the same length")
    idx = random.sample(range(len(list1)), max(1, int(len(list1) * N)))
    sampled1 = [list1[i] for i in idx]
    if list2 is None:
        return sampled1
    return sampled1, [list2[i] for i in idx]
