"""End-to-end ECG-token dataset with byte-exact reference packing.

The port of ``ecg_byte_tpu/data/datasets.py``: the same packing, token for
token (left-padded signal region, ``-100`` label masking up to the answer,
cumsum position ids with pads pinned to 0, the ``pad_to_max + 4`` training
length), as numpy items.  A record is quantized with the port's
``normalize_quantize`` and BPE-encoded either on the host, item by item, by
the C++ trie of the port's ``tokenizer`` package, or once for the whole
dataset by the device encoder (``cache_tokens=True``,
``ops/bpe_encode.quantize_and_encode``): the two give the same token
streams.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.ops import bpe_encode
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import encode_text

_ECG_QA_DATASETS = (
    "ecg_qa_ptb_500",
    "ecg_qa_mimic_500",
    "ecg_qa_ptb_250",
    "ecg_qa_ptb_1250",
    "ecg_qa_ptb_2000",
)


@dataclasses.dataclass
class DataConfig:
    """Dataset knobs the reference passes via its argparse namespace."""

    dataset: str = "ptb_500"
    pad_to_max: int = 1020
    percentiles: Any = None  # stats dict or path to a .npy stats file
    inference: bool = False


def load_percentiles(percentiles) -> Dict[str, float]:
    """Accept a stats dict directly or a path to the saved stats .npy."""
    if percentiles is None:
        raise ValueError("percentiles (stats dict or .npy path) required")
    if isinstance(percentiles, dict):
        return percentiles
    return np.load(percentiles, allow_pickle=True).item()


def create_attention_like_mask(pad_id: int, numbers: Sequence[int]) -> List[int]:
    """0 on pads, 1 elsewhere (data_loader.py:22-23)."""
    return [0 if num == pad_id else 1 for num in numbers]


def create_position_ids(padded_sequence: Sequence[int], pad_token_id: int) -> np.ndarray:
    """cumsum over non-pad minus one, pads pinned to 0 (data_loader.py:26-31)."""
    seq = np.asarray(padded_sequence)
    mask = (seq != pad_token_id).astype(np.int64)
    position_ids = np.cumsum(mask) - 1
    position_ids[mask == 0] = 0
    return position_ids


def parse_question_answer(text_label, dataset: str):
    """Per-dataset Q/A extraction (data_loader.py:65-72)."""
    if dataset == "ptb_500":
        return "Could you please help me explain my ECG?", text_label
    if dataset == "mimic_500":
        question = text_label[0]["value"].replace("\n", "").replace("<ecg>", "")
        return question, text_label[1]["value"]
    if dataset in _ECG_QA_DATASETS:
        _question_type, question, answer = text_label[0], text_label[1], text_label[2]
        answer = " ".join(answer) if isinstance(answer, list) else answer
        return question, answer
    raise ValueError(f"unknown dataset {dataset!r}")


class ECGTokenDataset:
    """Signal+text pairs -> packed LM training / inference items."""

    def __init__(
        self,
        signal_path_list,
        text_path_list,
        vocab,
        merges,
        tokenizer=None,
        args: Optional[DataConfig] = None,
        cache_tokens: bool = False,
        device=None,
    ):
        """``cache_tokens`` encodes every record once, in batches, on
        ``device`` (default the CUDA card, which must exist; the CPU only
        when named)."""
        self.signal_path_list = np.array(signal_path_list)
        self.text_path_list = np.array(text_path_list)
        self.args = args
        self.vocab = vocab
        self.merges = merges
        self.tokenizer = tokenizer
        self.pad_id = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)
        self.bos_id = tokenizer.convert_tokens_to_ids(tokenizer.bos_token)
        self.eos_id = tokenizer.convert_tokens_to_ids(tokenizer.eos_token)
        self.sig_start_id = tokenizer.convert_tokens_to_ids(["<sig_start>"])
        self.sig_end_id = tokenizer.convert_tokens_to_ids(["<sig_end>"])
        self.percentiles = load_percentiles(args.percentiles)
        self._token_cache: Optional[List[List[int]]] = None
        if cache_tokens:
            self._token_cache = self._build_token_cache(resolve_device(device))

    def __len__(self) -> int:
        return len(self.signal_path_list)

    # -- signal -> BPE ids --------------------------------------------------

    def _encode_signal_host(self, signal: np.ndarray) -> List[int]:
        _, q = normalize_quantize(
            torch.from_numpy(np.asarray(signal, np.float32)),
            self.percentiles["percentile_1"], self.percentiles["percentile_99"],
        )
        return encode_text(quantized_to_string(q), self.merges)

    def _build_token_cache(self, device: torch.device, batch: int = 64) -> List[List[int]]:
        """Encode every record once on ``device``, ``batch`` records at a
        time: the matcher table is built there once, the stacked records
        are moved there and go through ``quantize_and_encode``."""
        table = bpe_encode.build_best_matcher(self.merges, device)
        p1 = self.percentiles["percentile_1"]
        p99 = self.percentiles["percentile_99"]
        cache: List[List[int]] = []
        for start in range(0, len(self.signal_path_list), batch):
            sigs = np.stack([np.load(p) for p in self.signal_path_list[start : start + batch]])
            signal = torch.from_numpy(sigs.astype(np.float32, copy=False)).to(device)
            ids, counts = bpe_encode.quantize_and_encode(signal, p1, p99, table)
            for row, cnt in zip(ids.cpu().numpy(), counts.cpu().numpy()):
                cache.append(row[: int(cnt)].tolist())
        return cache

    # -- item assembly ------------------------------------------------------

    def __getitem__(self, index: int):
        try:
            signal = np.load(self.signal_path_list[index])
            with open(self.text_path_list[index]) as f:
                text_label = json.load(f)
        except (FileNotFoundError, ValueError, OSError, KeyError) as e:
            print(f"Error loading files at index {index}: {e}")
            return None
        if signal is None or text_label is None:
            print(f"Invalid data at index {index}")
            return None

        try:
            question, answer = parse_question_answer(text_label, self.args.dataset)
            if self._token_cache is not None:
                bpe_ids = self._token_cache[index]
            else:
                bpe_ids = self._encode_signal_host(signal)
            tokenized_question = self.tokenizer(
                [question], return_tensors="np", add_special_tokens=False
            ).input_ids[0].tolist()
            tokenized_answer = self.tokenizer(
                [answer], return_tensors="np", add_special_tokens=False
            ).input_ids[0].tolist()
            tokenized_signal = self.tokenizer.convert_tokens_to_ids(
                [f"signal_{ids}" for ids in bpe_ids]
            )
        except Exception as e:
            print(f"Error processing data at index {index}: {e}")
            return None

        if self.args.inference:
            return self._prepare_inference(
                tokenized_signal, tokenized_question, answer, question
            )
        return self._prepare_training(
            tokenized_signal, tokenized_question, tokenized_answer, signal
        )

    def _prepare_inference(self, tokenized_signal, tokenized_question, answer, question):
        """bos + <sig_start> + signal + <sig_end> + question, no pads/eos
        (data_loader.py:91-99)."""
        inference_seq = (
            [self.bos_id]
            + self.sig_start_id
            + tokenized_signal
            + self.sig_end_id
            + tokenized_question
        )
        attention_mask = create_attention_like_mask(self.pad_id, inference_seq)
        return {
            "answer": answer,
            "question": question,
            "tokenized_signal": np.asarray(inference_seq, dtype=np.int64),
            "attn_mask": np.asarray(attention_mask, dtype=np.float32),
        }

    def _prepare_training(
        self, tokenized_signal, tokenized_question, tokenized_answer, signal
    ):
        """Left-padded signal region + QA + eos (data_loader.py:101-132)."""
        qa_len = len(tokenized_question) + len(tokenized_answer)
        available_space = self.args.pad_to_max - qa_len

        if len(tokenized_signal) > available_space:
            tokenized_signal = (
                [self.bos_id]
                + self.sig_start_id
                + tokenized_signal[:available_space]
                + self.sig_end_id
            )
        elif len(tokenized_signal) < available_space:
            tokenized_signal = (
                [self.pad_id] * (available_space - len(tokenized_signal))
                + [self.bos_id]
                + self.sig_start_id
                + tokenized_signal
                + self.sig_end_id
            )
        else:
            tokenized_signal = (
                [self.bos_id] + self.sig_start_id + tokenized_signal + self.sig_end_id
            )

        full_seq = tokenized_signal + tokenized_question + tokenized_answer
        padded_masked_sample = full_seq + [self.eos_id]

        labels = (
            [-100] * (len(tokenized_signal) + len(tokenized_question))
            + tokenized_answer
            + [self.eos_id]
        )
        position_ids = create_position_ids(padded_masked_sample, self.pad_id)
        attention_mask = create_attention_like_mask(self.pad_id, padded_masked_sample)

        assert len(padded_masked_sample) == len(attention_mask) == (
            self.args.pad_to_max + 4
        ), (
            f"Lengths don't match: masked_sample ({len(padded_masked_sample)}), "
            f"attention_mask ({len(attention_mask)})"
        )

        return {
            "tokenized_signal": np.asarray(padded_masked_sample, dtype=np.int64),
            "attn_mask": np.asarray(attention_mask, dtype=np.float32),
            "quantized_signal_ids_input": np.asarray(labels, dtype=np.int64),
            "position_ids": position_ids,
            "signal": signal,
        }
