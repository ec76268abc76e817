"""Two-stage datasets: the CLIP and ViT image pipelines and MERL's signal
scaling.

The port of ``ecg_byte_tpu/data/two_stage.py`` (``ECGCLIPPretrain``,
``ECGCLIPFinetune``, ``pad_to_max_seq``), item for item.  The 12 x L ECG
is min-max scaled to an 8-bit grayscale image (replicated to RGB), resized
with Pillow's bicubic filter (CLIP: shortest edge to 224, then a center
crop; ViT: straight to 224 x 224), rescaled by 1/255 and normalized with
the published means and stds.  The resize is ``data/image.py``, Pillow's
algorithm without Pillow, byte for byte; the CLIP path computes only the
columns its center crop keeps.  The ViT mask draws from the global
``np.random``, as the JAX dataset does, so one seed gives the same masks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional

import numpy as np

from ecg_byte_tpu_torch.data.datasets import (
    create_attention_like_mask,
    create_position_ids,
    parse_question_answer,
)
from ecg_byte_tpu_torch.data.image import resize_bicubic

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
VIT_IMAGE_MEAN = (0.5, 0.5, 0.5)
VIT_IMAGE_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class TwoStageConfig:
    """Knobs of the reference pretrain/finetune argparse namespaces."""

    dataset: str = "ptb_500"
    model: Optional[str] = None
    percentiles: Any = None
    num_patches: int = 196
    image_size: int = 224
    seed: int = 0
    pad_to_max: int = 1022
    inference: bool = False


def _signal_to_gray(signal: np.ndarray) -> np.ndarray:
    """ECG -> the uint8 (12, L) image whose three RGB channels the JAX
    package stacks (all equal)."""
    smin, smax = signal.min(), signal.max()
    normalized = (signal - smin) / (smax - smin + 1e-6) * 255
    return normalized.astype(np.uint8)


def _normalize_chw(gray: np.ndarray, mean, std) -> np.ndarray:
    arr = np.stack([gray] * 3, axis=-1).astype(np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.transpose(arr, (2, 0, 1))


def clip_process_image(signal: np.ndarray, image_size: int = 224) -> np.ndarray:
    """CLIPImageProcessor: shortest-edge resize -> center crop -> normalize."""
    gray = _signal_to_gray(signal)
    h, w = gray.shape
    scale = image_size / min(w, h)
    new_w = max(int(round(w * scale)), image_size)
    new_h = max(int(round(h * scale)), image_size)
    top = max((new_h - image_size) // 2, 0)
    left = max((new_w - image_size) // 2, 0)
    out = resize_bicubic(gray, new_w, new_h, out_cols=slice(left, left + image_size))
    out = out[top:top + image_size]
    return _normalize_chw(out, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)


def vit_process_image(signal: np.ndarray, image_size: int = 224) -> np.ndarray:
    """ViTImageProcessor: direct (size, size) resize -> normalize."""
    out = resize_bicubic(_signal_to_gray(signal), image_size, image_size)
    return _normalize_chw(out, VIT_IMAGE_MEAN, VIT_IMAGE_STD)


def _tokenize_padded(tokenizer, text: str, max_length: int, add_special_tokens: bool = False):
    """Right-padded fixed-width text encoding (CLIP max 77, MERL max 64)."""
    out = tokenizer([text], return_tensors="np", padding="max_length", max_length=max_length,
                    truncation=True, add_special_tokens=add_special_tokens)
    return out.input_ids[0].astype(np.int64), out.attention_mask[0].astype(np.int64)


def _minmax_merl(signal: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] then x1000: MERL's scaling."""
    smin, smax = signal.min(), signal.max()
    return ((signal - smin) / (smax - smin + 1e-6) * 1000).astype(np.float32)


def _load(signal_path, text_path, index, parse):
    """(signal, parse(text label)), or None (printed) when a file is missing
    or malformed, as the reference's datasets skip such a record."""
    try:
        signal = np.load(signal_path)
        with open(text_path) as f:
            return signal, parse(json.load(f))
    except (OSError, ValueError, KeyError, IndexError, TypeError) as e:
        print(f"Error loading files at index {index}: {e}")
        return None


def _report(text_label):
    """The report text of a pretrain record (a mimic conversation's answer)."""
    return text_label[1]["value"] if isinstance(text_label, list) else text_label


class ECGCLIPPretrain:
    """Stage-1 dataset."""

    def __init__(self, signal_path_list, text_path_list, tokenizer=None, args=None):
        self.signal_path_list = np.array(signal_path_list)
        self.text_path_list = np.array(text_path_list)
        self.tokenizer = tokenizer
        self.args = args

    def __len__(self) -> int:
        return len(self.signal_path_list)

    def __getitem__(self, index: int):
        loaded = _load(self.signal_path_list[index], self.text_path_list[index], index, _report)
        if loaded is None:
            return None
        signal, text_label = loaded
        a = self.args
        item = {
            "clip_input_ids": 1, "clip_att_mask": 1, "vit_pixel": 1, "clip_pixel": 1, "mask": 1,
            "norm_signal": _minmax_merl(signal), "resnet_input_ids": 1, "resnet_att_mask": 1,
        }
        if a.model in ("clip", "clip_vit"):
            item["clip_input_ids"], item["clip_att_mask"] = _tokenize_padded(
                self.tokenizer, text_label, 77)
            item["clip_pixel"] = clip_process_image(signal, a.image_size)
        if a.model in ("vit", "clip_vit"):
            item["mask"] = np.random.rand(a.num_patches) < 0.75
            item["vit_pixel"] = vit_process_image(signal, a.image_size)
        if a.model == "resnet":
            # a WordPiece (MedCPT) tokenizer adds its [CLS] .. [SEP]; the
            # byte tokenizer stays bare
            item["resnet_input_ids"], item["resnet_att_mask"] = _tokenize_padded(
                self.tokenizer, text_label, 64,
                add_special_tokens=getattr(self.tokenizer, "bert_specials", False))
        return item


def pad_to_max_seq(tokenized_sequence: List[int], pad_id: int, bos_id: int, eos_id: int,
                   pad_to_max: int) -> List[int]:
    """The reference's ``pad_to_max``: total length always ``pad_to_max + 2``
    (bos and eos outside the budget)."""
    seq = list(tokenized_sequence)
    if len(seq) > pad_to_max:
        return [bos_id] + seq[:pad_to_max] + [eos_id]
    if len(seq) < pad_to_max:
        return [pad_id] * (pad_to_max - len(seq)) + [bos_id] + seq + [eos_id]
    return [bos_id] + seq + [eos_id]


class ECGCLIPFinetune:
    """Stage-2 dataset: ``<sig_start> <signal> <sig_end> Q A`` packing."""

    def __init__(self, signal_path_list, text_path_list, tokenizer=None, args=None):
        self.signal_path_list = np.array(signal_path_list)
        self.text_path_list = np.array(text_path_list)
        self.tokenizer = tokenizer
        self.args = args
        t = tokenizer
        self.pad_id = t.convert_tokens_to_ids(t.pad_token)
        self.bos_id = t.convert_tokens_to_ids(t.bos_token)
        self.eos_id = t.convert_tokens_to_ids(t.eos_token)
        self.sig_start_id = t.convert_tokens_to_ids(["<sig_start>"])
        self.sig_end_id = t.convert_tokens_to_ids(["<sig_end>"])
        self.signal_id = t.convert_tokens_to_ids(["<signal>"])

    def __len__(self) -> int:
        return len(self.signal_path_list)

    def _encoder_inputs(self, signal: np.ndarray, answer: str):
        a = self.args
        item = {"mask": 1, "clip_pixel": 1, "clip_att_mask": 1, "vit_pixel": 1,
                "clip_input_ids": 1, "norm_signal": _minmax_merl(signal)}
        if a.model in ("clip_model", "clip_vit_model"):
            item["clip_input_ids"], item["clip_att_mask"] = _tokenize_padded(
                self.tokenizer, answer, 77)
            item["clip_pixel"] = clip_process_image(signal, a.image_size)
        if a.model in ("vit_model", "clip_vit_model"):
            item["mask"] = np.random.rand(a.num_patches) < 0.75
            item["vit_pixel"] = vit_process_image(signal, a.image_size)
        return item

    def __getitem__(self, index: int):
        loaded = _load(self.signal_path_list[index], self.text_path_list[index], index,
                       lambda label: parse_question_answer(label, self.args.dataset))
        if loaded is None:
            return None
        signal, (question, answer) = loaded
        enc = self._encoder_inputs(signal, answer)
        tokenized_question = self.tokenizer(
            [question], return_tensors="np", add_special_tokens=False).input_ids[0].tolist()
        tokenized_answer = self.tokenizer(
            [answer], return_tensors="np", add_special_tokens=False).input_ids[0].tolist()
        if self.args.inference:
            return self._prepare_inference(tokenized_question, answer, question, enc)
        return self._prepare_training(tokenized_question, tokenized_answer, enc)

    def _prepare_inference(self, tokenized_question, answer, question, enc):
        """Two prompts: seq1 without and seq2 with the ``<signal>`` slot."""
        seq1 = [self.bos_id] + self.sig_start_id + self.sig_end_id + tokenized_question
        seq2 = ([self.bos_id] + self.sig_start_id + self.signal_id + self.sig_end_id
                + tokenized_question)
        item = {
            "answer": answer,
            "question": question,
            "tokenized_signal": np.asarray(seq1, np.int64),
            "tokenized_signal2": np.asarray(seq2, np.int64),
            "attn_mask": np.asarray(create_attention_like_mask(self.pad_id, seq1), np.float32),
            "attn_mask2": np.asarray(create_attention_like_mask(self.pad_id, seq2), np.float32),
        }
        item.update(enc)
        return item

    def _prepare_training(self, tokenized_question, tokenized_answer, enc):
        """Packing with the pad and bos labels masked to -100."""
        full_seq = (self.sig_start_id + self.signal_id + self.sig_end_id + tokenized_question
                    + tokenized_answer)
        labels = [-100] * (len(tokenized_question) + 3) + tokenized_answer
        pad_to = self.args.pad_to_max
        padded = pad_to_max_seq(full_seq, self.pad_id, self.bos_id, self.eos_id, pad_to)
        position_ids = create_position_ids(padded, self.pad_id)
        padded_labels = np.asarray(
            pad_to_max_seq(labels, self.pad_id, self.bos_id, self.eos_id, pad_to), np.int64)
        padded_labels[padded_labels == self.pad_id] = -100
        padded_labels[padded_labels == self.bos_id] = -100
        attention_mask = create_attention_like_mask(self.pad_id, padded)
        if not len(padded) == len(attention_mask) == pad_to + 2:
            raise ValueError(f"lengths differ: sequence {len(padded)}, attention mask "
                             f"{len(attention_mask)}, expected {pad_to + 2}")
        item = {
            "tokenized_signal": np.asarray(padded, np.int64),
            "attn_mask": np.asarray(attention_mask, np.float32),
            "quantized_signal_ids_input": padded_labels,
            "position_ids": position_ids,
        }
        item.update(enc)
        return item
