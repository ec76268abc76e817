"""Offline BERTScore on the port's BERT (``models/bert.py``).

The port of ``ecg_byte_tpu/utils/bertscore.py``.  HF ``evaluate``'s
BERTScore downloads its scorer model; this computes the same metric against
a local BERT: point ``$ECG_BYTE_BERTSCORE_MODEL`` at an HF BERT checkpoint
directory (config.json + *.safetensors + vocab.txt).  ``score`` follows the
BERTScore paper (Zhang et al., ICLR 2020):

1. embed candidate and reference with BERT on ``device`` (default the CUDA
   card), taking hidden layer ``$ECG_BYTE_BERTSCORE_LAYER`` (default: the
   bert_score library's layer 9 for 12-layer BERTs, else the last layer);
2. L2-normalize token embeddings, so cosine similarity is a dot product;
3. greedy matching on the host: recall averages each reference token's
   best match in the candidate, precision each candidate token's best
   match in the reference; F1 is their harmonic mean.  [CLS]/[SEP] carry
   zero weight in the averages but remain match targets.

No idf weighting and no baseline rescaling (``evaluate``'s bertscore with
``lang="en"`` reports raw scores).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MODEL_ENV = "ECG_BYTE_BERTSCORE_MODEL"
LAYER_ENV = "ECG_BYTE_BERTSCORE_LAYER"


def _default_layer(num_layers: int) -> int:
    # bert_score's tuned layer for bert-base-uncased (12 layers) is 9; for
    # other depths, the final layer
    return 9 if num_layers == 12 else num_layers


class LocalBertScorer:
    """BERTScore P/R/F1 against a local BERT checkpoint directory."""

    def __init__(self, model_dir: str, layer: Optional[int] = None, max_len: int = 512,
                 batch_size: int = 32, device=None):
        from ecg_byte_tpu_torch.models.bert import load_hf_bert
        from ecg_byte_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

        self.device = torch.device("cuda" if device is None else device)
        self.params, self.config = load_hf_bert(model_dir, self.device)
        lower = self._lower_case(model_dir)
        self.tokenizer = WordPieceTokenizer(os.path.join(model_dir, "vocab.txt"), lower_case=lower)
        self.layer = layer if layer is not None else _default_layer(self.config.num_layers)
        if not 0 <= self.layer <= self.config.num_layers:
            raise ValueError(f"layer {self.layer} out of range for a "
                             f"{self.config.num_layers}-layer checkpoint")
        self.max_len = min(max_len, self.config.max_position_embeddings)
        self.batch_size = batch_size

    @staticmethod
    def _lower_case(model_dir: str) -> bool:
        try:
            with open(os.path.join(model_dir, "tokenizer_config.json")) as f:
                return bool(json.load(f).get("do_lower_case", True))
        except (OSError, ValueError):
            return True

    def _encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        seqs = [self.tokenizer.encode(t, max_len=self.max_len) for t in texts]
        width = max(len(s) for s in seqs)
        ids = np.full((len(seqs), width), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask

    @torch.inference_mode()
    def _embed(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        from ecg_byte_tpu_torch.models.bert import bert_forward

        hs, _ = bert_forward(self.params, self.config, torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(mask).to(self.device), return_all_layers=True)
        h = hs[self.layer].float()
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)
        return h.cpu().numpy()

    def _embeddings(self, texts: List[str]):
        """Yield (emb (S, H) f32 normalized, weight (S,) f32) per text."""
        for start in range(0, len(texts), self.batch_size):
            chunk = texts[start : start + self.batch_size]
            ids, mask = self._encode_batch(chunk)
            h = self._embed(ids, mask)
            for row in range(len(chunk)):
                n = int(mask[row].sum())
                w = np.ones(n, np.float32)
                w[0] = 0.0  # [CLS]
                w[n - 1] = 0.0  # [SEP]
                yield h[row, :n], w

    def score(self, references: List[str], candidates: List[str]) -> Dict[str, List[float]]:
        """Per-pair precision/recall/F1 (bert_score's output convention)."""
        ref_embs = list(self._embeddings(references))
        cand_embs = list(self._embeddings(candidates))
        precision, recall, f1 = [], [], []
        for (re_, rw), (ce, cw) in zip(ref_embs, cand_embs):
            if cw.sum() == 0 or rw.sum() == 0:
                precision.append(0.0)
                recall.append(0.0)
                f1.append(0.0)
                continue
            sim = ce @ re_.T  # (n_cand, n_ref) cosine (rows are normalized)
            p = float((sim.max(axis=1) * cw).sum() / cw.sum())
            r = float((sim.max(axis=0) * rw).sum() / rw.sum())
            precision.append(p)
            recall.append(r)
            f1.append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)
        return {"precision": precision, "recall": recall, "f1": f1}


@functools.lru_cache(maxsize=2)
def _cached_scorer(model_dir: str, layer: Optional[int], device: str) -> LocalBertScorer:
    return LocalBertScorer(model_dir, layer, device=device)


def local_scorer_from_env(device=None) -> Optional[LocalBertScorer]:
    """The scorer ``$ECG_BYTE_BERTSCORE_MODEL`` names, on ``device``
    (default the CUDA card), or None."""
    model_dir = os.environ.get(MODEL_ENV)
    if not model_dir or not os.path.isdir(model_dir):
        return None
    layer_s = os.environ.get(LAYER_ENV)
    layer = int(layer_s) if layer_s else None
    return _cached_scorer(model_dir, layer, str(torch.device("cuda" if device is None else device)))
