"""Host data loader: epoch-seeded shuffling, sharding, collation, prefetch.

A copy of ``ecg_byte_tpu/data/loader.py`` (importing that module runs
``ecg_byte_tpu/data/__init__.py``, which imports JAX).  Batches are numpy
arrays; the caller moves them to its device.  Invalid (``None``) items are
dropped; a fully invalid batch yields ``None``.  ``with_kept=True`` yields
``(batch, kept)``, ``kept`` the places in the batch's chunk of the items
that loaded (``parallel/batches.steps`` renumbers a global batch with them).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

_PAD_VALUE_BY_KEY = {
    "attn_mask": 0,
    "attn_mask2": 0,
    "quantized_signal_ids_input": -100,
    "position_ids": 0,
}


def collate(items: List[Dict], pad_id: Optional[int] = None) -> Optional[Dict]:
    """Stack item dicts into batch arrays.

    Strings pass through as lists; equal-shape arrays stack; 1-D sequences
    of different lengths are LEFT-padded (pad_id for token streams, 0 for
    masks/position ids, -100 for labels), matching the left-pad convention
    of the packing (data_loader.py:17,109).
    """
    items = [it for it in items if it is not None]
    if not items:
        return None
    batch: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str) or isinstance(vals[0], list):
            batch[key] = vals
            continue
        arrs = [np.asarray(v) for v in vals]
        if arrs[0].ndim == 1 and len({a.shape[0] for a in arrs}) > 1:
            width = max(a.shape[0] for a in arrs)
            fill = _PAD_VALUE_BY_KEY.get(key, pad_id if pad_id is not None else 0)
            out = np.full((len(arrs), width), fill, dtype=arrs[0].dtype)
            for i, a in enumerate(arrs):
                out[i, width - a.shape[0] :] = a  # left pad
            batch[key] = out
        else:
            batch[key] = np.stack(arrs)
    return batch


class DataLoader:
    """Iterable over collated batches of a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        pad_id: Optional[int] = None,
        num_shards: int = 1,
        shard_index: int = 0,
        drop_last: bool = False,
        prefetch: bool = True,
        prefetch_depth: int = 2,
        with_kept: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_id = pad_id
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.prefetch_depth = prefetch_depth
        self.with_kept = with_kept
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle permutation (torch DistributedSampler parity)."""
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = self._indices()
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            items = [self.dataset[int(i)] for i in chunk]
            batch = collate(items, pad_id=self.pad_id)
            if self.with_kept:
                yield batch, [j for j, it in enumerate(items) if it is not None]
            else:
                yield batch

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        _END, _ERR = object(), object()
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded put that notices consumer abandonment: without the
            # stop check an early `break` in the consumer would leave this
            # thread blocked on q.put forever (one leaked thread +
            # prefetch_depth buffered batches per abandoned epoch).
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._batches():
                    if not put(b):
                        return
                put(_END)
            except BaseException as e:  # surface worker errors to the consumer
                put((_ERR, e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()
