"""Host data pipeline: background prefetch + device placement (the port of
``repro.data.pipeline``).

A loader thread stays ``prefetch`` steps ahead of the training loop, so
host data preparation overlaps compute; each batch is placed on ``device``
as tensors when the loop takes it.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.device import resolve


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    def __init__(self, dataset: SyntheticDataset, global_batch: int,
                 start_step: int = 0, prefetch: int = 2, device="cuda"):
        self.dataset = dataset
        self.global_batch = global_batch
        self.device = resolve(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch(step, self.global_batch)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, to_device(batch, self.device)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
