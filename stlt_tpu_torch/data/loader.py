"""Host-side batching loader with background prefetch.

Own copy of ``stlt_tpu/data/loader.py::Loader`` (single process): per-epoch
shuffling, collation to static shapes, and a background thread that builds
the next batches while the device computes. Every batch has exactly
``batch_size`` rows; the last partial batch repeats row 0 and carries a
boolean ``valid`` mask.

:func:`to_device` is the port's counterpart of the JAX ``device_prefetch``:
it turns each numpy batch into pinned host tensors and copies them with
``.to(device, non_blocking=True)`` one batch ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def to_device(iterator, device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each numpy batch as tensors on ``device``, staging batch k+1
    before yielding batch k. Integer arrays become int64."""
    pin = torch.device(device).type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype in (torch.int32, torch.int16, torch.uint8):
                t = t.long()
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    pending = None
    for batch in iterator:
        staged = put(batch)
        if pending is not None:
            yield pending
        pending = staged
    if pending is not None:
        yield pending


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable[[List[dict]], Dict[str, np.ndarray]],
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        workers: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self._pool = None
        self.epoch = 0

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        return self._pool

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _make_batch(self, idxs: np.ndarray, rng: Optional[np.random.Generator]):
        if rng is not None:
            # One child generator per sample, seeded up front: deterministic
            # whatever the thread scheduling.
            seeds = rng.integers(0, 2**63 - 1, size=len(idxs))
            work = list(zip(idxs, seeds))
            fetch = lambda pair: self.dataset.__getitem__(
                int(pair[0]), rng=np.random.default_rng(int(pair[1]))
            )
        else:
            work = list(idxs)
            fetch = lambda i: self.dataset[int(i)]
        if self.workers > 1 and work:
            samples = list(self._executor().map(fetch, work))
        else:
            samples = [fetch(w) for w in work]
        valid = np.zeros((self.batch_size,), dtype=bool)
        valid[: len(samples)] = True
        samples = samples + [samples[0]] * (self.batch_size - len(samples))
        batch = self.collate(samples)
        batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        train = getattr(getattr(self.dataset, "config", None), "train", False)
        rng = np.random.default_rng((self.seed + 1, self.epoch)) if train else None
        self.epoch += 1
        chunks = [
            order[i * self.batch_size: (i + 1) * self.batch_size] for i in range(len(self))
        ]
        if self.prefetch <= 0:
            for chunk in chunks:
                yield self._make_batch(chunk, rng)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded put: give up if the consumer abandoned the iterator.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in chunks:
                    if not put(self._make_batch(chunk, rng)):
                        return
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
