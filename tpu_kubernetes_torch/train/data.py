"""Input pipeline: memory-mapped token shards → batches → tensors on the
device, with background prefetch (port of
``tpu_kubernetes/train/data.py``).

* **The same batches as the reference.** :func:`local_batches` draws the
  same ``np.random.default_rng(seed)`` permutation per epoch and takes
  the same stripe, so for the same token file and seed (and
  ``start_step``) it yields the reference's batches, array for array.
* **Over a mesh.** The reference assembles each host's stripe into one
  global array (``global_batches``); the port runs one process per card,
  so :func:`global_batches` hands each rank its own rows of that global
  batch, in the batch sharding's order (``train/trainer.py``
  ``local_rows``): the host's stripe is its block of the global batch, and
  the rank takes its rows out of it. Ranks that differ only in ``tensor``
  get the same rows.
* **Prefetch.** A background thread stages the next batches (file reads
  and the host→device copy) while the current step runs.

Token files are flat little-endian arrays (uint16 for vocab < 65536 else
uint32), memory-mapped; nothing is ever fully loaded.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch


class DataError(Exception):
    pass


class TokenDataset:
    """Flat token file → (seq+1)-length training sequences.

    ``path`` may be a single file or a directory of ``*.bin`` shards
    (concatenated in sorted order). dtype is inferred from ``vocab_size``.
    Sequences are non-overlapping windows; the trailing remainder is
    dropped."""

    def __init__(self, path: str | Path, seq: int, vocab_size: int):
        p = Path(path)
        files = sorted(p.glob("*.bin")) if p.is_dir() else [p]
        if not files or not all(f.is_file() for f in files):
            raise DataError(f"no token shards at {path}")
        dtype = np.uint16 if vocab_size <= 0xFFFF else np.uint32
        self._maps = [np.memmap(f, dtype=dtype, mode="r") for f in files]
        self._sizes = [m.shape[0] for m in self._maps]
        self.seq = seq
        self.window = seq + 1  # next-token loss consumes seq+1 tokens
        self.n_sequences = sum(s // self.window for s in self._sizes)
        if self.n_sequences == 0:
            raise DataError(
                f"{path}: {sum(self._sizes)} tokens < one window of {self.window}"
            )

    def __len__(self) -> int:
        return self.n_sequences

    def sequence(self, index: int) -> np.ndarray:
        """The index-th window as int32 (window,)."""
        if index < 0 or index >= self.n_sequences:
            raise IndexError(index)
        for m, size in zip(self._maps, self._sizes):
            n = size // self.window
            if index < n:
                start = index * self.window
                return np.asarray(m[start:start + self.window], dtype=np.int32)
            index -= n
        raise IndexError(index)  # unreachable


def local_batches(
    dataset: TokenDataset,
    global_batch: int,
    *,
    process_index: int = 0,
    process_count: int = 1,
    seed: int = 0,
    epochs: int | None = None,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """This process's stripe of each global batch: (global_batch / P,
    seq+1) int32, striped by sequence index and reshuffled each epoch with
    a seeded permutation. ``start_step`` skips the first N global batches
    without loading them (step s yields the same batch in every run)."""
    p, P = process_index, process_count
    if global_batch % P:
        raise DataError(f"global batch {global_batch} not divisible by {P} hosts")
    local = global_batch // P
    if dataset.n_sequences < global_batch:
        raise DataError(
            f"dataset has {dataset.n_sequences} sequences < one global "
            f"batch of {global_batch}"
        )
    steps_per_epoch = dataset.n_sequences // global_batch
    rng = np.random.default_rng(seed)
    # fast-forward whole epochs: burn their permutations, not their batches
    epoch = start_step // steps_per_epoch
    skip = start_step % steps_per_epoch
    for _ in range(epoch):
        rng.permutation(dataset.n_sequences)
    while epochs is None or epoch < epochs:
        order = rng.permutation(dataset.n_sequences)
        for s in range(skip, steps_per_epoch):
            base = s * global_batch
            idx = order[base + p:base + global_batch:P]
            yield np.stack([dataset.sequence(int(i)) for i in idx[:local]])
        skip = 0
        epoch += 1


def global_batches(local_iter: Iterator[np.ndarray], sharding: Any, *,
                   global_batch: int | None = None, process_index: int = 0,
                   process_count: int = 1, accum_steps: int = 1
                   ) -> Iterator[np.ndarray]:
    """Each host's stripes (``local_batches`` with this host's
    ``process_index`` of ``process_count``) → this rank's rows of the
    global batch under ``sharding`` (the train step's batch sharding):
    the host's stripe is block ``process_index`` of the global batch (the
    reference's ``make_array_from_process_local_data``), and this rank's
    rows (:func:`~tpu_kubernetes_torch.train.trainer.local_rows`) must lie
    in it, as they do when ranks are numbered host by host."""
    from tpu_kubernetes_torch.train.trainer import local_rows

    # the rows are this rank's for every batch: found once, here, on the
    # caller's thread (not on a prefetch thread, while the process group
    # may be torn down)
    rows_of = {}

    def take(local: np.ndarray) -> np.ndarray:
        rows = global_batch or local.shape[0] * process_count
        if rows not in rows_of:
            rows_of[rows] = local_rows(sharding, rows, accum_steps)
        idx = rows_of[rows]
        start = process_index * local.shape[0]
        if idx.min() < start or idx.max() >= start + local.shape[0]:
            raise DataError(
                f"this rank's rows {idx.min()}..{idx.max()} of the global "
                f"batch of {rows} are not in host {process_index}'s block "
                f"[{start}, {start + local.shape[0]})")
        return local[idx - start]

    if global_batch is not None:
        take(np.zeros((global_batch // process_count, 1)))
    return (take(local) for local in local_iter)


def prefetch(it: Iterator[Any], depth: int = 2) -> Iterator[Any]:
    """Stage up to ``depth`` items ahead on a background thread so host
    work (file reads, the host→device copy) overlaps the running step.
    Exceptions re-raise at the consumption point. When the consumer stops
    early (generator close), the worker is released."""
    if depth < 1:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # a worker between items notices within its 0.1 s put timeout:
        # gone before the caller tears down what it was staging on
        t.join(timeout=1.0)


def input_pipeline(
    path: str | Path, global_batch: int, seq: int, vocab_size: int,
    device: torch.device | str, *, seed: int = 0, prefetch_depth: int = 2,
    start_step: int = 0, sharding: Any = None, process_index: int = 0,
    process_count: int = 1, accum_steps: int = 1,
) -> Iterator[torch.Tensor]:
    """The full pipeline: memmap shards → batches → int32 tensors on
    ``device`` → prefetch. A resumed job passes its step as
    ``start_step``, so it carries on through the data instead of
    replaying it from the top. With a batch ``sharding`` (a sharded
    step's) each rank gets its rows of the global batch
    (:func:`global_batches`), reading this host's stripe."""
    ds = TokenDataset(path, seq, vocab_size)
    batches = local_batches(ds, global_batch, process_index=process_index,
                            process_count=process_count, seed=seed,
                            start_step=start_step)
    if sharding is not None:
        batches = global_batches(batches, sharding,
                                 global_batch=global_batch,
                                 process_index=process_index,
                                 process_count=process_count,
                                 accum_steps=accum_steps)
    it = (torch.from_numpy(np.ascontiguousarray(b)).to(device)
          for b in batches)
    return prefetch(it, depth=prefetch_depth)
