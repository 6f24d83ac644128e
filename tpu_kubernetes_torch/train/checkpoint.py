"""Checkpoints of the train state (port of
``tpu_kubernetes/train/checkpoint.py``, which uses orbax; the port writes
its own format with the same API).

A checkpoint is a step-numbered directory, ``<directory>/<step>/``,
holding one ``state.pt``: the state's tensors by their path in the tree
(``"params/layers/wq"``), saved from the host with ``torch.save``, and its
plain values (``state["step"]``). Each save is written under a temporary
name (``.tmp-<step>-<pid>``) and renamed into place, so a save that
crashes midway leaves nothing :func:`latest_step` would pick; the
``max_to_keep`` newest steps are kept. :func:`restore` reads a step back
with ``torch.load(weights_only=True)`` and copies it **into** ``like``'s
tensors, in place, on their device and in their dtype: a train step
captured before the restore (a CUDA graph reads its state where it lies)
then replays on the restored values. The port has no remote store: a
``://`` URL raises :class:`CheckpointError`. Every save and restore is
observed in ``tpu_train_checkpoint_seconds{op}``.

A sharded state (``train/trainer.py`` ``make_sharded_train_step``) is
saved and restored with its ``shardings``: one format for every mesh.
:func:`save` gathers each leaf to the whole tensor (every rank of the mesh
calls it) and rank 0 writes; :func:`restore` has every rank read the
whole tensors and copy its own block of each into ``like`` in place. So a
checkpoint moves between one card and any mesh. Every rank reads the same
directory: on several hosts it is shared storage.
"""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Any, Iterator

import torch

from tpu_kubernetes_torch.obs import REGISTRY
from tpu_kubernetes_torch.parallel.collectives import all_reduce_raw
from tpu_kubernetes_torch.parallel.mesh import (
    gather_tensor,
    shard_tensor,
    this_rank,
)

CKPT_SECONDS = REGISTRY.histogram(
    "tpu_train_checkpoint_seconds",
    "checkpoint save/restore wall time",
    labelnames=("op",),
)
STATE_FILE = "state.pt"


class CheckpointError(Exception):
    pass


def _local(directory: str | Path) -> Path:
    if "://" in str(directory):
        raise CheckpointError(
            f"{directory}: the port reads and writes local directories "
            "only (no remote store)")
    return Path(directory).absolute()


def _items(tree: dict, prefix: str = "") -> Iterator[tuple[str, dict, str]]:
    """(path, parent dict, key) of every leaf of a nested dict."""
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _items(value, f"{path}/")
        else:
            yield path, tree, key


def _steps(directory: Path) -> list[int]:
    """The complete checkpoints' steps, oldest first."""
    if not directory.is_dir():
        return []
    return sorted(int(d.name) for d in directory.iterdir()
                  if d.name.isdigit() and (d / STATE_FILE).is_file())


def _sharding(shardings: dict | None, path: str):
    """The sharding at ``path`` ("params/layers/wq") of a shardings tree,
    or None (no tree, or a host value)."""
    node = shardings
    for key in path.split("/") if shardings is not None else ():
        node = node[key] if isinstance(node, dict) else None
    return node


def _mesh_barrier(shardings: dict, device: torch.device) -> None:
    """Wait for every rank of the state's mesh (so rank 0's write is done
    when ``save`` returns anywhere)."""
    mesh = next(sh.mesh for _, parent, key in _items(shardings)
                if (sh := parent[key]) is not None)
    all_reduce_raw(torch.zeros(1, device=device),
                   mesh.group(mesh.axis_names))


def save(directory: str | Path, state: dict[str, Any], step: int,
         max_to_keep: int = 3, wait: bool = True,
         shardings: dict | None = None) -> None:
    """Write ``state`` (a nested dict of tensors and plain values) as
    checkpoint ``step``, then keep the ``max_to_keep`` newest. The write
    is synchronous, so ``wait`` (the reference's asynchronous save) has
    nothing to wait for. With ``shardings`` (a sharded state's) every rank
    of the mesh calls it: the leaves are gathered whole one at a time,
    rank 0 alone copies them to the host and writes, and every rank
    returns once the write is done."""
    del wait
    t0 = time.monotonic()
    root = _local(directory)
    tensors, values, device = {}, {}, None
    writer = shardings is None or this_rank() == 0
    for path, parent, key in _items(state):
        leaf = parent[key]
        if isinstance(leaf, torch.Tensor):
            device = leaf.device
            sh = _sharding(shardings, path)
            if sh is not None:
                leaf = gather_tensor(leaf, sh)   # every rank takes part
            if writer:
                # a compact host copy: a view saves its own elements alone
                tensors[path] = leaf.detach().to("cpu", copy=True)
        else:
            values[path] = leaf
    if not writer:
        _mesh_barrier(shardings, device)
        return
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp-{step}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"step": step, "tensors": tensors, "values": values},
               tmp / STATE_FILE)
    final = root / str(step)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(root)[:-max_to_keep]:
        shutil.rmtree(root / str(old))
    if shardings is not None:
        _mesh_barrier(shardings, device)
    CKPT_SECONDS.labels("save").observe(time.monotonic() - t0)


def latest_step(directory: str | Path) -> int | None:
    steps = _steps(_local(directory))
    return steps[-1] if steps else None


def restore(directory: str | Path, like: dict[str, Any],
            step: int | None = None, shardings: dict | None = None
            ) -> dict[str, Any]:
    """Copy checkpoint ``step`` (default: the latest) into ``like``'s
    tensors in place and set its plain values → ``like``. Raises
    :class:`CheckpointError` when there is no such checkpoint, or when its
    keys, shapes or dtypes differ from ``like``'s (then nothing of
    ``like`` has changed). With ``shardings``, ``like`` holds this rank's
    blocks, and each takes its block of the whole tensor."""
    t0 = time.monotonic()
    root = _local(directory)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise CheckpointError(f"no checkpoints under {directory}")
    path = root / str(step) / STATE_FILE
    if not path.is_file():
        raise CheckpointError(f"no checkpoint of step {step} under "
                              f"{directory}")
    blob = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)
    tensors, values = blob["tensors"], blob["values"]
    leaves = {p: (parent, key) for p, parent, key in _items(like)}
    wanted = {p for p, (parent, key) in leaves.items()
              if isinstance(parent[key], torch.Tensor)}
    plain = set(leaves) - wanted
    missing = sorted((wanted - set(tensors)) | (plain - set(values)))
    extra = sorted((set(tensors) - wanted) | (set(values) - plain))
    if missing or extra:
        raise CheckpointError(
            f"checkpoint {path} does not match the state: missing "
            f"{missing[:5]}, unexpected {extra[:5]}")
    rank = this_rank()
    for p in sorted(wanted):
        parent, key = leaves[p]
        dst, src = parent[key], tensors[p]
        sh = _sharding(shardings, p)
        local = (tuple(src.shape) if sh is None
                 else sh.local_shape(src.shape))
        if local != tuple(dst.shape) or src.dtype != dst.dtype:
            raise CheckpointError(
                f"checkpoint {path}: {p} is {src.dtype} "
                f"{tuple(src.shape)}, the state's {dst.dtype} "
                f"{tuple(dst.shape)}" + ("" if sh is None else
                                         f" (a block of {sh.spec})"))
    for p, (parent, key) in leaves.items():
        if p in wanted:
            sh = _sharding(shardings, p)
            src = tensors[p] if sh is None else shard_tensor(tensors[p], sh,
                                                             rank)
            parent[key].copy_(src)
        else:
            parent[key] = values[p]
    CKPT_SECONDS.labels("restore").observe(time.monotonic() - t0)
    return like

