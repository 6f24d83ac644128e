"""Device mesh + logical-axis sharding rules (port of
``tpu_kubernetes/parallel/mesh.py``).

The reference names axes, annotates shardings with logical names and lets
XLA insert the collectives. The port runs one process per card (SPMD):
a *device* is a rank of ``torch.distributed``, a :class:`Mesh` lays the
ranks out over named axes, and each axis has one process group per line
of ranks along it (:meth:`Mesh.group`). A *sharding* is, per leaf, which
dimension is split over which mesh axes (:func:`logical_to_spec`'s
answer): a rank holds the contiguous block of each split dimension at its
coordinate, and the model writes the collectives out by hand
(``parallel/collectives.py``). Axes, as in the reference:

  data     — pure data parallelism (gradients all-reduced)
  fsdp     — fully-sharded data parallel (the ``embed`` dimension of every
             weight split, all-gathered per layer as it is used)
  tensor   — Megatron tensor parallelism (heads/kv/mlp/vocab split)
  sequence — context parallelism (``parallel/ring_attention.py``)
  expert   — expert parallelism for MoE; a data axis for the rest
  stage    — pipeline parallelism (``parallel/pipeline.py``)

Logical param axes (``models/llama.py`` ``logical_axes``) map to mesh axes
through :data:`DEFAULT_RULES`; size-1 axes are dropped, so the same model
code runs on any mesh shape. ``parse_mesh_shape`` is the port's own copy
of ``tpu_kubernetes/topology/tpu.py``'s.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "fsdp", "expert", "stage", "tensor", "sequence")

# logical axis → mesh axis (None = replicate), the reference's table
DEFAULT_RULES: dict[str, str | None] = {
    "batch": "data",
    "fsdp_batch": "fsdp",
    "embed": "fsdp",
    "heads": "tensor",
    "kv": "tensor",
    "mlp": "tensor",
    "vocab": "tensor",
    "layer": None,
    "seq": "sequence",
    "expert": "expert",
}

# mesh axes that carry the batch (data-like); "expert" is data-like for the
# non-MoE path, GShard-style
DATA_AXES = ("data", "fsdp", "expert")

def parse_mesh_shape(spec: str) -> dict[str, int]:
    """``"data=2,fsdp=8"`` → {"data": 2, "fsdp": 8}."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"invalid mesh_shape entry {part!r}: expected axis=size")
        axis, _, size = part.partition("=")
        if not size.strip().isdigit():
            raise ValueError(
                f"mesh_shape axis {axis.strip()!r} size must be an integer")
        out[axis.strip()] = int(size)
    return out


class PartitionSpec(tuple):
    """Per dimension: None (whole), a mesh axis, or a tuple of mesh axes
    (split over their product, the first the slowest) — ``jax.sharding.
    PartitionSpec``'s shape."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """Ranks laid out over named axes. ``devices`` is the rank array
    (``np.ndarray`` of ints, one dimension per axis); :attr:`shape` maps
    each axis to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self._groups: dict[tuple[str, ...], Any] = {}
        if dist.is_available() and dist.is_initialized():
            self.make_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def my_coords(self) -> dict[str, int]:
        """This process's coordinates (rank 0's before ``initialize``)."""
        return self.coords(this_rank())

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s index along every axis."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def nontrivial(self, axes: Sequence[str]) -> tuple[str, ...]:
        """``axes`` that this mesh has with a size above 1, in mesh order."""
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def make_groups(self) -> None:
        """Create the process group of every line of ranks along every
        set of this mesh's non-trivial axes. ``torch.distributed.
        new_group`` is collective over the world, so every rank of the
        world builds the same meshes in the same order (the SPMD code
        paths do); a mesh built once the world is initialised calls this
        itself. Groups over the same ranks are shared between meshes."""
        me = dist.get_rank()
        axes_all = self.nontrivial(self.axis_names)
        for r in range(1, len(axes_all) + 1):
            for axes in itertools.combinations(axes_all, r):
                moved = np.moveaxis(
                    self.devices, [self.axis_names.index(a) for a in axes],
                    list(range(self.devices.ndim - len(axes),
                               self.devices.ndim)))
                for line in moved.reshape(-1, int(np.prod(
                        [self.shape[a] for a in axes]))):
                    ranks = tuple(int(x) for x in line)
                    if list(ranks) != sorted(ranks):
                        # a group orders its members by rank: blocks land
                        # in mesh order only if ranks ascend along it
                        raise ValueError(f"{self}: ranks {list(ranks)} do "
                                         f"not ascend along axes {axes}")
                    g = _group_of(ranks)
                    if me in ranks:
                        self._groups[axes] = g

    def group(self, axes: str | Sequence[str]):
        """The process group of the ranks that share this rank's
        coordinates on every axis but ``axes``; None where those axes are
        all of size 1 (nothing to reduce)."""
        axes = self.nontrivial((axes,) if isinstance(axes, str) else axes)
        if not axes:
            return None
        if axes not in self._groups:
            raise RuntimeError(
                f"{self} has no process group over {axes}: build the mesh "
                "after torch.distributed is initialised "
                "(parallel.initialize), on every rank of the world")
        return self._groups[axes]


# process groups by their ranks, for the life of the world: another
# mesh's line over the same ranks shares the group
_GROUPS: dict[tuple[int, ...], Any] = {}
_GROUPS_WORLD: list = [None]


def _group_of(ranks: tuple[int, ...]):
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def data_axes_in(mesh: Mesh) -> tuple[str, ...]:
    """The data-like axes actually present (and non-trivial) in a mesh."""
    return tuple(
        a for a in DATA_AXES if a in mesh.axis_names and mesh.shape[a] > 1
    )


def this_rank() -> int:
    """This process's rank in the world (0 before ``initialize``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _world_devices() -> list[int]:
    n = dist.get_world_size() if dist.is_initialized() else 1
    return list(range(n))


def device_prefix_for(
    shape: Mapping[str, int],
    devices: Sequence[int],
    allow_partial: bool = True,
    label: str = "mesh",
) -> list:
    """Devices a ``shape``-sized mesh should use: a prefix of ``devices``
    when the mesh is smaller and partial use is allowed, everything
    otherwise; asking for more devices than exist raises, naming
    ``label``."""
    sizes = [v for v in shape.values() if v != 0]
    total = int(np.prod(sizes)) if sizes else 1
    if total > len(devices):
        raise ValueError(
            f"{label} {dict(shape)} wants {total} devices, "
            f"have {len(devices)}"
        )
    if allow_partial and total < len(devices):
        return list(devices[:total])
    return list(devices)


def create_mesh(shape: Mapping[str, int],
                devices: Sequence[int] | None = None) -> Mesh:
    """A Mesh from {axis: size}. Axis order follows MESH_AXES, so the
    innermost (fastest-varying) axis is tensor/sequence; ``devices``
    defaults to every rank of the world (one, before ``initialize``)."""
    shape = {k: v for k, v in shape.items() if v != 0}
    unknown = set(shape) - set(MESH_AXES)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; known {MESH_AXES}")
    axis_names = tuple(a for a in MESH_AXES if a in shape)
    sizes = tuple(shape[a] for a in axis_names)
    if devices is None:
        devices = _world_devices()
    total = int(np.prod(sizes)) if sizes else 1
    if total != len(devices):
        raise ValueError(
            f"mesh {dict(shape)} wants {total} devices, have {len(devices)}"
        )
    return Mesh(np.asarray(list(devices)).reshape(sizes), axis_names)


def create_hybrid_mesh(
    ici_shape: Mapping[str, int],
    dcn_shape: Mapping[str, int],
    devices: Sequence[int] | None = None,
) -> Mesh:
    """A mesh spanning several slices (hosts): ``dcn_shape`` axes cross
    slice boundaries, ``ici_shape`` axes stay within one. Ranks are
    grouped into slices evenly by order (rank = process × local cards +
    local rank, so a host's ranks are one slice); DCN axes vary slowest.
    Size-1 axes are dropped, so an auto-mesh ``data=1`` composes with a
    DCN ``data`` axis; an axis may not appear (non-trivially) in both."""
    ici_shape = {k: v for k, v in ici_shape.items() if v not in (0, 1)}
    dcn_shape = {k: v for k, v in dcn_shape.items() if v not in (0, 1)}
    overlap = set(ici_shape) & set(dcn_shape)
    if overlap:
        raise ValueError(
            f"axes {sorted(overlap)} appear in both ici and dcn shapes — "
            "an axis is either intra-slice (ICI) or cross-slice (DCN)"
        )
    unknown = (set(ici_shape) | set(dcn_shape)) - set(MESH_AXES)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; known {MESH_AXES}")
    if devices is None:
        devices = _world_devices()
    n_slices = int(np.prod(list(dcn_shape.values()) or [1]))
    per_slice = int(np.prod(list(ici_shape.values()) or [1]))
    if n_slices * per_slice != len(devices):
        raise ValueError(
            f"hybrid mesh dcn={dict(dcn_shape)} × ici={dict(ici_shape)} "
            f"wants {n_slices}×{per_slice} devices, have {len(devices)}"
        )
    dcn_axes = tuple(a for a in MESH_AXES if a in dcn_shape)
    ici_axes = tuple(a for a in MESH_AXES if a in ici_shape)
    sizes = (tuple(dcn_shape[a] for a in dcn_axes)
             + tuple(ici_shape[a] for a in ici_axes))
    return Mesh(np.asarray(list(devices)).reshape(sizes),
                (*dcn_axes, *ici_axes))


def mesh_shape_for_devices(n: int) -> dict[str, int]:
    """A sensible default mesh for n devices: tensor innermost (2 if even),
    rest fsdp, data=1 (fsdp already data-parallels the batch)."""
    tensor = 2 if n % 2 == 0 and n >= 2 else 1
    fsdp = n // tensor
    return {"data": 1, "fsdp": fsdp, "tensor": tensor}


def logical_to_spec(
    logical: Sequence[str | None],
    rules: Mapping[str, str | None] = DEFAULT_RULES,
    mesh: Mesh | None = None,
) -> PartitionSpec:
    """Logical axis names → a PartitionSpec, dropping mesh axes that the
    given mesh lacks or has at size 1."""
    entries = []
    for name in logical:
        mesh_axis = rules.get(name) if name is not None else None
        if mesh_axis is not None and mesh is not None:
            if mesh_axis not in mesh.axis_names or mesh.shape[mesh_axis] == 1:
                mesh_axis = None
        entries.append(mesh_axis)
    return PartitionSpec(*entries)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: how one leaf (or the batch) lies over the ranks."""

    mesh: Mesh
    spec: PartitionSpec

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over (slowest first)."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    def split_axes(self) -> tuple[str, ...]:
        """Every mesh axis the leaf is split over."""
        return tuple(a for d in range(len(self.spec)) for a in self.axes(d))

    def parts(self, dim: int) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes(dim)]))

    def index(self, dim: int, coords: Mapping[str, int]) -> int:
        """The block of dimension ``dim`` held at ``coords``."""
        i = 0
        for a in self.axes(dim):
            i = i * self.mesh.shape[a] + coords[a]
        return i

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        out = []
        for d, n in enumerate(shape):
            p = self.parts(d)
            if n % p:
                raise ValueError(
                    f"dimension {d} of size {n} does not divide over mesh "
                    f"axes {self.axes(d)} of size {p}")
            out.append(n // p)
        return tuple(out)


def param_shardings(logical_tree: Any, mesh: Mesh,
                    rules: Mapping[str, str | None] = DEFAULT_RULES) -> Any:
    """A tree of NamedShardings matching a ``logical_axes()`` tree."""
    if isinstance(logical_tree, dict):
        return {k: param_shardings(v, mesh, rules)
                for k, v in logical_tree.items()}
    return NamedSharding(mesh, logical_to_spec(logical_tree, rules, mesh))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Input batch: sharded over every data-like axis present."""
    data_axes = data_axes_in(mesh)
    if not data_axes:
        return NamedSharding(mesh, PartitionSpec())
    return NamedSharding(mesh, PartitionSpec(data_axes))


def shard_tensor(full: torch.Tensor, sharding: NamedSharding,
                 rank: int) -> torch.Tensor:
    """``rank``'s block of a whole tensor, contiguous (a copy where a
    dimension is split, else ``full`` itself)."""
    coords = sharding.mesh.coords(rank)
    local = sharding.local_shape(full.shape)
    out = full
    for d, n in enumerate(local):
        if n != full.shape[d]:
            out = out.narrow(d, sharding.index(d, coords) * n, n)
    return out.contiguous() if out is not full else full


def gather_tensor(local: torch.Tensor, sharding: NamedSharding
                  ) -> torch.Tensor:
    """The whole tensor from every rank's block: an all-gather over the
    axes of each split dimension (collective: every rank of the mesh
    calls it). No autograd."""
    from tpu_kubernetes_torch.parallel.collectives import all_gather_raw

    out = local
    for d in range(len(sharding.spec)):
        # gather the fastest axis first, so blocks land in index order
        for a in reversed(sharding.axes(d)):
            out = all_gather_raw(out, d, sharding.mesh.group(a))
    return out


def gather_axes(local: torch.Tensor, sharding: NamedSharding,
                axes: Sequence[str], drop: int = 0) -> torch.Tensor:
    """``local`` with every dimension that ``sharding`` splits over one of
    ``axes`` all-gathered (autograd: the backward reduce-scatters, the
    adjoint over a data-like axis). ``drop`` leading dimensions of the
    sharding are not in ``local`` (a layer's slice of a stacked leaf)."""
    from tpu_kubernetes_torch.parallel.collectives import all_gather

    out = local
    for d in range(drop, len(sharding.spec)):
        for a in reversed(sharding.axes(d)):
            if a in axes:
                out = all_gather(out, d - drop, sharding.mesh.group(a))
    return out


def tree_map_shardings(fn, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over a nested dict and its shardings tree."""
    if isinstance(tree, dict):
        return {k: tree_map_shardings(fn, v, shardings[k])
                for k, v in tree.items()}
    return fn(tree, shardings)


# -- the mesh the model runs under -------------------------------------------

# the stack of entered meshes, one per thread: a server's handler threads
# may each run a sharded program, and a mesh entered on one is invisible
# on the others
_ACTIVE = threading.local()


@contextmanager
def mesh_context(mesh: Mesh | None):
    """Run the model on this rank's shards of ``mesh``: the blocks gather
    what they use and reduce what they split (``models/llama.py``,
    ``models/moe.py``, ``models/decode.py``). The sharded train, eval and
    generate programs enter it around their bodies; a trivial mesh
    changes nothing. The context is this thread's alone; nested contexts
    unwind in order."""
    stack = _ACTIVE.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield
    finally:
        stack.pop()


def in_context_mesh(fn):
    """``fn`` run under this thread's context mesh (None: none) wherever
    it is called. Remat's recompute runs a block again in the backward,
    and for CUDA tensors the autograd engine runs the backward on a
    thread of its own, where the caller's context is not active: the
    checkpointed blocks are wrapped with this."""
    stack = getattr(_ACTIVE, "stack", None)
    mesh = stack[-1] if stack else None

    def run(*args, **kwargs):
        with mesh_context(mesh):
            return fn(*args, **kwargs)

    return run


def active_mesh() -> Mesh | None:
    """This thread's context mesh when it splits anything (size above 1),
    else None: the one-device code path."""
    stack = getattr(_ACTIVE, "stack", None)
    mesh = stack[-1] if stack else None
    return mesh if mesh is not None and mesh.size > 1 else None
