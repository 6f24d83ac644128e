"""Sharded serving over a mesh (port of ``tpu_kubernetes/parallel/serving.py``).

The reference jits ``models.decode.generate`` over a mesh with the
training stack's logical-axis rules and lets GSPMD insert the
collectives. The port runs one process per card, as training does
(``parallel/mesh.py``): a rank holds its block of each split leaf and
runs the decode path under ``parallel.mesh_context``, where
``models/decode.py`` writes the collectives out by hand: attention heads
(and KV heads) and the MLP hidden split over ``tensor``, an all-reduce
after ``wo`` and ``w_down`` (Megatron), the embedding looked up over its
vocab rows, and the head's vocab columns all-gathered before any argmax,
filter or draw, so every rank along ``tensor`` picks the same token. The
batch splits over the data-like axes; ``stage`` and ``sequence`` are
replica axes here, as under the reference's GSPMD. Where the tensor axis
is wider than the KV heads (and a multiple of them) each rank holds
wk/wv whole and keeps the one KV head its query heads read (Megatron's KV
replication; ``models/llama.py`` ``kv_replicated``).

Works with plain params or the int8 export (``models/quant.py``): an int8
leaf's ``q`` is laid out as the weight it replaces, its scale ``s``
(…, 1, out) like the weight's output dimension, the size-1 contraction
dimension never split.

The second half is the slot engine's KV rule. Every KV storage tensor of
``models/decode.py`` keeps its KV heads on axis 2 (dense k/v
``(L, slots, kv, S, hd)`` and their scales ``(L, slots, kv, S)``, paged
pools ``(L, pages + 1, kv, ps[, hd])``, prefill row caches
``(L, 1, kv, width[, hd])``), so one spec, :func:`kv_partition_spec`,
splits all of them over ``tensor``, and a rank test (4 dimensions or
more: KV storage) tells them from the replicated operands (slot state,
page tables, slot indices, tokens, logits). :func:`kv_movement` runs a
data-movement body (insert, clear, page wipe, page gather) as it is on a
rank's head slice, which is bitwise the one-device body there;
:func:`kv_model_program` runs a model program (prefill, resume, the slot
and paged segments, the verify rounds) under ``mesh_context`` on the
rank's params and caches. :func:`shard_kv` cuts a whole cache or pool to
the rank's heads and :func:`gather_kv` puts it back together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from tpu_kubernetes_torch.models import logical_axes
from tpu_kubernetes_torch.models.decode import (
    generate_into,
    init_cache,
    sampling_knobs,
    sampling_variant,
)
from tpu_kubernetes_torch.models.llama import ModelConfig, kv_replicated
from tpu_kubernetes_torch.models.quant import is_quantized, quantized_sharding
from tpu_kubernetes_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    data_axes_in,
    gather_tensor,
    logical_to_spec,
    mesh_context,
    param_shardings,
    shard_tensor,
    this_rank,
)
from tpu_kubernetes_torch.util.graphs import Programs


def serving_param_shardings(params: dict, cfg: ModelConfig, mesh: Mesh
                            ) -> dict:
    """Shardings of a serving tree: the family's logical axes on the mesh
    (``param_shardings``), extended over int8 leaves (``q`` like the
    weight, ``s`` like the weight's output dimension with its size-1
    contraction dimension whole), with wk/wv whole where the tensor axis
    is wider than the KV heads (``llama.kv_replicated``)."""
    base = param_shardings(logical_axes(cfg), mesh)
    if kv_replicated(cfg, mesh):
        for name in ("wk", "wv"):
            spec = base["layers"][name].spec
            base["layers"][name] = NamedSharding(mesh, PartitionSpec(
                *(None if e == "tensor" else e for e in spec)))

    def extend(tree, sh):
        if is_quantized(tree):
            return quantized_sharding(sh)
        if isinstance(tree, dict):
            return {k: extend(v, sh[k]) for k, v in tree.items()}
        return sh

    return extend(params, base)


def check_serving_mesh(cfg: ModelConfig, mesh: Mesh,
                       rows: int | None = None) -> None:
    """Raise ValueError, naming the axis and the dimension, where the mesh
    does not split the model (or ``rows`` batch rows) evenly: the port
    splits evenly where the reference's GSPMD would pad. A tensor axis
    wider than the KV heads must be a multiple of them."""
    t, f, ep = (mesh.axis_size(a) for a in ("tensor", "fsdp", "expert"))
    if t > cfg.n_kv_heads and t % cfg.n_kv_heads:
        raise ValueError(
            f"mesh axis tensor of size {t} is wider than n_kv_heads "
            f"{cfg.n_kv_heads} and not a multiple of it: a rank's query "
            f"heads would read more than one KV head")
    dims = [("tensor", t, "n_heads", cfg.n_heads),
            ("tensor", t, "d_ff", cfg.d_ff),
            ("tensor", t, "vocab_size", cfg.vocab_size),
            ("fsdp", f, "d_model", cfg.d_model)]
    if t <= cfg.n_kv_heads:
        dims.append(("tensor", t, "n_kv_heads", cfg.n_kv_heads))
    if hasattr(cfg, "n_experts"):
        dims.append(("expert", ep, "n_experts", cfg.n_experts))
    if rows is not None:
        axes = data_axes_in(mesh)
        n_dp = math.prod(mesh.shape[a] for a in axes)
        dims.append(("data-like (" + ",".join(axes) + ")", n_dp,
                     "batch rows", rows))
    for axis, size, name, n in dims:
        if size > 1 and n % size:
            raise ValueError(
                f"mesh axis {axis} of size {size} does not divide {name} "
                f"{n}: the port splits evenly (the reference would pad)")


def make_sharded_generate(
    cfg: ModelConfig, mesh: Mesh, params: dict, *, max_new_tokens: int,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
    eos_id: int | None = None, pad_id: int = 0,
    cache_span: int | None = None, kv_quant: bool = False,
    shard_batch: bool = True,
) -> tuple[Callable, dict, NamedSharding]:
    """→ (run, param shardings, prompt sharding), the reference's
    contract on one rank. The caller cuts its whole tensors with them
    (``shard_tensor`` over ``tree_map_shardings``; ``params`` here is the
    whole tree or this rank's, read for its structure only), and
    ``run(local_params, local_prompt, seed_or_generator=None,
    prompt_lengths=None)`` returns the WHOLE batch's tokens (batch,
    max_new_tokens) int32 on every rank: each rank generates its rows and
    the rows are all-gathered over the data-like axes (the reference's
    replicated output). ``prompt_lengths`` is the whole batch's (batch,)
    lengths of a right-padded ragged batch (replicated, as in the
    reference); the rank takes its rows of it. The sampled draws come
    from one generator of the program, seeded by an int
    ``seed_or_generator`` before the call, or copied in from (and back
    into) a ``torch.Generator``; None draws on from the last call. Ranks
    along ``tensor`` hold the same rows and draw alike; a rank of another
    data-like block draws for its own rows, so a sampled batch under a
    data split differs from one device's. ``shard_batch=False``
    replicates the prompt (every rank runs every row: a server's batch-1
    rows). A batch the data-like axes do not divide raises ValueError
    naming the axis. The program (one per prompt shape and raggedness) is
    one CUDA graph under NCCL and runs eagerly over gloo and on the CPU,
    as the sharded train step does; its first call (eager) creates the
    communicators before the capture. A program reads the params it was
    first called with in place, as the train step reads its state;
    ``run.programs`` holds them (``util/graphs.py`` ``Programs``)."""
    from tpu_kubernetes_torch.train.trainer import _graphs_for, local_rows

    check_serving_mesh(cfg, mesh)
    p_shardings = serving_param_shardings(params, cfg, mesh)
    prompt_sharding = (batch_sharding(mesh) if shard_batch
                       else NamedSharding(mesh, PartitionSpec()))
    variant = sampling_variant(temperature, top_k, top_p)
    buffers: dict[Any, tuple] = {}

    def build(local_params, b: int, width: int, ragged: bool, device):
        """The program's buffers and body for one prompt shape."""
        span = cache_span or (width + max_new_tokens)
        if width + max_new_tokens > cfg.max_seq:
            raise ValueError(f"prompt {width} + new {max_new_tokens} "
                             f"exceeds max_seq {cfg.max_seq}")
        with mesh_context(mesh):
            cache = init_cache(cfg, b, span, kv_quant=kv_quant,
                               device=device)
        prompt = torch.zeros((b, width), dtype=torch.int32, device=device)
        lengths = (torch.zeros((b,), dtype=torch.int32, device=device)
                   if ragged else None)
        out = torch.zeros((b, max_new_tokens), dtype=torch.int32,
                          device=device)
        whole = torch.zeros((b * prompt_sharding.parts(0), max_new_tokens),
                            dtype=torch.int32, device=device)
        knobs = sampling_knobs(temperature, top_k, top_p, device)
        gen = torch.Generator(device=device).manual_seed(0)

        def body():
            with mesh_context(mesh):
                generate_into(local_params, prompt, cfg, out, cache, knobs,
                              variant, generator=gen,
                              prompt_lengths=lengths, eos_id=eos_id,
                              pad_id=pad_id)
            whole.copy_(gather_tensor(out, prompt_sharding))

        return body, prompt, lengths, gen, whole

    def run(local_params: dict, local_prompt: torch.Tensor,
            seed_or_generator=None,
            prompt_lengths: torch.Tensor | None = None) -> torch.Tensor:
        b, width = local_prompt.shape
        n = b * prompt_sharding.parts(0)
        device = local_prompt.device
        if run.programs is None:
            run.programs = Programs(device, graphs=_graphs_for(device))
        key = (b, width, prompt_lengths is not None)
        if key not in buffers:
            buffers[key] = build(local_params, b, width,
                                 prompt_lengths is not None, device)
        body, prompt, lengths, gen, whole = buffers[key]
        program = run.programs.get(key, lambda: body, generators=(gen,))
        prompt.copy_(local_prompt)
        if prompt_lengths is not None:
            if prompt_lengths.shape[0] != n:
                raise ValueError(f"prompt_lengths of {prompt_lengths.shape[0]}"
                                 f" rows for a batch of {n}")
            mine = torch.as_tensor(local_rows(prompt_sharding, n),
                                   device=prompt_lengths.device)
            lengths.copy_(prompt_lengths.reshape(-1)[mine])
        given = isinstance(seed_or_generator, torch.Generator)
        if given:
            gen.set_state(seed_or_generator.get_state())
        elif seed_or_generator is not None:
            gen.manual_seed(int(seed_or_generator))
        program()
        if given:
            seed_or_generator.set_state(gen.get_state())
        return whole.clone()

    # the programs by (rows, width, ragged), made at the first call on its
    # device: their captures and replays
    run.programs = None
    return run, p_shardings, prompt_sharding


# -- the slot engine's caches: KV heads over tensor --------------------------


def kv_partition_spec(mesh: Mesh) -> PartitionSpec:
    """The one KV-storage rule: KV heads (axis 2) over ``tensor`` (the
    ``kv`` logical axis; dropped where the mesh has no tensor split),
    every other dimension whole."""
    return logical_to_spec((None, None, "kv"), mesh=mesh)


def _spec_of(leaf, kv: PartitionSpec) -> PartitionSpec:
    # the rank test: in the slot and paged programs KV storage is the only
    # operand of 4 dimensions or more; slot state, page tables, slot
    # indices, tokens and logits are whole on every rank
    return kv if getattr(leaf, "ndim", 0) >= 4 else PartitionSpec()


def _map_tensors(fn: Callable, tree: Any) -> Any:
    """``fn`` over every tensor of a cache, pool, slot state or nested
    dict / list / tuple of them; everything else kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def kv_tree_shardings(tree: Any, mesh: Mesh) -> Any:
    """The tree with a NamedSharding in place of each tensor under the
    :func:`kv_partition_spec` rule: KV storage (4 dimensions or more)
    split on axis 2, every smaller tensor whole."""
    kv = kv_partition_spec(mesh)
    return _map_tensors(lambda a: NamedSharding(mesh, _spec_of(a, kv)),
                        tree)


def shard_kv(tree: Any, mesh: Mesh, rank: int | None = None) -> Any:
    """A whole cache, pool or row cache (or a tree of them) → ``rank``'s
    (this process's by default) head slice of its KV storage, the rest as
    it is."""
    kv = kv_partition_spec(mesh)
    rank = this_rank() if rank is None else rank
    return _map_tensors(lambda a: shard_tensor(
        a, NamedSharding(mesh, _spec_of(a, kv)), rank), tree)


def gather_kv(tree: Any, mesh: Mesh) -> Any:
    """The whole cache of every rank's head slices (an all-gather over
    ``tensor``: every rank of the mesh calls it)."""
    kv = kv_partition_spec(mesh)
    return _map_tensors(lambda a: gather_tensor(
        a, NamedSharding(mesh, _spec_of(a, kv))), tree)


def kv_movement(fn: Callable, mesh: Mesh) -> Callable:
    """A data-movement body (``cache_insert_row``, ``cache_clear_row``,
    ``paged_insert_row``, ``paged_clear_pages``, ``gather_pages``) for the
    rank's head slices: ``fn`` itself. Its bodies do no arithmetic across
    heads and need no collective, so on the rank's tensors each rank
    holds bitwise the one-device result on its heads (the reference's
    full-manual ``kv_shard_map``, which it needs to keep GSPMD out)."""
    del mesh
    return fn


def kv_model_program(fn: Callable, mesh: Mesh) -> Callable:
    """A model program (``prefill``, ``prefill_resume``,
    ``decode_segment_slots``, ``decode_segment_paged``,
    ``decode_verify_slots``, ``decode_verify_paged``) on the rank's params
    (:func:`serving_param_shardings`), its head-sharded caches
    (:func:`shard_kv`) and the replicated rest, under ``mesh_context``:
    the blocks reduce over ``tensor`` and the logits are whole, so every
    rank returns the same tokens (the reference's ``kv_jit``)."""
    def run(*args, **kwargs):
        with mesh_context(mesh):
            return fn(*args, **kwargs)

    return run
