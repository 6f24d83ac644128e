"""Compiled programs: the port's counterpart of ``jax.jit`` and of the
reference server's program cache (``tpu_kubernetes/serve/server.py``
``_cached_program``).

A program is a *body*: a function of no arguments that reads tensors its
owner allocated (the static inputs, into which each call's data is
copied first) and writes its results into tensors its owner allocated
(the static outputs, the KV cache, the train state). On a CUDA device a
:class:`Program`'s first call runs the body eagerly on its side stream
(the warm-up, which is that call's own result: it builds the kernel
libraries, encodes the tensor maps, makes cuBLAS's first calls and the
rope tables), then captures it once into a ``torch.cuda.CUDAGraph``;
every later call replays the graph. The train step is one program.
:class:`Programs` keeps a server lane's programs, one per static
signature (its key), and all its graphs share one memory pool, so a body
must leave nothing in the pool that outlives its replay: results go to
the owner's tensors, which live outside the pool. A capture that fails
raises, and so does every later call of its program. On the CPU, or with ``graphs=False`` (the tests and
``chip_smoke.py`` use it to compare), every call runs the body: the same
keys, the same counts, no graph.

A program's ``captures`` (the counterpart of
``tpu_kubernetes/analysis/retrace.py``) is 1 once it has run, and its
``replays`` counts the later calls. The kernel wrappers count the
launches they make in Python; while a graph captures, those launches are
recorded, not run, and each replay runs them again. :data:`CAPTURED` and
:data:`REPLAYED` keep both tallies by kernel name, so that
:func:`device_launches` turns the wrappers' counts into the launches the
card ran.

A body may draw random numbers from ``torch.Generator`` objects on its
device (the sampled serving lane does): the program takes them as
``generators`` and registers each with its graph before the capture, so
a replay draws from the generator's seed and offset at that moment and
advances the offset by what the captured draws used, as the eager body
would. A request seeded ``s`` (``gen.manual_seed(s)`` before the call)
therefore draws the same numbers from the warm-up, from a replay and
from the body run eagerly; the capture itself draws nothing and moves
no offset.
"""

from __future__ import annotations

import gc
from typing import Callable, Hashable

import torch

# launches recorded while capturing (not run) and launches that replays
# ran, by the names of tpu_kubernetes_torch.ops.launch_counts
CAPTURED: dict[str, int] = {}
REPLAYED: dict[str, int] = {}


def reset_launches() -> None:
    CAPTURED.clear()
    REPLAYED.clear()


def device_launches(counts: dict[str, int]) -> dict[str, int]:
    """The wrappers' launch counts → the launches the card ran: those
    recorded by a capture taken out, those run by replays added."""
    return {name: n - CAPTURED.get(name, 0) + REPLAYED.get(name, 0)
            for name, n in counts.items()}


def _device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _add(tally: dict[str, int], counts: dict[str, int]) -> None:
    for name, n in counts.items():
        tally[name] = tally.get(name, 0) + n


class Program:
    """One compiled program; call it to run the body once (see the module
    docstring). ``pool`` and ``stream`` are the graph memory pool and the
    side stream it captures on: a program of its own makes both, a
    :class:`Programs` cache hands its own to each of its programs.

    A program holds its body and nothing that holds it, and its owners'
    bodies close over their buffers, not over their owners: so a dropped
    program's graph is destroyed at once, by reference count. An owner
    that sits in a reference cycle all the same (a server's state is held
    by its handler class, and every class is a cycle) leaves its graphs to
    a garbage collection, which would invalidate a capture it ran in the
    middle of: the collector is off while a graph captures."""

    def __init__(self, body: Callable[[], None],
                 device: torch.device | str, *, graphs: bool = True,
                 pool=None, stream: torch.cuda.Stream | None = None,
                 generators: tuple[torch.Generator, ...] = ()):
        self.device = _device(device)
        self.body = body
        self.generators = tuple(generators)
        self.graphs = graphs and self.device.type == "cuda"
        self.pool = self.stream = None
        if self.graphs:
            self.pool = (pool if pool is not None
                         else torch.cuda.graph_pool_handle())
            self.stream = (stream if stream is not None
                           else torch.cuda.Stream(self.device))
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captures = 0               # 1 after the first call, never 2
        self.replays = 0                # the calls after it
        # the wrappers' launches one replay runs, by kernel name
        self.launches: dict[str, int] = {}

    def __call__(self) -> None:
        if not self.captures:
            self.captures = 1
            if self.graphs:
                self._capture()
            else:
                self.body()
            return
        self.replays += 1
        if self.graph is None:
            if self.graphs:
                # no eager fallback for a program whose capture failed
                raise RuntimeError("this program's capture failed")
            self.body()
            return
        self.graph.replay()
        _add(REPLAYED, self.launches)

    def _capture(self) -> None:
        from tpu_kubernetes_torch.ops import launch_counts

        side = self.stream
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()                 # the warm-up: this call's own run
        main.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            # a replay then reads the generator's seed and offset and
            # advances the offset by the captured draws
            graph.register_generator_state(gen)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # torch.cuda.graph synchronises first, so the warm-up has
            # finished; only this thread is held to capture's rules (the
            # input pipeline's thread may allocate while the step captures)
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.body()
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        _add(CAPTURED, self.launches)
        self.graph = graph


class Programs:
    """The programs of one owner (a server's lane), by key, on one device,
    sharing one graph memory pool and one side stream. A key's program is
    built once and captures at its first call only, so ``captures`` reads
    1 for every key that ran (the counterpart of the reference's
    ``analysis/retrace.py`` check). ``on_lookup(hit)``, when given, hears
    of every :meth:`get`: a key seen before is a hit, a new one a miss
    (the server's ``tpu_serve_program_cache_total``)."""

    def __init__(self, device: torch.device | str, *, graphs: bool = True,
                 on_lookup: Callable[[bool], None] | None = None):
        self.on_lookup = on_lookup
        self.device = _device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.stream = (torch.cuda.Stream(self.device) if self.graphs
                       else None)
        self._programs: dict[Hashable, Program] = {}

    def get(self, key: Hashable, build: Callable[[], Callable[[], None]],
            generators: tuple[torch.Generator, ...] = ()) -> Program:
        """The program of ``key``; ``build()`` makes its body (and the
        owner's buffers it closes over) the first time the key is seen.
        ``generators`` are those the body draws from (see the module
        docstring)."""
        program = self._programs.get(key)
        if self.on_lookup is not None:
            self.on_lookup(program is not None)
        if program is None:
            program = self._programs[key] = Program(
                build(), self.device, graphs=self.graphs, pool=self.pool,
                stream=self.stream, generators=generators)
        return program

    @property
    def captures(self) -> dict[Hashable, int]:
        """Captures by key, of the keys that ran."""
        return {k: p.captures for k, p in self._programs.items()
                if p.captures}

    @property
    def replays(self) -> dict[Hashable, int]:
        """Replays by key, of the keys that replayed."""
        return {k: p.replays for k, p in self._programs.items()
                if p.replays}
