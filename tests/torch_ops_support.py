"""Shared helpers of the operations-layer tests of the port
(``tests/test_torch_{obs,ledger,faults,tracing,resilience,profile}.py``):
the JAX server and the port's server at ``llama-test`` in f32 from the same
weights, the reset of both packages' process-wide singletons (pytest-xdist
runs several test files one after another in one worker process, so
counts must not carry from one file into the next), the port's black-box
dumps kept out of the working directory, and a parser of the
``/metrics`` exposition."""

from __future__ import annotations

import copy
import re

import jax
import numpy as np
import pytest

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob

ENV = {
    "SERVE_MODEL": "llama-test",
    "SERVE_MAX_NEW": "16",
    "SERVE_DTYPE": "float32",
}


def jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            jllama.CONFIGS["llama-test"])
    return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)


def reset_singletons() -> None:
    """Zero the port's goodput ledger, disarm the fault injectors, empty
    the span rings and the serving profilers, and forget the logged
    warnings: of the port and of the JAX package alike, but for the JAX
    package's ledger. That one is left as it is: its ``reset()`` zeros its
    own counts and not the process registry's ``tpu_serve_tokens_*``
    counters it feeds, so a reset here would leave the two apart for the
    rest of the worker's process, where the JAX package's own tests (the
    monitor's goodput column against ``LEDGER.goodput()``) hold them
    equal. The comparisons with the JAX ledger here read its deltas."""
    from tpu_kubernetes.obs.faults import FAULTS as JFAULTS
    from tpu_kubernetes.serve import resilience as jres
    from tpu_kubernetes.serve.server import PROFILER as JPROFILER
    from tpu_kubernetes.util.trace import TRACER as JTRACER
    from tpu_kubernetes_torch.obs.faults import FAULTS
    from tpu_kubernetes_torch.obs.ledger import LEDGER
    from tpu_kubernetes_torch.serve import resilience as tres
    from tpu_kubernetes_torch.serve.server import PROFILER
    from tpu_kubernetes_torch.util.trace import TRACER

    LEDGER.reset()
    for faults, tracer, profiler, res in (
            (FAULTS, TRACER, PROFILER, tres),
            (JFAULTS, JTRACER, JPROFILER, jres)):
        faults.clear()
        tracer.reset()
        profiler.reset()
        res.reset_warned()


# the JAX package's ledger: its own counts and the registry families it
# feeds (the monitor reads the families, /debug/ledger the counts)
_JAX_LEDGER_FIELDS = ("_emitted", "_tokens", "_seconds", "_row_steps",
                      "_live_steps", "_segments", "_timeline")
_JAX_LEDGER_FAMILIES = ("_tok_fam", "_emit_fam", "_sec_fam",
                        "_bubble_gauge")


@pytest.fixture(autouse=True, scope="module")
def keep_jax_ledger():
    """A module of these tests leaves the JAX package's goodput ledger as
    it found it: its counts and the registry's ``tpu_serve_tokens_*``
    families are put back after the module, so the JAX servers it ran
    leave no tokens (settled or not) behind for the JAX package's own
    tests, which hold the two equal and the ledger settled (pytest-xdist
    runs files one after another in one worker process)."""
    from tpu_kubernetes.obs.ledger import LEDGER as JLEDGER

    def values(name):
        fam = getattr(JLEDGER, name)
        with fam._lock:
            return {key: child.value for key, child in fam._children.items()}

    with JLEDGER._lock:
        counts = copy.deepcopy({k: getattr(JLEDGER, k)
                                for k in _JAX_LEDGER_FIELDS})
    families = {name: values(name) for name in _JAX_LEDGER_FAMILIES}
    yield
    with JLEDGER._lock:
        for k, v in counts.items():
            setattr(JLEDGER, k, v)
    for name, saved in families.items():
        fam = getattr(JLEDGER, name)
        with fam._lock:
            for key, child in fam._children.items():
                child.value = saved.get(key, 0.0)


@pytest.fixture(autouse=True, scope="module")
def clean_singletons():
    """Every module of these tests starts and ends with both packages'
    singletons reset."""
    reset_singletons()
    yield
    reset_singletons()


@pytest.fixture(autouse=True, scope="module")
def black_box_dirs(tmp_path_factory):
    """Engine-bearing servers started without TPU_K8S_FLIGHTREC_DIR or
    TPU_K8S_INCIDENTS_DIR write their postmortems and incident bundles into
    a temporary directory of the module, not into ``runs/`` under the
    working directory."""
    from tpu_kubernetes_torch.obs import flightrec, incidents

    saved = flightrec.DEFAULT_DIR, incidents.DEFAULT_DIR
    base = tmp_path_factory.mktemp("black-box")
    flightrec.DEFAULT_DIR = str(base / "flightrec")
    incidents.DEFAULT_DIR = str(base / "incidents")
    yield
    flightrec.DEFAULT_DIR, incidents.DEFAULT_DIR = saved


def torch_state(jax_weights_too: bool = True, **extra):
    """The port's ServingState on the CPU, warmed (with the JAX server's
    weights unless ``jax_weights_too`` is False)."""
    from tpu_kubernetes_torch.serve import server as tserver

    env = dict(ENV, SERVE_DEVICE="cpu", **extra)
    if jax_weights_too:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tjob, "init_params", jax_weights)
            st = tserver.ServingState(env)
    else:
        st = tserver.ServingState(env)
    st.warm()
    return st


def jax_state(**extra):
    from tpu_kubernetes.serve.server import ServingState

    st = ServingState(dict(ENV, **extra))
    st.warm()
    return st


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)")


def families(text: str) -> dict:
    """A ``/metrics`` exposition → {family: (type, {sample line name and
    labels: value})}."""
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            out[name] = (kind, {})
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        name, labels, value = m.group(1), m.group(3) or "", m.group(4)
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in out:
                fam = name[:-len(suffix)]
        out[fam][1][name + "{" + labels + "}"] = float(value)
    return out
