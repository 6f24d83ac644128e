"""The port's ring attention (``parallel/ring_attention.py``) against the
reference's ``tests/test_parallel.py::TestRingAttention`` on eight gloo
ranks: each rank's block of the output against the JAX
``ring_attention_sharded`` on the eight virtual CPU devices and against
plain attention, causal and not; the gradients of every rank's block
against plain autograd of the whole sequence; the output stays this
rank's sequence block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parallel_support import RankPool, ring_case
from tpu_kubernetes.ops import attention_reference
from tpu_kubernetes.parallel import ring_attention_sharded as jring

B, H, S, D = 2, 2, 128, 32          # the reference test's shapes
N = 8                               # the ring's ranks
TOL = dict(atol=2e-4, rtol=2e-4)    # the reference test's tolerance


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    try:
        yield p
    finally:
        p.close()


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


def _plain(q, k, v, g, causal):
    """Plain f32 attention of the whole sequence and its autograd
    gradients of ⟨out, g⟩."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    out = torch.softmax(s, -1) @ v
    (out * torch.from_numpy(g)).sum().backward()
    return tuple(t.detach().numpy() for t in (out, q.grad, k.grad, v.grad))


def _blocks(x):
    """The eight ranks' sequence blocks of a whole (b, h, s, d) array."""
    return np.split(x, N, axis=2)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference(pool, causal):
    q, k, v, g = _inputs()
    got = pool.run(ring_case, {"sequence": N}, q, k, v, g, causal)
    jmesh = JMesh(np.array(jax.devices()[:N]), ("sequence",))
    jout = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jmesh, causal=causal))
    ref = np.asarray(attention_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    plain = _plain(q, k, v, g, causal)
    for rank, (out, dq, dk, dv) in enumerate(got):
        assert out.shape == (B, H, S // N, D)
        np.testing.assert_allclose(out, _blocks(jout)[rank], **TOL)
        np.testing.assert_allclose(out, _blocks(ref)[rank], **TOL)
        for name, have, want in (("dq", dq, plain[1]), ("dk", dk, plain[2]),
                                 ("dv", dv, plain[3])):
            np.testing.assert_allclose(have, _blocks(want)[rank], **TOL,
                                       err_msg=f"{name} of rank {rank}")


def test_long_sequence_stays_sharded(pool):
    """Each rank's output is its own block of the sequence (no gather to
    one rank), and equals the reference's block there."""
    q = np.ones((1, 1, 256, 16), np.float32)
    got = pool.run(ring_case, {"sequence": N}, q, q, q, q, True)
    jmesh = JMesh(np.array(jax.devices()[:N]), ("sequence",))
    jout = jring(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), jmesh)
    assert all(r[0].shape == (1, 1, 256 // N, 16) for r in got)
    np.testing.assert_allclose(np.concatenate([r[0] for r in got], 2),
                               np.asarray(jout), **TOL)
