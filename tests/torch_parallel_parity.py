"""The parity harness of the port's sharded step: the same f32 weights
(drawn by JAX, carried over with ``models.from_jax``, zero moments) and
the same numpy batches through

* the port's ``make_sharded_train_step`` on gloo ranks of a
  :class:`~torch_parallel_support.RankPool`,
* the port's one-device ``train_step`` (here, in the test process),
* the JAX package's ``make_sharded_train_step`` on the same mesh of the
  virtual CPU devices,

→ each step's loss and every parameter leaf (and every optimizer moment)
after the last step, from all three.
"""

from __future__ import annotations

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parallel_support import train_case
from tpu_kubernetes import models as jmodels
from tpu_kubernetes.parallel import create_hybrid_mesh, create_mesh
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch.models import CONFIGS as TCONFIGS
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.train import trainer as ttr

# f32 after two steps, each side against the other: the sharded step sums
# its gradients over ranks in another order than one device, and the JAX
# and port sides differ by summation order and transcendental ulps (the
# one-device port step is held to optax at the same tolerance,
# tests/test_torch_train.py); measured below 1e-6 abs everywhere
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, sorted by path."""
    out = []
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.extend(leaves(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def jax_mesh(mesh_shape: dict, dcn_shape: dict | None):
    n = math.prod(mesh_shape.values()) * math.prod((dcn_shape or {}).values())
    devices = jax.devices()[:n]
    if dcn_shape:
        return create_hybrid_mesh(mesh_shape, dcn_shape, devices=devices)
    return create_mesh(mesh_shape, devices=devices)


def run_three(pool, model: str, mesh_shape: dict, dcn_shape: dict | None,
              tc_kwargs: dict, *, rows: int = 8, seq: int = 32,
              steps: int = 2, seed: int = 0, widths: dict | None = None,
              eval_batch: bool = False):
    """→ {"port": the sharded run's result (``train_case``), "one": (losses,
    params) of the port's one-device step, "jax": (losses, params) of the
    JAX sharded step}."""
    widths = widths or {}
    jcfg = replace(jmodels.CONFIGS[model], dtype=jnp.float32, **widths)
    tcfg = replace(TCONFIGS[model], dtype=torch.float32, **widths)
    jparams = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, jcfg.vocab_size, (rows, seq + 1))
               .astype(np.int32) for _ in range(steps)]
    ev = (rng.integers(0, jcfg.vocab_size, (rows, seq + 1)).astype(np.int32)
          if eval_batch else None)
    pool.submit(train_case, model,
                {"dtype": torch.float32, **widths}, mesh_shape, dcn_shape,
                tc_kwargs, params_np, batches, ev)

    # the JAX sharded step on the same mesh, while the ranks run
    tc = jtr.TrainConfig(**tc_kwargs)
    mesh = jax_mesh(mesh_shape, dcn_shape)
    state = jtr.init_state(jax.random.PRNGKey(seed), jcfg, tc)
    state["params"] = jparams
    step, sh, b_sh = jtr.make_sharded_train_step(jcfg, tc, mesh, state)
    state = jax.device_put(state, sh)
    jl = []
    for b in batches:
        state, loss = step(state, jax.device_put(jnp.asarray(b), b_sh))
        jl.append(float(loss))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), state["params"])

    # the port's one-device step
    ttc = ttr.TrainConfig(**tc_kwargs)
    tp = params_from_numpy(params_np, "cpu")
    ts = {"params": tp, "opt_state": ttr.make_optimizer(ttc).init(tp),
          "step": 0}
    tl = []
    for b in batches:
        ts, loss = ttr.train_step(ts, torch.from_numpy(b), tcfg, ttc)
        tl.append(loss.item())
    one = {k: v.numpy() for k, v in leaves(ts["params"])}
    port = pool.collect()[0]
    return {"port": port, "one": (tl, one), "jax": (jl, dict(leaves(jp))),
            "one_opt": ts["opt_state"], "cfg": tcfg, "batches": batches,
            "eval_batch": ev, "params_np": params_np}


def assert_three_agree(res) -> None:
    port = res["port"]
    got = dict(leaves(port["params"]))
    for name, (losses, params) in (("one-device port step", res["one"]),
                                   ("JAX sharded step", res["jax"])):
        np.testing.assert_allclose(port["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"losses against the {name}")
        assert set(got) == set(params)
        for path, want in params.items():
            np.testing.assert_allclose(
                got[path], want, **PARAM_TOL,
                err_msg=f"{path} against the {name}")
    # the optimizer's moments too, against the one-device step's
    for path, want in leaves(res["one_opt"]):
        have = dict(leaves(port["opt_state"]))[path]
        np.testing.assert_allclose(
            np.asarray(have, np.float32), want.float().numpy(),
            atol=1e-6, rtol=1e-5, err_msg=f"opt_state/{path}")
