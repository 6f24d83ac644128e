"""The port's sharded train step at ``moe-test-grouped`` on gloo ranks,
against
the port's one-device step and the JAX package's
``make_sharded_train_step`` on the same mesh, in f32
(``torch_parallel_parity.py``): each mesh axis alone — ``expert=2`` is
the expert-parallel grouped branch (``models/moe_ep.py``: counts
all-gathered, rows over worst-case bins by all-to-all, the local grouped
matmul, the exchange back) — ``data=2,fsdp=2,tensor=2``,
``expert=2,tensor=2``, the hybrid ``{fsdp:2, tensor:2} × dcn {data:2}``,
Adafactor and ``accum_steps=2``: losses, every updated leaf and moment
after two steps (the reference's expert-parallel cases:
``tests/test_torch_parallel_ep.py``). One pool of eight ranks serves the
module."""

import pytest

from torch_parallel_parity import assert_three_agree, run_three
from torch_parallel_support import RankPool

MODEL = "moe-test-grouped"


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


MESHES = [
    pytest.param({"data": 2}, None, {}, id="data=2"),
    pytest.param({"fsdp": 2}, None, {}, id="fsdp=2"),
    pytest.param({"tensor": 2}, None, {}, id="tensor=2"),
    pytest.param({"expert": 2}, None, {}, id="expert=2"),
    pytest.param({"data": 2, "fsdp": 2, "tensor": 2}, None, {},
                 id="data=2,fsdp=2,tensor=2"),
    pytest.param({"expert": 2, "tensor": 2}, None, {},
                 id="expert=2,tensor=2"),
    pytest.param({"fsdp": 2, "tensor": 2}, {"data": 2}, {},
                 id="hybrid-fsdp=2,tensor=2-dcn-data=2"),
    pytest.param({"expert": 2, "tensor": 2}, {"data": 2},
                 {"accum_steps": 2}, id="hybrid-expert=2,tensor=2-accum=2"),
    pytest.param({"expert": 2, "fsdp": 2, "tensor": 2}, None,
                 {"optimizer": "adafactor"},
                 id="expert=2,fsdp=2,tensor=2-adafactor"),
]


@pytest.mark.parametrize("mesh,dcn,tc", MESHES)
def test_sharded_step_matches_one_device_and_jax(pool, mesh, dcn, tc):
    res = run_three(pool, MODEL, mesh, dcn, {"warmup_steps": 2, **tc})
    assert_three_agree(res)
