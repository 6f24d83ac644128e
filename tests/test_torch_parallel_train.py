"""The port's sharded train step (``train/trainer.py``
``make_sharded_train_step``) on gloo ranks against the port's one-device
step and the JAX package's ``make_sharded_train_step`` on the same mesh,
at ``llama-test`` in f32 (``torch_parallel_parity.py``): each mesh axis
alone, ``data=2,fsdp=2,tensor=2``, ``expert=2,tensor=2``, the hybrid
``{fsdp:2, tensor:2} × dcn {data:2}``, Adafactor (at a width where it
factors) and ``accum_steps=2``: losses, every updated leaf and every
moment after two steps. Then the reference's sharded-step cases
(``tests/test_train.py``, ``tests/test_data_multislice.py``) against the
port. One pool of eight ranks serves the module."""

import jax
import numpy as np
import pytest
import torch

from torch_parallel_parity import assert_three_agree, leaves, run_three
from torch_parallel_support import RankPool, make_mesh
from tpu_kubernetes.train import data as jdata

MODEL = "llama-test"


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
    pytest.param({"data": 2, "fsdp": 2, "tensor": 2}, None,
                 {"accum_steps": 2}, id="data=2,fsdp=2,tensor=2-accum=2"),
    pytest.param({"fsdp": 2, "tensor": 2}, {"data": 2},
                 {"optimizer": "adafactor"}, id="hybrid-adafactor"),
    # stage and sequence are replica axes of the plain step, as under
    # GSPMD in the reference (the pipeline and ring attention are their
    # own entry points: test_torch_pipeline.py, test_torch_ring_attention.py)
    pytest.param({"stage": 2}, None, {}, id="stage=2"),
    pytest.param({"data": 2, "sequence": 2}, None, {},
                 id="data=2,sequence=2"),
]


@pytest.mark.parametrize("mesh,dcn,tc", MESHES)
def test_sharded_step_matches_one_device_and_jax(pool, mesh, dcn, tc):
    res = run_three(pool, MODEL, mesh, dcn, {"warmup_steps": 2, **tc})
    assert_three_agree(res)


def test_adafactor_factors_by_the_whole_leaf_shape(pool):
    """At d_model 128 optax factors the (128, 128) products; a rank of
    fsdp=2,tensor=2 holds (64, 64) blocks, under the 128 rule: the port
    factors them as the whole leaf, and its row and column statistics and
    update RMS reduce over the mesh."""
    res = run_three(pool, MODEL, {"fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2, "optimizer": "adafactor"},
                    widths={"d_model": 128, "d_ff": 256})
    assert_three_agree(res)
    # the factored statistics exist and came back whole
    v_row = dict(leaves(res["port"]["opt_state"]["v_row"]))
    assert v_row["layers/wq"].shape == (2, 128)


# -- the reference's cases (tests/test_train.py) ------------------------------

def test_sharded_train_step_2x2x2(pool):
    res = run_three(pool, MODEL, {"data": 2, "fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2}, steps=1, rows=4, seq=64)
    port = res["port"]
    assert np.isfinite(port["losses"][0]) and port["step"] == 1
    # params genuinely sharded: a rank holds a quarter of wq (fsdp ×
    # tensor), and its moments follow it
    whole = res["params_np"]["layers"]["wq"].size
    assert port["local_numel"]["wq"] == whole // 4


def test_sharded_matches_single_device(pool):
    """Same weights and batch → the same loss on one device and on the
    8-rank mesh (the reference holds bf16 to 1e-3; f32 here, tighter)."""
    res = run_three(pool, MODEL, {"data": 2, "fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2}, steps=1, rows=4, seq=64)
    assert abs(res["port"]["losses"][0] - res["one"][0][0]) < 1e-5


def test_eval_step_over_the_mesh_is_the_loss(pool):
    """The sharded eval step after training equals the one-device loss of
    the trained params on the same batch, and trains nothing."""
    from tpu_kubernetes_torch.models import loss_fn
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy

    res = run_three(pool, MODEL, {"data": 2, "fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2}, eval_batch=True)
    trained = params_from_numpy(res["port"]["params"], "cpu")
    want = loss_fn(trained, torch.from_numpy(res["eval_batch"]),
                   res["cfg"]).item()
    np.testing.assert_allclose(res["port"]["eval"], want, rtol=1e-5)


def test_sharded_accumulated_step_runs(pool):
    res = run_three(pool, MODEL, {"data": 2, "fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2, "accum_steps": 2}, steps=1)
    assert np.isfinite(res["port"]["losses"][0])
    assert res["port"]["step"] == 1


def test_adafactor_sharded_step_runs(pool):
    res = run_three(pool, MODEL, {"data": 2, "fsdp": 2, "tensor": 2}, None,
                    {"warmup_steps": 2, "optimizer": "adafactor"}, rows=4,
                    seq=64)
    port = res["port"]
    assert all(np.isfinite(port["losses"]))
    whole = res["params_np"]["layers"]["wq"].size
    assert port["local_numel"]["wq"] < whole


# -- tests/test_data_multislice.py's sharded cases ----------------------------

def _global_batch_case(token_dir: str):
    """Each rank's rows of the reference's global batch through
    ``global_batches``, then one sharded step on them → (rows, loss)."""
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.train import (
        TokenDataset,
        TrainConfig,
        global_batches,
        init_state,
        local_batches,
        make_sharded_train_step,
    )

    mesh = make_mesh({"data": 2, "fsdp": 2, "tensor": 2})
    cfg = CONFIGS[MODEL]
    tc = TrainConfig(warmup_steps=2)
    state = init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    step, sh, b_sh = make_sharded_train_step(cfg, tc, mesh, state, (8, 65))
    ds = TokenDataset(token_dir, seq=64, vocab_size=256)
    it = global_batches(local_batches(ds, 8, process_index=0,
                                      process_count=1), b_sh)
    rows = next(it)
    loss = float(step(torch.from_numpy(np.ascontiguousarray(rows))))
    return dist.get_rank(), rows, loss


@pytest.fixture(scope="module")
def token_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(0)
    for i in range(2):
        rng.integers(0, 256, 65 * 24).astype(np.uint16).tofile(
            d / f"shard{i}.bin")
    return d


def test_global_batch_feeds_sharded_train_step(pool, token_dir):
    """The reference's global batch, array for array, split over the
    data-like ranks in the batch sharding's order; ranks that differ only
    in tensor get the same rows."""
    out = pool.run(_global_batch_case, str(token_dir))
    ds = jdata.TokenDataset(token_dir, seq=64, vocab_size=256)
    want = next(jdata.local_batches(ds, 8, process_index=0,
                                    process_count=1))
    assert want.shape == (8, 65)
    for rank, rows, loss in out:
        assert np.isfinite(loss)
        chunk = rank // 2               # data × fsdp, tensor innermost
        np.testing.assert_array_equal(rows, want[chunk * 2:chunk * 2 + 2])
    assert len({loss for _, _, loss in out}) == 1


def test_train_step_over_hybrid_mesh(pool):
    """The sharded step over a hybrid mesh: data over DCN, fsdp × tensor
    within each slice."""
    res = run_three(pool, MODEL, {"fsdp": 2, "tensor": 2}, {"data": 2},
                    {"warmup_steps": 2}, steps=1, rows=8, seq=64)
    assert np.isfinite(res["port"]["losses"][0])
    np.testing.assert_allclose(res["port"]["losses"], res["jax"][0],
                               rtol=1e-5)
