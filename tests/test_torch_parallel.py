"""The port's ``parallel/`` package against the reference's
(``tests/test_parallel.py`` ``TestMesh`` and ``TestDistributedEnv``,
``tests/test_data_multislice.py``'s hybrid-mesh and multislice-env
cases), the logical-axis shardings of every leaf against the JAX
package's on several meshes, the divisibility errors, the batch rows a
rank holds, and the differentiable collectives on four gloo ranks against
their plain definitions."""

import jax
import numpy as np
import pytest
import torch

from torch_parallel_support import RankPool, collectives_case
from tpu_kubernetes import models as jmodels
from tpu_kubernetes import parallel as jpar
from tpu_kubernetes.topology.tpu import parse_mesh_shape as jparse
from tpu_kubernetes_torch import models as tmodels
from tpu_kubernetes_torch.parallel import (
    DATA_AXES,
    DEFAULT_RULES,
    MESH_AXES,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    device_prefix_for,
    initialize,
    logical_to_spec,
    mesh_shape_for_devices,
    param_shardings,
    parse_mesh_shape,
    read_env,
)
from tpu_kubernetes_torch.parallel.mesh import PartitionSpec, shard_tensor
from tpu_kubernetes_torch.train import trainer as ttr

EIGHT = list(range(8))


class TestMesh:
    def test_create_mesh_2x2x2(self):
        mesh = create_mesh({"data": 2, "fsdp": 2, "tensor": 2}, EIGHT)
        assert mesh.axis_names == ("data", "fsdp", "tensor")
        assert dict(mesh.shape) == {"data": 2, "fsdp": 2, "tensor": 2}

    def test_create_mesh_wrong_total(self):
        with pytest.raises(ValueError, match="wants 4 devices"):
            create_mesh({"data": 2, "tensor": 2}, devices=EIGHT)

    def test_unknown_axis_rejected(self):
        with pytest.raises(ValueError, match="unknown mesh axes"):
            create_mesh({"pipeline": 8}, EIGHT)

    def test_logical_to_spec_drops_trivial_axes(self):
        mesh = create_mesh({"data": 1, "fsdp": 8, "tensor": 1}, EIGHT)
        spec = logical_to_spec(("embed", "heads"), mesh=mesh)
        assert spec == PartitionSpec("fsdp", None)

    def test_batch_sharding_spans_data_axes(self):
        mesh = create_mesh({"data": 2, "fsdp": 4}, EIGHT)
        assert batch_sharding(mesh).spec == PartitionSpec(("data", "fsdp"))

    def test_mesh_shape_for_devices(self):
        shape = mesh_shape_for_devices(8)
        assert shape["fsdp"] * shape["tensor"] * shape["data"] == 8


class TestDistributedEnv:
    def test_reads_provisioner_contract(self):
        env = {
            "JAX_COORDINATOR_ADDRESS": "10.0.0.2:8476",
            "JAX_NUM_PROCESSES": "4",
            "JAX_PROCESS_ID": "3",
            "TPU_ACCELERATOR_TYPE": "v5p-32",
            "TPU_SLICE_TOPOLOGY": "2x2x4",
        }
        denv = read_env(env)
        assert denv.multi_host
        assert denv.coordinator_address == "10.0.0.2:8476"
        assert (denv.num_processes, denv.process_id) == (4, 3)
        assert denv == read_env(env) and denv.__dict__ == \
            jpar.read_env(env).__dict__

    def test_single_host_default(self):
        denv = read_env({})
        assert not denv.multi_host
        assert denv.process_id == 0

    def test_initialize_is_a_no_op_on_one_process(self):
        import torch.distributed as dist

        assert initialize({}, device="cpu") == read_env({})
        assert not dist.is_initialized()

    def test_several_ranks_need_a_rendezvous(self):
        with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
            initialize({"JAX_NUM_PROCESSES": "2"}, device="cpu")


class TestHybridMesh:
    def test_size_one_ici_axis_composes_with_dcn(self):
        mesh = create_hybrid_mesh(mesh_shape_for_devices(4), {"data": 2},
                                  EIGHT)
        assert dict(mesh.shape) == {"data": 2, "fsdp": 2, "tensor": 2}

    def test_dcn_by_ici_shape_and_order(self):
        mesh = create_hybrid_mesh({"fsdp": 2, "tensor": 2}, {"data": 2},
                                  EIGHT)
        assert mesh.axis_names == ("data", "fsdp", "tensor")
        assert dict(mesh.shape) == {"data": 2, "fsdp": 2, "tensor": 2}

    def test_even_grouping_without_slice_index(self):
        """Ranks group into slices by order: the DCN axis splits ranks
        [0..3] from [4..7] (a host's ranks are one slice)."""
        mesh = create_hybrid_mesh({"tensor": 4}, {"data": 2}, EIGHT)
        assert set(mesh.devices[0].ravel().tolist()) == {0, 1, 2, 3}

    def test_overlapping_axis_rejected(self):
        with pytest.raises(ValueError, match="both ici and dcn"):
            create_hybrid_mesh({"data": 2}, {"data": 2}, EIGHT)

    def test_wrong_total_rejected(self):
        with pytest.raises(ValueError, match="wants"):
            create_hybrid_mesh({"tensor": 2}, {"data": 2}, EIGHT)


class TestMultisliceEnv:
    def test_reads_megascale_contract(self):
        env = read_env({
            "JAX_COORDINATOR_ADDRESS": "10.0.0.2:8476",
            "JAX_NUM_PROCESSES": "8",
            "JAX_PROCESS_ID": "5",
            "MEGASCALE_NUM_SLICES": "2",
            "MEGASCALE_SLICE_ID": "1",
        })
        assert env.multi_host and env.multi_slice
        assert env.num_slices == 2 and env.slice_id == 1

    def test_single_slice_default(self):
        env = read_env({})
        assert not env.multi_slice and env.num_slices == 1


# -- against the JAX package's tables -----------------------------------------

def test_tables_are_the_references():
    assert MESH_AXES == jpar.MESH_AXES and DATA_AXES == jpar.DATA_AXES
    assert DEFAULT_RULES == jpar.DEFAULT_RULES


@pytest.mark.parametrize("spec", ["data=2,fsdp=8", " tensor = 4 ,", "",
                                  "expert=2,stage=1"])
def test_parse_mesh_shape_is_the_references(spec):
    assert parse_mesh_shape(spec) == jparse(spec)


@pytest.mark.parametrize("model", ["llama-test", "moe-test"])
@pytest.mark.parametrize("shape", [
    {"data": 2, "fsdp": 2, "tensor": 2}, {"expert": 4, "tensor": 2},
    {"fsdp": 8}, {"data": 2, "expert": 2, "tensor": 2}])
def test_every_leaf_is_sharded_as_the_reference_shards_it(model, shape):
    jmesh = jpar.create_mesh(shape, devices=jax.devices()[:8])
    want = jpar.param_shardings(jmodels.logical_axes(
        jmodels.CONFIGS[model]), jmesh)
    got = param_shardings(tmodels.logical_axes(tmodels.CONFIGS[model]),
                          create_mesh(shape, EIGHT))
    flat_want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                 jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    got, is_leaf=lambda x: not isinstance(x, dict))}

    def norm(spec):
        # JAX drops trailing Nones and writes a one-axis tuple bare
        spec = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
                for e in spec]
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    assert {k: norm(v) for k, v in flat_got.items()} == \
        {k: norm(v) for k, v in flat_want.items()}
    assert norm(batch_sharding(create_mesh(shape, EIGHT)).spec) == norm(
        jpar.batch_sharding(jmesh).spec)


def test_device_prefix_for_is_the_references():
    assert device_prefix_for({"tensor": 4}, EIGHT) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="wants 16 devices, have 8"):
        device_prefix_for({"fsdp": 16}, EIGHT, label="serve mesh")


@pytest.mark.parametrize("model,shape,match", [
    ("llama-test", {"tensor": 4}, "tensor of size 4 does not divide "
                                  "n_kv_heads 2"),
    ("llama-test", {"fsdp": 3}, "fsdp of size 3 does not divide d_model"),
    ("moe-test", {"expert": 8}, "expert of size 8 does not divide "
                                "n_experts 4"),
    ("llama-test", {"data": 3}, "does not divide batch rows"),
    ("llama-test", {"stage": 2}, "item 7b"),
])
def test_indivisible_splits_raise_naming_axis_and_dimension(model, shape,
                                                            match):
    cfg = tmodels.CONFIGS[model]
    mesh = create_mesh(shape, list(range(int(np.prod(list(
        shape.values()))))))
    with pytest.raises(ValueError, match=match):
        ttr._check_mesh(cfg, mesh, rows=8)


@pytest.mark.parametrize("accum", [1, 2])
def test_a_rank_holds_its_block_of_each_microbatch(accum, monkeypatch):
    """Rank r of data=2,fsdp=2,tensor=2 holds chunk r // 2 of each of the
    ``accum`` microbatches (the reference's microbatch i is rows
    [i·8/a, (i+1)·8/a), split over the data-like ranks)."""
    from tpu_kubernetes_torch.parallel import mesh as pmesh

    mesh = create_mesh({"data": 2, "fsdp": 2, "tensor": 2}, EIGHT)
    b_sh = batch_sharding(mesh)
    batch = torch.arange(16).reshape(16, 1)
    for rank in range(8):
        monkeypatch.setattr(pmesh.Mesh, "my_coords",
                            lambda self, r=rank: self.coords(r))
        rows = ttr.shard_batch(batch, b_sh, accum).ravel().tolist()
        chunk, micro = rank // 2, 16 // accum
        want = [i * micro + chunk * (micro // 4) + j for i in range(accum)
                for j in range(micro // 4)]
        assert rows == want


def test_shard_tensor_takes_each_rank_its_block():
    mesh = create_mesh({"fsdp": 2, "tensor": 2}, [0, 1, 2, 3])
    sh = param_shardings(tmodels.logical_axes(tmodels.CONFIGS["llama-test"]),
                         mesh)["layers"]["wq"]
    full = torch.arange(2 * 64 * 64).reshape(2, 64, 64)
    blocks = {r: shard_tensor(full, sh, r) for r in range(4)}
    assert blocks[3].shape == (2, 32, 32)
    np.testing.assert_array_equal(blocks[1], full[:, :32, 32:])
    np.testing.assert_array_equal(blocks[2], full[:, 32:, :32])


# -- the collectives on four ranks --------------------------------------------

@pytest.fixture(scope="module")
def results():
    pool = RankPool(4)
    try:
        yield pool.run(collectives_case, 7)
    finally:
        pool.close()


def test_collectives_forward_and_backward(results):
    """rank = 2·data + tensor; each op against its definition, and its
    backward the adjoint its axis calls for (true adjoints over data,
    Megatron's over tensor)."""
    xs = results[0]["xs"]
    w = np.arange(1.0, 25.0).reshape(3, 8) / 10
    for rank, out in enumerate(results):
        d, t = divmod(rank, 2)
        peers_d = [2 * i + t for i in range(2)]     # my data group
        peers_t = [2 * d + i for i in range(2)]     # my tensor group
        y, g = out["all_gather_data_dim1"]
        np.testing.assert_allclose(
            y, np.concatenate([xs[p] for p in peers_d], 1), rtol=1e-6)
        # backward: the sum over the group of each rank's cotangent block
        np.testing.assert_allclose(g, 2 * w[:, 4 * d:4 * d + 4], rtol=1e-6)
        y, g = out["reduce_scatter_data_dim1"]
        np.testing.assert_allclose(
            y, sum(xs[p] for p in peers_d)[:, 2 * d:2 * d + 2], rtol=1e-6)
        np.testing.assert_allclose(g, np.tile(w[:, :2], (1, 2)), rtol=1e-6)
        y, g = out["all_reduce_data"]
        np.testing.assert_allclose(y, sum(xs[p] for p in peers_d),
                                   rtol=1e-6)
        np.testing.assert_allclose(g, 2 * w[:, :4], rtol=1e-6)
        y, g = out["copy_to_tensor"]
        np.testing.assert_allclose(y, xs[rank], rtol=1e-6)
        np.testing.assert_allclose(g, 2 * w[:, :4], rtol=1e-6)
        y, g = out["reduce_from_tensor"]
        np.testing.assert_allclose(y, sum(xs[p] for p in peers_t),
                                   rtol=1e-6)
        np.testing.assert_allclose(g, w[:, :4], rtol=1e-6)
        y, g = out["gather_from_tensor"]
        np.testing.assert_allclose(
            y, np.concatenate([xs[p] for p in peers_t], -1), rtol=1e-6)
        np.testing.assert_allclose(g, w[:, 4 * t:4 * t + 4], rtol=1e-6)
        y, g = out["all_to_all_data"]
        blocks = [xs[p].reshape(2, 6)[d] for p in peers_d]
        np.testing.assert_allclose(y, np.stack(blocks).reshape(3, 4),
                                   rtol=1e-6)
        # the exchange back returns each cotangent block to its source: my
        # block i landed in row d of peer i's result
        row = w[:, :4].reshape(2, 6)[d]
        np.testing.assert_allclose(g, np.stack([row, row]).reshape(3, 4),
                                   rtol=1e-6)


def test_vocab_parallel_loss_is_the_plain_loss(results):
    for out in results:
        loss, plain, grad, plain_grad = out["vocab_parallel"]
        np.testing.assert_allclose(loss, plain, rtol=1e-6)
        np.testing.assert_allclose(grad, plain_grad, atol=1e-7, rtol=1e-5)
