"""The port's sharded LoRA step (``train/lora.py`` ``lora_shardings``,
``make_sharded_lora_step``) and ``FT_MESH`` in the finetune job, on gloo
ranks: the reference's ``tests/test_lora.py::test_sharded_lora_step``,
two f32 steps against the JAX ``make_sharded_lora_step`` on the same mesh
(losses, adapters and their AdamW moments; the base unchanged), the
adapters' shardings against the JAX package's, and ``FT_MESH`` with
``FT_DEVICE=cpu`` beside the JAX finetune job and the port's one-device
job."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_parity import leaves
from torch_parallel_support import RankPool, lora_case
from tpu_kubernetes.models import CONFIGS as JCONFIGS
from tpu_kubernetes.models import init_params as jinit_params
from tpu_kubernetes.parallel import create_mesh as jcreate_mesh
from tpu_kubernetes.train import synthetic_batches
from tpu_kubernetes.train import lora as jlora
from tpu_kubernetes_torch.models import CONFIGS
from tpu_kubernetes_torch.parallel import create_mesh
from tpu_kubernetes_torch.train.lora import LoraConfig, lora_shardings

CFG = replace(JCONFIGS["llama-test"], dtype=jnp.float32)
LC = {"rank": 4}
MESH = {"data": 2, "fsdp": 2, "tensor": 2}
F32 = {"dtype": torch.float32}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(scope="module")
def params():
    return jinit_params(jax.random.PRNGKey(0), CFG)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_sharded_lora_step(pool, params):
    """The reference's case: one step at data=2,fsdp=2,tensor=2, a finite
    loss, and the adapters partitioned (wq's B split over heads)."""
    state = jlora.init_lora_state(jax.random.PRNGKey(1), params, CFG,
                                  jlora.LoraConfig(**LC))
    batch = np.asarray(next(synthetic_batches(CFG.vocab_size, 8, 32)))
    res = pool.run(lora_case, "llama-test", F32, MESH, LC, _np(params),
                   _np(state["adapters"]), [batch], 1e-4)
    whole = int(np.prod(state["adapters"]["wq"]["b"].shape))
    assert np.isfinite(res[0]["losses"][0])
    for r in res:
        assert r["step"] == 1 and r["base_unchanged"]
        assert r["b_wq_numel"] < whole


def test_adapter_shardings_are_the_references():
    lc = LoraConfig(**LC, targets=("wq", "wk", "wv", "wo", "w_up",
                                   "w_down"))
    got = lora_shardings(CONFIGS["llama-test"], lc,
                         create_mesh(MESH, list(range(8))))
    want = jlora.lora_shardings(CFG, jlora.LoraConfig(**LC, targets=lc.targets),
                                jcreate_mesh(MESH))

    def norm(spec):
        return tuple(None if e is None else e for e in spec)

    for name in lc.targets:
        for k in ("a", "b"):
            assert norm(got[name][k].spec) == norm(
                tuple(want[name][k].spec) + (None,) * (
                    len(got[name][k].spec) - len(want[name][k].spec))), (
                name, k)


def test_two_f32_steps_equal_the_jax_sharded_lora_step(pool, params):
    """From the same base and adapters (B drawn non-zero, so that A's
    gradient, summed over the tensor ranks in the merge's backward, moves
    from the first step), two steps on both sides: each step's loss, the
    adapters and their AdamW moments after the second; the base is left
    bit for bit as it was."""
    lc = jlora.LoraConfig(**LC)
    state = jlora.init_lora_state(jax.random.PRNGKey(1), params, CFG, lc,
                                  learning_rate=1e-2)
    rng = np.random.default_rng(2)
    state["adapters"] = jax.tree.map(lambda a: a, state["adapters"])
    for name in state["adapters"]:
        b = state["adapters"][name]["b"]
        state["adapters"][name]["b"] = jnp.asarray(
            rng.standard_normal(b.shape) * 0.05, jnp.float32)
    state["opt_state"] = jlora.make_lora_optimizer(lc, 1e-2).init(
        state["adapters"])
    batches = [rng.integers(0, CFG.vocab_size, (8, 33)).astype(np.int32)
               for _ in range(2)]
    pool.submit(lora_case, "llama-test", F32, MESH, LC, _np(params),
                _np(state["adapters"]), batches, 1e-2)
    mesh = jcreate_mesh(MESH)
    step, s_sh, p_sh, b_sh = jlora.make_sharded_lora_step(
        CFG, lc, mesh, state, params, learning_rate=1e-2)
    jstate = jax.device_put(state, s_sh)
    jp = jax.device_put(params, p_sh)
    jl = []
    for b in batches:
        jstate, loss = step(jstate, jp, jax.device_put(jnp.asarray(b), b_sh))
        jl.append(float(loss))
    got = pool.collect()[0]
    assert got["base_unchanged"]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    have = dict(leaves(got["adapters"]))
    for path, want in leaves(_np(jstate["adapters"])):
        np.testing.assert_allclose(have[path], want, atol=1e-6, rtol=1e-5,
                                   err_msg=path)
    adam = jstate["opt_state"][0]
    for moment in ("mu", "nu"):
        have = dict(leaves(got["opt_state"][moment]))
        for path, want in leaves(_np(getattr(adam, moment))):
            np.testing.assert_allclose(have[path], want, atol=1e-7,
                                       rtol=1e-5, err_msg=f"{moment}/{path}")


def test_ft_mesh_job_beside_the_jax_job(tmp_path, capfd):
    """FT_MESH=fsdp=2,tensor=2 with FT_DEVICE=cpu (four gloo workers) and
    the JAX job (its mesh over the eight virtual devices: data=2 more)
    from one HF checkpoint and one token file: the same log lines from
    rank 0 alone, the same first loss (B starts at zero, so the first
    step's loss is the base's on the first batch), and merged weights that
    keep every unadapted leaf of the base bit for bit and move the
    adapted ones; the port's losses equal its one-device job's."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from tpu_kubernetes.models import load_hf as jload_hf
    from tpu_kubernetes.train.checkpoint import restore as jrestore
    from tpu_kubernetes.train.corpus import build_shards
    from tpu_kubernetes.train.finetune import run_finetune as jrun
    from tpu_kubernetes_torch.train.checkpoint import restore
    from tpu_kubernetes_torch.train.finetune import run_finetune

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
    )).save_pretrained(str(tmp_path / "hf"))
    text = tmp_path / "corpus.txt"
    text.write_text("the rings of ici carry the collectives\n" * 60)
    build_shards([text], tmp_path / "shards")
    common = {"FT_HF_CHECKPOINT": str(tmp_path / "hf"), "FT_STEPS": "2",
              "FT_BATCH": "8", "FT_SEQ": "32",
              "FT_DATA_PATH": str(tmp_path / "shards")}
    got = run_finetune({**common, "FT_DEVICE": "cpu",
                        "FT_MESH": "fsdp=2,tensor=2",
                        "FT_OUT": str(tmp_path / "port")})
    err = capfd.readouterr().err
    one = run_finetune({**common, "FT_DEVICE": "cpu",
                        "FT_OUT": str(tmp_path / "one")})
    capfd.readouterr()
    jrun({**common, "FT_MESH": "data=2,fsdp=2,tensor=2",
          "FT_OUT": str(tmp_path / "jax")})
    jerr = capfd.readouterr().err
    for marker in ("FIRST FINETUNE STEP at +", "step 2/2 loss=",
                   f"data: {tmp_path / 'shards'}", "merged weights → ",
                   f"base: HF checkpoint {tmp_path / 'hf'}"):
        assert marker in err and marker in jerr, marker
    assert err.count("FIRST FINETUNE STEP") == 1        # rank 0 alone
    assert "mesh={'fsdp': 2, 'tensor': 2}" in err

    def first(text):
        line = next(x for x in text.splitlines() if "FIRST FINETUNE" in x)
        return float(line.split("loss=")[1])

    # bf16 weights: the sums run in other orders on the two sides
    assert abs(first(err) - first(jerr)) < 2e-2
    np.testing.assert_allclose(got["losses"], one["losses"], atol=1e-2)
    jparams, _ = jload_hf(str(tmp_path / "hf"))
    jmerged = jrestore(tmp_path / "jax", like={"params": jparams})["params"]
    tlike = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.bfloat16),
                         jparams)
    merged = restore(tmp_path / "port", like={"params": tlike})["params"]
    base = _np(jparams)
    for path, want in leaves(base):
        have = dict(leaves(_np_torch(merged)))[path]
        moved = path.split("/")[-1] in ("wq", "wk", "wv", "wo")
        assert moved != np.array_equal(have, want), path
        assert moved != np.array_equal(
            dict(leaves(_np(jmerged)))[path], want), path


def _np_torch(tree):
    if isinstance(tree, dict):
        return {k: _np_torch(v) for k, v in tree.items()}
    return tree.float().numpy()
