"""Cases of the sharded serving tests (``tests/test_torch_serving*.py``):
run on every rank of a ``torch_parallel_support.RankPool``, each on the
CPU over gloo. Each builds its mesh over the first ranks of the world
(``make_mesh``), cuts the whole weights it is given to the rank's blocks
(``serving_param_shardings``) and returns numpy results; the ranks past
the mesh return None."""

from __future__ import annotations


def _tree_to_torch(tree):
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _setup(model: str, overrides: dict, mesh_shape: dict, params_np: dict,
           quant: bool = False):
    """→ (mesh or None, cfg, whole params, this rank's params, shardings)."""
    from dataclasses import replace

    from torch_parallel_support import make_mesh
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.quant import quantize_for_decode
    from tpu_kubernetes_torch.parallel import serving_param_shardings
    from tpu_kubernetes_torch.parallel.mesh import (
        shard_tensor,
        this_rank,
        tree_map_shardings,
    )

    mesh = make_mesh(mesh_shape)
    cfg = replace(CONFIGS[model], **overrides)
    whole = _tree_to_torch(params_np)
    if quant:
        whole = quantize_for_decode(whole, cfg)
    if mesh is None:
        return None, cfg, whole, None, None
    p_sh = serving_param_shardings(whole, cfg, mesh)
    rank = this_rank()
    local = tree_map_shardings(lambda t, sh: shard_tensor(t, sh, rank),
                               whole, p_sh)
    return mesh, cfg, whole, local, p_sh


def _numel(tree) -> dict:
    """Leaf path → numel and shape of a rank's tree."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = (int(v.numel()), tuple(v.shape))
    walk(tree, "")
    return out


def generate_case(model: str, overrides: dict, mesh_shape: dict,
                  params_np: dict, prompt, gen_kwargs: dict,
                  quant: bool = False, lengths=None, seeds=(None,),
                  logits: bool = False):
    """``make_sharded_generate`` on this rank: the rank's rows of
    ``prompt`` (its batch sharding), one call a seed of ``seeds`` → every
    rank's {"tokens": [whole batch (b, new) per call], "shapes": the
    rank's leaf (numel, shape)s, "logits": the whole batch's prefill
    logits under the mesh (``logits``)}."""
    import torch

    from tpu_kubernetes_torch.models.decode import prefill
    from tpu_kubernetes_torch.parallel import (
        kv_model_program,
        make_sharded_generate,
    )
    from tpu_kubernetes_torch.parallel.mesh import gather_tensor
    from tpu_kubernetes_torch.train.trainer import shard_batch

    mesh, cfg, whole, local, _ = _setup(model, overrides, mesh_shape,
                                        params_np, quant)
    if mesh is None:
        return None
    run, _, b_sh = make_sharded_generate(cfg, mesh, whole, **gen_kwargs)
    rows = shard_batch(torch.from_numpy(prompt), b_sh)
    lens = None if lengths is None else torch.from_numpy(lengths)
    out = {"tokens": [run(local, rows, seed, prompt_lengths=lens).numpy()
                      for seed in seeds],
           "shapes": _numel(local)}
    if logits:
        got, _ = kv_model_program(prefill, mesh)(local, rows, cfg)
        out["logits"] = gather_tensor(got, b_sh).numpy()
    return out


def kv_case(mesh_shape: dict, params_np: dict, prompts: list, first: list,
            steps: int, kv_quant: bool = False, paged: bool = False):
    """The slot engine's programs on head-sharded caches at
    ``mesh_shape``: each prompt of ``prompts`` (1-D int32) prefilled as a
    batch-1 row on the rank's heads (:func:`kv_widths`), inserted into its
    slot of a cold cache (or its pages of a cold pool), then ``steps``
    greedy segment steps from the rows' first tokens ``first``, then the
    first row cleared. Beside it the same data-movement
    bodies on one device over the one-device row caches, sharded with
    ``shard_kv``: → on every rank {"tokens": the segment's tokens,
    "moved_equal": every gathered cache after an insert, a page gather
    or a clear (of a copy, before the segment) bit for bit the one-device
    one, "rows_diff": the sharded prefill's gathered rows' largest
    difference from the one-device prefill's, "shapes": the rank's cache
    shapes}."""
    from dataclasses import replace

    import torch

    from tpu_kubernetes_torch.models import decode as tdec
    from tpu_kubernetes_torch.parallel import (
        gather_kv,
        kv_model_program,
        kv_movement,
        shard_kv,
    )

    mesh, cfg, whole, local, _ = _setup(
        "llama-test", {"dtype": torch.float32}, mesh_shape, params_np)
    if mesh is None:
        return None
    n = len(prompts)
    width, span, ps, row_ws = kv_widths(prompts, steps, paged)
    moved = []

    def clone(c):
        return replace(c, **{f: getattr(c, f).clone() for f in
                             ("k", "v", "k_scale", "v_scale")
                             if getattr(c, f) is not None})

    def same(sharded, one):
        g = gather_kv(sharded, mesh)
        moved.append(all(torch.equal(a, b) for a, b in (
            (g.k, one.k), (g.v, one.v),
            (g.k_scale, one.k_scale), (g.v_scale, one.v_scale))
            if a is not None))

    prefill = kv_model_program(tdec.prefill, mesh)
    one_rows, rows = [], []
    for p, row_w in zip(prompts, row_ws):
        t = torch.from_numpy(p)[None, :]
        lens = torch.tensor([len(p)], dtype=torch.int32)
        pad = torch.zeros((1, row_w), dtype=torch.int32)
        pad[0, :len(p)] = t
        one_rows.append(tdec.prefill(whole, pad, cfg, max_seq=row_w,
                                     lengths=lens, kv_quant=kv_quant)[1])
        rows.append(prefill(local, pad, cfg, max_seq=row_w, lengths=lens,
                            kv_quant=kv_quant)[1])
    diff = max(float((gather_kv(r, mesh).k - o.k).float().abs().max())
               for r, o in zip(rows, one_rows))
    st = tdec.init_slot_state(n, device="cpu")
    for i, p in enumerate(prompts):
        st.tok[i] = int(first[i])
        st.pos[i] = st.prompt_slots[i] = row_ws[i]
        st.remaining[i] = steps
        st.prompt_lengths[i] = len(p)
    if not paged:
        one = tdec.init_cache(cfg, n, span, kv_quant=kv_quant, device="cpu")
        cache = shard_kv(one, mesh)
        insert = kv_movement(tdec.cache_insert_row, mesh)
        for i in range(n):
            tdec.cache_insert_row(one, one_rows[i], i)
            insert(cache, shard_kv(one_rows[i], mesh), i)
            same(cache, one)
        one, cleared = tdec.cache_clear_row(clone(one), 0), clone(cache)
        kv_movement(tdec.cache_clear_row, mesh)(cleared, 0)
        same(cleared, one)
        out, _, _ = kv_model_program(tdec.decode_segment_slots, mesh)(
            local, cache, st, cfg, steps)
        shapes = [tuple(cache.k.shape)]
    else:
        n_pages = span // ps
        one = tdec.init_paged_pool(cfg, n * n_pages, ps, kv_quant=kv_quant,
                                   device="cpu")
        pool = shard_kv(one, mesh)
        table = torch.zeros((n, n_pages), dtype=torch.int32)
        insert = kv_movement(tdec.paged_insert_row, mesh)
        for i in range(n):
            table[i] = torch.arange(1 + i * n_pages, 1 + (i + 1) * n_pages)
            pages = table[i, :rows[i].k.shape[3] // ps]
            tdec.paged_insert_row(one, one_rows[i], pages)
            insert(pool, shard_kv(one_rows[i], mesh), pages)
            same(pool, one)
        got = kv_movement(tdec.gather_pages, mesh)(pool, table[0, :2])
        want = tdec.gather_pages(one, table[0, :2])
        moved.append(torch.equal(gather_kv(got, mesh).k, want.k))
        one, cleared = tdec.paged_clear_pages(clone(one), table[0]), \
            clone(pool)
        kv_movement(tdec.paged_clear_pages, mesh)(cleared, table[0])
        same(cleared, one)
        out, _, _ = kv_model_program(tdec.decode_segment_paged, mesh)(
            local, pool, table, st, cfg, steps)
        shapes = [tuple(pool.k.shape)]
    return {"tokens": out.numpy(), "moved_equal": moved, "rows_diff": diff,
            "shapes": shapes}


def kv_widths(prompts: list, steps: int, paged: bool):
    """→ (the widest prompt, the cache span, the page size, each row's
    prefill width: the widest prompt, or paged its own pages)."""
    ps = 8
    width = max(len(p) for p in prompts)
    span = -(-(width + steps + 8) // ps) * ps
    rows = [-(-len(p) // ps) * ps if paged else width for p in prompts]
    return width, span, ps, rows


def resume_case(mesh_shape: dict, params_np: dict, prefix, suffix):
    """``prefill`` of ``prefix`` then ``prefill_resume`` of ``suffix``
    (both (b, n) int32) on head-sharded caches → every rank's whole-vocab
    logits of the resume and the greedy tokens of 4 decode steps after
    it."""
    import torch

    from tpu_kubernetes_torch.models import decode as tdec
    from tpu_kubernetes_torch.parallel import kv_model_program

    mesh, cfg, _, local, _ = _setup(
        "llama-test", {"dtype": torch.float32}, mesh_shape, params_np)
    if mesh is None:
        return None
    span = prefix.shape[1] + suffix.shape[1] + 4
    _, cache = kv_model_program(tdec.prefill, mesh)(
        local, torch.from_numpy(prefix), cfg, max_seq=span)
    logits, cache = kv_model_program(tdec.prefill_resume, mesh)(
        local, torch.from_numpy(suffix), cfg, cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    done = torch.zeros_like(tok, dtype=torch.bool)
    out, *_ = kv_model_program(tdec.decode_segment, mesh)(
        local, cache, tok, done, cfg, 4)
    return {"logits": logits.numpy(),
            "tokens": torch.cat([tok[:, None], out], dim=1).numpy(),
            "kv_heads": int(cache.k.shape[2])}


def remat_thread_case(model: str, params_np: dict, tokens):
    """``loss_fn`` with remat under fsdp=2,tensor=2, its gradients taken
    inside the mesh context on this thread, then taken on another thread
    that entered no mesh (the autograd engine runs a CUDA backward, and
    so remat's recompute, on a thread of its own) → rank 0's largest
    difference between the two."""
    import threading
    from dataclasses import replace

    import torch

    from torch_parallel_support import make_mesh
    from tpu_kubernetes_torch.models import CONFIGS, logical_axes, loss_fn
    from tpu_kubernetes_torch.parallel.mesh import (
        batch_sharding,
        mesh_context,
        param_shardings,
        shard_tensor,
        this_rank,
        tree_map_shardings,
    )
    from tpu_kubernetes_torch.train.trainer import shard_batch, tree_leaves

    mesh = make_mesh({"fsdp": 2, "tensor": 2})
    if mesh is None:
        return None
    cfg = replace(CONFIGS[model], dtype=torch.float32, remat=True)
    sh = param_shardings(logical_axes(cfg), mesh)
    local = tree_map_shardings(
        lambda t, s: shard_tensor(t, s, this_rank()).requires_grad_(True),
        _tree_to_torch(params_np), sh)
    leaves = tree_leaves(local)
    rows = shard_batch(torch.from_numpy(tokens), batch_sharding(mesh))

    def grads(elsewhere: bool):
        with mesh_context(mesh):
            loss = loss_fn(local, rows, cfg)
            if not elsewhere:
                return torch.autograd.grad(loss, leaves)
        out = {}

        def back():
            try:
                out["g"] = torch.autograd.grad(loss, leaves)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                out["e"] = e

        t = threading.Thread(target=back)
        t.start()
        t.join()
        if "e" in out:
            raise out["e"]
        return out["g"]

    here, there = grads(False), grads(True)
    diff = max(float((a - b).abs().max()) for a, b in zip(here, there))
    return diff if this_rank() == 0 else None
