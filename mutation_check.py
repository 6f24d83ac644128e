"""Mutation check of the tensor-core backward kernels (flash dQ and dK/dV,
grouped drhs), of the fused AdamW update and of decode attention (both
routes): build
broken copies of the port's CUDA sources outside the checkout and run the
kernel tests against each; every broken copy in ``MUTATIONS`` must fail
some of them.

    python3 mutation_check.py [NAME ...]

Needs a CUDA card and ``nvcc`` (each copy builds its own libraries). For
each mutation it prints one line, ``mutation NAME: N failed of M`` and the
failing tests, and it exits 1 when a mutation of ``MUTATIONS`` fails no
test. The copies in ``RACES`` are run and reported too but do not set the
exit code: no test is expected to see them (see there). Given names, it
runs only the copies whose names contain one of them (``decode_attention``:
both decode-attention kernels' copies). Each copy builds its libraries
together, one ``nvcc`` per source, before its tests. The broken copies
live in a temporary directory that is removed afterwards.

The copies in ``PARALLEL`` break the sharded steps' Python (a skipped
reduction, an optimizer never applied, the pipeline's embedding gradient
left on stage 0, the shift's backward sent the wrong way, the LoRA
merge's A gradient not summed over tensor) and are held by
``chip_smoke.py``'s parallel phase instead of the tests: the checkout
runs every case of it (the meshes of ``PAR_CASES`` and ``PIPE_CASES``,
``LORA_CASE`` against the one-process steps, ring attention against the
flash kernels), each copy the families it touches, and each prints one
line a case, ``parallel NAME CASE: {readings}`` with the readings over
their limits (``PAR_TOL``, ``RING_ULPS``; ``replicas``: 1 when the ranks
gathered different states). The checkout must read none over its limit
and each copy some (``parallel``: the checkout and every parallel copy).
They need one card, share the checkout's libraries (their CUDA sources
are the checkout's) and take one to three minutes each.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TESTS = "tests/test_torch_kernel_cuda.py"
# the backward (dQ and dK/dV), grouped, AdamW and decode-attention tests
SELECT = ("dq or dkv or drhs or backward or grouped or autograd or adamw "
          "or decode_attention")
# name → (source under csrc/, [(text, its replacement), ...])
MUTATIONS = {
    # gmm_drhs_tc zeroes lhs from one row past the group's end, so the
    # next group's first row in the last slice enters the product
    "drhs_zero_from_one_row_late": ("grouped_matmul.cu", [
        ("uint4* tail = reinterpret_cast<uint4*>(a + valid * 128);",
         "uint4* tail = reinterpret_cast<uint4*>(a + (valid + 1) * 128);"),
        ("i < (TR - valid) * 8;", "i < (TR - valid - 1) * 8;"),
    ]),
    # flash_bwd_dkv_tc keeps one key past the causal diagonal
    "dkv_causal_diagonal_off_by_one": ("flash_bwd.cu", [
        ("> col + offset)", "> col + offset + 1)"),
    ]),
    # flash_bwd_dkv_tc reads lse by its K/V row instead of by q column
    "dkv_lse_by_row": ("flash_bwd.cu", [
        ("const float2 l2 = *reinterpret_cast<const float2*>"
         "(lse_t + 8 * jc + cq);",
         "const float2 l2 = make_float2(lse_t[(row0 - k0) % 64], "
         "lse_t[(row0 - k0) % 64]);"),
    ]),
    # flash_bwd_dq_tc keeps one key past the causal diagonal of each row
    "dq_causal_diagonal_off_by_one": ("flash_bwd.cu", [
        ("const int last0 = row0 + offset;",
         "const int last0 = row0 + offset + 1;"),
        ("const int last1 = row0 + 8 + offset;",
         "const int last1 = row0 + 8 + offset + 1;"),
    ]),
    # flash_bwd_dq_tc reads delta of the neighbouring row in its 8-row
    # group for the first of its two rows
    "dq_delta_of_the_neighbour_row": ("flash_bwd.cu", [
        ("const float dl0 = row0 < seq_q ? delta[vec + row0] : 0.f;",
         "const float dl0 = row0 < seq_q ? "
         "delta[vec + min(row0 ^ 1, seq_q - 1)] : 0.f;"),
    ]),
    # adamw_update divides nu by 1 instead of its bias correction
    "adamw_no_bias_correction_of_nu": ("adamw.cu", [
        ("__fsqrt_rn(__fdiv_rn(nu, bc2))", "__fsqrt_rn(nu)"),
    ]),
    # adamw_update skips the weight decay on f32 leaves (MoE's router)
    "adamw_no_weight_decay_on_f32": ("adamw.cu", [
        ("  const float bc1 = scalars[1], bc2 = scalars[2];\n",
         "  const float bc1 = scalars[1], bc2 = scalars[2];\n"
         "  Hyper hd = h;\n"
         "  if (sizeof(T) == 4) hd.wd = 0.f;\n"),
        ("adamw_element(h, div", "adamw_element(hd, div"),
    ]),
    # decode_attention_tc admits the pad gap of a ragged row (a tile
    # wholly inside the gap, and a paged box, are still skipped)
    "decode_attention_reads_the_pad_gap": ("decode_attention_tc.cu", [
        ("    return p < lim && !(p >= glo && p < ghi);",
         "    return p < lim;"),
    ]),
    # decode_attention_tc merges its cluster's partials without rescaling
    # each to the largest max
    "decode_attention_merge_without_rescale": ("decode_attention_tc.cu", [
        ("const float wt = hopper::exp2_approx(mj[j] - mx);",
         "const float wt = 1.f;"),
    ]),
    # decode_attention_tc's consumers read ring stage 1 without waiting for
    # its TMA loads to land
    "decode_attention_tc_skips_a_stage_wait": ("decode_attention_tc.cu", [
        ("      hopper::mbar_wait(&full[s], (k / S) & 1);",
         "      if (s != 1) hopper::mbar_wait(&full[s], (k / S) & 1);"),
    ]),
    # the same two faults in the CUDA-core kernel (the simt route): the pad
    # gap read (a split wholly inside the gap is still skipped), the
    # splits merged without their rescale
    "decode_attention_simt_reads_the_pad_gap": ("decode_attention.cu", [
        ("  return p >= gap_lo && p < gap_hi;", "  return false;"),
    ]),
    "decode_attention_simt_merge_without_rescale": ("decode_attention.cu", [
        ("ms == -INFINITY ? 0.f : expf(ms - m);",
         "ms == -INFINITY ? 0.f : 1.f;"),
    ]),
}
# the sharded steps' faults (paths under tpu_kubernetes_torch/), each
# with the families of chip_smoke.py's parallel cases that it touches: the
# gradients of leaves replicated over a data-like axis are not summed over
# it; an fsdp (or expert-slab) gather's backward keeps the rank's own
# cotangent block instead of the sum over the group; the tensor-split
# products' input gradients are not summed over tensor; the optimizer
# never runs (the params and moments stay as they began); the pipeline's
# microbatches skip copy_to over stage (only stage 0 gets an embedding
# gradient); the shift's backward sends the cotangents along the forward
# pairs; the LoRA merge's A gradient is not summed over tensor
PARALLEL = {
    "parallel_no_data_allreduce_of_gradients": ("train/trainer.py", [
        ("            g = all_reduce_raw(g, self.mesh.group(axes))\n", ""),
    ]),
    "parallel_gather_backward_not_summed": ("parallel/collectives.py", [
        ("        return reduce_scatter_raw(g, ctx.dim, ctx.group), None, None",
         "        k = g.shape[ctx.dim] // dist.get_world_size(ctx.group)\n"
         "        return (g.narrow(ctx.dim, dist.get_rank(ctx.group) * k, k)"
         ".contiguous(), None, None)"),
    ]),
    "parallel_copy_to_backward_not_reduced": ("parallel/collectives.py", [
        ("        return x.view_as(x)\n\n    @staticmethod\n"
         "    def backward(ctx, g):\n"
         "        return all_reduce_raw(g, ctx.group), None",
         "        return x.view_as(x)\n\n    @staticmethod\n"
         "    def backward(ctx, g):\n        return g, None"),
    ]),
    "parallel_optimizer_not_applied": ("train/trainer.py", [
        ("        opt.update_(grads, state[\"opt_state\"], params, "
         "shards=shards)\n", ""),
    ]),
    "parallel_pipeline_embedding_not_copied_over_stage": (
        "parallel/pipeline.py", [
            ("    x = copy_to(x, stage_group)\n", ""),
        ]),
    "parallel_shift_backward_sent_forward": ("parallel/collectives.py", [
        ("        back = [(j, i) for i, j in ctx.perm]\n",
         "        back = ctx.perm\n"),
    ]),
    "parallel_lora_a_gradient_not_summed_over_tensor": ("train/lora.py", [
        ("            a = copy_to(a, groups[name][\"a\"])\n", ""),
    ]),
}
# the families of the parallel phase each copy runs (the checkout: all)
FAMILIES = ("train", "pipeline", "lora", "ring")
TOUCHES = {
    "parallel_pipeline_embedding_not_copied_over_stage": ("pipeline",),
    "parallel_shift_backward_sent_forward": ("pipeline", "ring"),
    "parallel_lora_a_gradient_not_summed_over_tensor": ("lora",),
}
# each case of chip_smoke.py's parallel families (argv) → one line of its
# readings
PAR_DRIVER = """
import json, sys, tempfile
from pathlib import Path
import chip_smoke as cs
from tpu_kubernetes_torch.ops import _build
_build.build()
families = sys.argv[1:]


def line(case, got, tol):
    print(json.dumps({"case": case, "readings": got,
                      "over": [k for k, v in got.items() if v > tol[k]]}),
          flush=True)


def train_like(case, res, tol):
    got = {**cs.par_got(res[0]), "replicas": float(any(
        r.get("fingerprint") != res[0].get("fingerprint") for r in res))}
    line(case, got, {**tol, "replicas": 0.0})


with tempfile.TemporaryDirectory() as tmp:
    pool = cs.ParPool(Path(tmp))
    try:
        if "train" in families:
            for model, dtype_name, mesh in cs.PAR_CASES:
                res = [r for r in pool.run(cs.par_case, model, dtype_name,
                                           mesh) if r is not None]
                train_like(f"{model} {dtype_name} {cs.par_mesh_label(mesh)}",
                           res, cs.PAR_TOL[dtype_name])
        if "pipeline" in families:
            for dtype_name, mesh in cs.PIPE_CASES:
                res = [r for r in pool.run(cs.par_case, "llama-1b",
                                           dtype_name, mesh, True)
                       if r is not None]
                train_like(f"pipelined llama-1b {dtype_name} "
                           f"{cs.par_mesh_label(mesh)}", res,
                           cs.PAR_TOL[dtype_name])
        if "lora" in families:
            dtype_name, mesh = cs.LORA_CASE
            res = [r for r in pool.run(cs.lora_par_case, dtype_name, mesh)
                   if r is not None]
            train_like(f"sharded LoRA {dtype_name} "
                       f"{cs.par_mesh_label(mesh)}", res,
                       cs.PAR_TOL[dtype_name])
        if "ring" in families:
            r0 = pool.run(cs.ring_par_case, cs.RING_SEQ)[0]
            line(f"ring attention {cs.RING_SEQ}",
                 {k: r0[k] for k in cs.RING_ULPS}, cs.RING_ULPS)
    finally:
        pool.close()
"""
# Orderings that only a race could show. gmm_drhs_tc releases a ring stage
# to the producer as soon as the wgmma reading it is issued, instead of one
# slice later after wgmma_wait<1>: the 32 KB TMA refill takes longer than
# the queued wgmma's reads, so the tests pass on the card all the same; the
# release order rests on reading the code. decode_attention_tc's consumers
# release a stage as soon as it has landed, before they read it: the
# refill's TMA latency is mostly longer than a warp's 16 ldmatrix reads of
# the stage, so a test sees it only when the schedule goes against it (one
# test of 115 on the card in one run; none may fail in the next).
RACES = {
    "decode_attention_tc_releases_a_stage_before_reading_it": (
        "decode_attention_tc.cu", [
            ("      hopper::mbar_wait(&full[s], (k / S) & 1);\n",
             "      hopper::mbar_wait(&full[s], (k / S) & 1);\n"
             "      __syncwarp();\n"
             "      if (lane == 0) hopper::mbar_arrive(&empty[s]);\n"),
            ("      __syncwarp();\n"
             "      if (lane == 0) hopper::mbar_arrive(&empty[s]);\n"
             "    }\n\n",
             "    }\n\n"),
        ]),
    "drhs_release_stage_before_its_wgmma": ("grouped_matmul.cu", [
        ("hopper::wgmma_wait<1>();            // the slice before is done\n"
         "          if (r0 > lo) hopper::mbar_arrive(&empty[prev]);",
         "hopper::mbar_arrive(&empty[s]);\n"
         "          hopper::wgmma_wait<1>();"),
        ("hopper::fence_operands(acc);\n"
         "        hopper::mbar_arrive(&empty[prev]);\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int h = 0; h < 2; ++h) {\n"
         "        __nv_bfloat16* orow =\n"
         "            drhs +",
         "hopper::fence_operands(acc);\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int h = 0; h < 2; ++h) {\n"
         "        __nv_bfloat16* orow =\n"
         "            drhs +"),
    ]),
}


def broken_copy(dst: Path, source: str, edits) -> None:
    """The port, its gpu tests and ``chip_smoke.py`` under ``dst``, with
    ``edits`` applied to ``csrc/source`` (a ``.py`` source: the path under
    the package) (each text everywhere it occurs); raises if a text to
    replace is missing."""
    shutil.copytree(ROOT / "tpu_kubernetes_torch", dst / "tpu_kubernetes_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "tests").mkdir()
    shutil.copy(ROOT / TESTS, dst / TESTS)
    shutil.copy(ROOT / "pyproject.toml", dst / "pyproject.toml")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    path = (dst / "tpu_kubernetes_torch" / source if source.endswith(".py")
            else dst / "tpu_kubernetes_torch" / "csrc" / source)
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source}: {old!r} not found")
        text = text.replace(old, new)
    path.write_text(text)


def run_tests(cwd: Path) -> tuple[int, int, list[str]]:
    """(failed, run, failing test ids) of the selected gpu tests in ``cwd``,
    after building every library of its sources at once."""
    subprocess.run([sys.executable, "-c", "from tpu_kubernetes_torch.ops "
                    "import _build; _build.build()"], cwd=cwd, check=True,
                   timeout=900)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-k", SELECT, TESTS],
        cwd=cwd, capture_output=True, text=True, timeout=900).stdout
    counts = {word: int(n) for n, word in
              re.findall(r"(\d+) (failed|passed|error)", out.splitlines()[-1])}
    failed = counts.get("failed", 0) + counts.get("error", 0)
    ids = [line.split()[1] for line in out.splitlines()
           if line.startswith("FAILED ")]
    return failed, failed + counts.get("passed", 0), ids


def run_parallel(cwd: Path, families=FAMILIES
                 ) -> tuple[list[str], list[str]]:
    """(each case's line, the cases with a reading over its limit) of
    ``PAR_DRIVER`` over ``families`` in ``cwd``; a failed run is one line
    and counts as over."""
    proc = subprocess.run([sys.executable, "-c", PAR_DRIVER, *families],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        tail = (proc.stderr.strip().splitlines() or ["no output"])[-1]
        return [f"exit {proc.returncode}: {tail}"], ["the run"]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return ([f"{r['case']}: {json.dumps(r['readings'])} over {r['over']}"
             for r in rows], [r["case"] for r in rows if r["over"]])


def main(names: list[str]) -> int:
    missed = []
    chosen = [n for n in PARALLEL if not names or any(m in n for m in names)]
    if chosen:
        lines, over = run_parallel(ROOT)
        for line in lines:
            print(f"parallel checkout {line}", flush=True)
        if over:
            missed.append("the checkout (readings over their limits)")
    for name in chosen:
        source, edits = PARALLEL[name]
        with tempfile.TemporaryDirectory(prefix="mutation-") as tmp:
            broken_copy(Path(tmp), source, edits)
            (Path(tmp) / "build").symlink_to(ROOT / "build")
            lines, over = run_parallel(Path(tmp),
                                       TOUCHES.get(name, ("train",)))
        for line in lines:
            print(f"parallel {name} {line}", flush=True)
        if not over:
            missed.append(name)
    for name, (source, edits) in {**MUTATIONS, **RACES}.items():
        if names and not any(n in name for n in names):
            continue
        with tempfile.TemporaryDirectory(prefix="mutation-") as tmp:
            broken_copy(Path(tmp), source, edits)
            failed, run, ids = run_tests(Path(tmp))
        print(f"mutation {name}: {failed} failed of {run}", flush=True)
        for test in ids:
            print(f"  {test}")
        if failed == 0 and name in MUTATIONS:
            missed.append(name)
    if missed:
        print(f"not caught: {', '.join(missed)}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
