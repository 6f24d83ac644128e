#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: the card's name and power limit (``nvidia-smi``), then every
   CUDA kernel source of the port built from ``tpu_kubernetes_torch/csrc``
   (one ``nvcc`` per source, started together, the shared ``hopper.cuh``
   included), with the build seconds.
2. Forward kernel against plain: the flash-attention forward against
   ``attention_reference`` on the same tensors (O, and LSE against
   ``logsumexp``) over the listed shapes, bf16 and f32, causal (square
   and ``seq_q < seq_k``, ragged) and not, through the route the dtype
   and head_dim pick (bf16 at d 64/128: the tensor-core kernel
   ``flash_fwd_tc``, held besides to the f32 attention on the same
   inputs within its bf16 roundings of P and O), and for bf16 at d 64/128
   through the CUDA-core kernel too. At llama-1b's serving and training
   shapes and moe-1b's training shape: both routes' times, the plain
   version's, the bound, and one ``scaled_dot_product_attention`` call as
   a yardstick only (the port never calls it).
3. Backward kernels against plain: dq (the dQ kernel) and dk, dv (the
   dK/dV kernel), both through the route the dtype and head_dim pick
   (bf16 at d 64/128 the tensor-core kernels ``flash_bwd_dq_tc`` and
   ``flash_bwd_dkv_tc``, held besides to the f32 dQ and dK, dV of the same
   inputs within their bf16 roundings of dS, Pᵀ, dSᵀ and the outputs; for
   those cases the CUDA-core kernels too, the CUDA-core dQ bit for bit)
   against ``attention_bwd_reference`` from the same O and LSE, and
   against the autograd gradient of ``attention_reference``, over the
   same cases. At llama-1b's and moe-1b's training shapes: both routes'
   times of both kernels, each with its plain version's, its bound, and
   the autograd backward of one ``scaled_dot_product_attention`` call as
   a yardstick.
4. Grouped-matmul kernels against plain: the forward kernel (and its
   dlhs form, rhs read transposed) against ``grouped_matmul_reference``
   and the drhs kernel against ``gmm_drhs_reference``, bf16 and f32, over
   the reference test's size patterns (balanced, empty groups, one group
   taking all, tiny groups, split boundaries), a K over several slices,
   E = 5, rows past the last group, M off the 128-row tiles, an empty last
   group, moe-1b's decode shape (8 rows + 120 pad rows in the last group),
   its prefill shapes (8,192 rows, bf16 and f32) and its training shapes,
   and a case that laps the tensor-core forward's ring many times; bf16
   through the tensor-core kernels ``gmm_forward_tc`` and ``gmm_drhs_tc``
   (held besides to the f32 result within their one rounding and their
   accumulation's drift) and through the CUDA-core ones. At the training,
   prefill and decode shapes: both forward routes' times (and their dlhs
   forms'); at both training shapes (w_gate's and w_down's K, N) both
   drhs routes' times; each with the bound, the plain version's time and
   one ``torch._grouped_mm`` call as a yardstick (the port never calls
   it). Then ``grouped_matmul``'s gradients through the kernels against
   the plain lane's, one launch of each kernel a backward, on the route
   of its dtype.
5. Serving, llama-1b at full width (16 layers, bf16, random weights from
   a seeded ``torch.Generator``): with every launch count set to 0, a
   ragged ``prefill`` of 4 rows at width 1024 (16 kernel launches) and a
   greedy ``generate`` of 64 new tokens (the decode-attention kernel once
   a layer a step); then the kernel's logits against the plain lane's,
   of the prefill and of one decode step.
6. Serving, moe-1b at full width and depth with ``dispatch_mode="grouped"``
   (12 layers, bf16, random weights from a seeded ``torch.Generator``):
   with every count set to 0, a ragged ``prefill`` of 4 rows at width 1024
   (36 grouped and 12 flash launches) and a greedy ``generate`` of 64
   tokens; prefill tokens/s and decode ms/step; then the same in f32 (the
   CUDA-core routes, every count set to 0 just before), kernel lane
   against plain lane: greedy tokens identical, logits within tolerance,
   and 0 routing decisions differing.
7. Training, llama-1b at full width and depth (bf16, remat "dots"):
   ``tpu_kubernetes_torch.train.job.main()`` for 10 steps at 4 × 2048 with
   every launch count set to 0 just before and read just after (forward
   320 = 16 per forward + 16 again under remat, dQ 160, dK/dV 160, all on
   the tensor-core routes), with its held-out loss every 5 steps over 2
   batches of a token file written from a seed in a temporary directory
   (the eval step's graph, 16 more forward launches a batch), a
   finite loss and the job's tokens/s; 5 ``train_step``s overfitting one
   batch (the loss must fall); the loss and every gradient leaf of a
   2-layer llama-1b at 1 × 2048 through the kernels against the plain
   lane's; one profile window of a train step.
8. Training, moe-1b grouped at 4 × 2048 under remat "moe": 10
   ``train_step``s with exact launch counts (per step 96 grouped, 36 drhs,
   24 / 12 / 12 flash), a finite loss and the steady tokens/s; an overfit
   of one batch over 5 steps (the loss must fall); one profile window of
   a train step; the loss and every gradient leaf (``w_router`` included)
   of a 2-layer moe-1b at 1 × 2048 in f32, kernel lane against plain lane,
   with every count set to 0 just before (the main path of the CUDA-core
   dQ, dK/dV and drhs kernels).
9. The MoE training job: ``train.job.main()`` with ``JOB_MODEL=moe-1b`` for
   10 steps at 4 × 2048, at the preset's own "gather" dispatch (flash
   launches only), a finite loss and the job's tokens/s.
9b. The rest of one-device training and the model tooling, at llama-1b
   width and depth (``phase_tooling``): the train job with
   ``JOB_OPTIMIZER=adafactor`` at 4 × 2048 on a token file written from a
   seed, 10 steps with every count set to 0 just before and read just
   after (forward 320, dQ 160, dK/dV 160, ``adamw_sumsq`` 10 for the
   clip, no ``adamw_update``); then five steps that save once to
   ``JOB_CHECKPOINT_DIR`` and a second ``main()`` that resumes from step 5
   to 10, its losses against the uninterrupted run's (bitwise, or within
   the graphed-vs-eager bound), the checkpoint's bytes and the save and
   restore seconds; the AdamW job beside it (memory peaks), both
   optimizer states (Adafactor's statistics bf16, nine leaves factored,
   its bytes under AdamW's) and both graphed steps in turns (step wall).
   Then ``run_finetune`` (LoRA rank 8 on wq, wk, wv, wo, 10 steps on one
   batch of a token file, ``FT_OUT`` in a temporary directory) with exact
   counts (the train step's flash launches, ``adamw_update`` 10, no norm
   kernel): the loss falls, the merged w_gate, w_up, w_down and norms are
   the base's bit for bit and the targets moved, the graphed steps'
   losses equal an eager ``make_lora_step``'s within the bf16 training
   bound; the step walls. Then llama-1b params through
   ``hf_state_dict_from_params`` and back (no ``transformers``): every
   leaf and one prefill's logits bit for bit. Each temporary checkpoint
   is deleted as soon as it is checked.
10. HTTP: ``make_server`` at llama-test on the card, on an ephemeral
    port; ``/healthz`` and three ``/v1/completions`` (two greedy, one
    sampled, all through the server's CUDA graphs), with the launch count
    set to 0 before them; then the sampled request streamed (the sampled
    lane's draw and step programs) and again in full, equal for its seed,
    every program key captured once. Then the batch inference job
    (``serve.job.run_serving``) at llama-test in f32: 11 prompts in 3
    batches of 4, greedy completions identical to the HTTP solo lane's,
    sampled ones identical across two runs with one SERVE_SEED, one
    capture and two replays a run.
11. The fused AdamW kernels (``csrc/adamw.cu``) against their plain
    versions on llama-1b's and moe-1b's parameter leaves (bf16, and the
    f32 router): the norm within f32 summation error, params, mu and nu
    bit for bit from the same norm; each kernel's time, the plain
    version's, the bound, and the library's: ``torch._foreach_norm`` in
    f32 for the norm, ``torch._fused_adamw_`` (the same decoupled decay,
    the clip as its ``grad_scale``) for the update, one call a leaf dtype,
    with its difference to the kernel's result (run beside phases 2-4).
    Then the decode-attention kernels against their plain version at the
    decode paths' shapes, each on the route ``_route`` picks (bf16 at d
    64/128 the tensor-core kernel ``decode_attention_tc``,
    ``csrc/decode_attention_tc.cu``; f32 and d 16 the CUDA-core kernel of
    ``csrc/decode_attention.cu``): llama-1b's engine (8 rows over 2,048,
    every row at the full span, then the engine traffic's limits, dense
    and through a shuffled page table of 16-position pages, the paged
    output bitwise the dense one), the solo lane (4 rows at 1,088, one
    int prompt_slots), moe-1b's d 64, llama-7b's widths (32/32 heads, 8
    rows at the full 2,048), llama-70b's (64/8, 8 rows at the full 4,096,
    paged) and llama-test's d 16 in bf16 and f32: bf16 within one bf16
    ulp of max |o|, f32 within 2e-6 of it; the kernel's time, at the
    tensor-core shapes the CUDA-core kernel's on the same inputs, the
    plain version's, the bound (the admitted positions' K/V bytes, q, o
    and the table over the card's rate) and one
    ``scaled_dot_product_attention`` call as a yardstick, each a CUDA
    graph of back-to-back calls; and a launch's own cost timed the same
    way.
12. Compiled programs, CUDA graphs against the same bodies run eagerly
    (``util/graphs.py``), in turns: greedy serving (``GreedyLane``) at
    llama-1b and moe-1b grouped, 4 ragged rows at 1024, 64 tokens
    (tokens identical, each key captured once, prefill ms and decode
    ms/step, busy share, one replay of each program under
    ``set_sync_debug_mode("error")``; at llama-1b a third lane with
    ``cfg.use_kernel=False``, the plain f32 decode attention, in the same
    turns); ``make_train_step`` at llama-1b
    and moe-1b grouped, 4 × 2048, and at a 2-layer moe-1b in f32 (the
    CUDA-core kernels), 5 steps a turn (losses within the bf16 training
    bound, 1e-5 in f32; step wall, tokens/s, device memory peak, kernels
    and busy share, the out-of-place ``train_step``'s peak beside them).
    Every kernel's name must show in a profile of replays alone, and in
    a profile of one replay of each program (prefill, a decode segment,
    a train step) each hand-written kernel's launches seen on the card
    must equal the counts (each capture's launches times its replays):
    never more, and equal in one of at most three such windows, since the
    profiler loses a record now and then under graphs.
    Then the sampled lane (``serve/server.py`` ``SampledLane``) at llama-1b
    (64 tokens) and moe-1b grouped (16), 4 ragged rows at 1024,
    temperature 0.8, top_k 50, top_p 0.9, seed 7: the graphed generate
    program's tokens equal its body's run eagerly at the first call and at
    a replay, seed 8 draws others, top_k = 1 equals the greedy lane (or
    parts from it first where the greedy logits tie exactly at their
    maximum: top_k = 1 keeps every tied token); eager,
    sampled graphed and greedy graphed in turns (prefill ms, decode
    ms/step, exact launch counts), each key captured once, a replay's
    hand-written launches as captured, and in a replay-only profile the
    sampler's kernels by kind (sorts, softmax, cumsum, uniform draw, logs,
    argmax) beside ``flash_fwd_tc_kernel``, ``decode_attention_tc_kernel``
    (and ``gmm_tc_kernel``). At llama-1b the lane's token loop, greedy and
    sampled, one row of 1,000 tokens: the stream's tokens equal the
    generate program's, ms a token (one step replay and one int read back)
    beside the 1-row generate program's decode step. Then the eval step
    (``make_eval_step``) at llama-1b, 4 × 2048, graphed against eager in
    turns: losses within 1e-6 relative, ms each.
13. The continuous slot engine (``serve/server.py`` ``ContinuousEngine``)
    at full width and depth, bf16, 8 slots, segments of 8 steps: llama-1b
    with 16 requests and moe-1b grouped with 8 (prompt lengths over the
    16-512 buckets, budgets of 8-64, from a seed), submitted from threads
    so rows are admitted mid-decode and slots recycled; the graphed, the
    eager and the graphed paged engine (SERVE_KV_POOL_MB as large as the
    dense cache, pages of 16) in turns (identical tokens, each program
    captured once, exact launch counts: the flash forward once a layer a
    prefill, the grouped forward three times a layer a prefill and a
    decode step, decode attention once a layer a step), at llama-1b with
    a graphed engine on the plain f32 decode attention
    (``cfg.use_kernel=False``, diverging only at printed near-ties) and
    paged engines of 160 and 128 MiB (admissions stall; the pools' stalls
    and preemptions printed, every page free afterwards) in the same
    turns;
    each request against the solo greedy lane (equal, or diverging first
    at a near-tie of the solo run, printed with its top-2 logit gap);
    requests/s and tokens/s of the engine and of the same requests one at
    a time through the solo lane; ms a segment, mean slot occupancy, cache
    size and memory peak, busy share of one profile of engine traffic; the
    step beside its bounds; for the graphed dense and paged engines a
    segment replay under ``set_sync_debug_mode("error")`` and its
    hand-written launches as captured; ``flash_fwd_tc``,
    ``decode_attention`` (and at moe-1b ``gmm_tc``) in replay-only
    profiles of a prefill and a segment. Then the long-context turn
    (``phase_long_context``): llama-1b at span 4,096, 8 requests at once
    with prompts of 1,600-1,984 tokens and budgets of 32-64, dense and
    paged engines on the decode-attention kernel and on the plain lane in
    turns (dense and paged tokens identical on each lane, exact launch
    counts, ms a segment and tokens/s, a profile of a kernel-lane turn).
    Then HTTP at llama-test: with
    ``SERVE_CONTINUOUS_BATCHING=1`` and ``SERVER_BATCH=4`` four concurrent
    completions (against the solo server's, by the same near-tie rule), a
    streamed completion (its joined deltas equal the solo server's text)
    and a chat completion (equal to the completion of its transcript);
    then the round batcher (``SERVER_BATCH=4``) with the same four; with
    the engine idle, a segment and a prefill replay in a replay-only
    profile (the CUDA-core decode attention's and flash forward's).
14. The prefix cache (``phase_prefix_cache``, SERVE_PREFIX_CACHE_MB):
    (a) the flash forward at the warm prefill's shapes (llama-1b's 1,024
    suffix rows against 2,048 keys, and 1,008 against 1,024: a ragged q
    tile, the diagonal off the tile grid) on both routes and llama-test's
    f32 48 against 64, held to the plain version; at the first, both
    routes' times, the plain version's, the bound and a bottom-right
    causal SDPA call (a yardstick); (b) the solo lane with a prefix store
    at llama-1b (the long-context turn's parameters): 4 requests of
    1,600-1,984 tokens opening with one 1,024-token document, the first
    cold and stored, the rest warm at q = 1,024 (exactly 16 flash
    launches a warm prefill, at seq_q 1,024 against 2,048; no plain
    attention), tokens against a cache-free lane (equal, or a printed
    near-tie), time to first token warm against cold in turns, one profile
    of each; (c) the paged engine with its page store on the long-context
    turn's 2,048-page pool, its cap one entry short: exact launch counts,
    warm admissions referencing pinned pages, one entry evicted, pages
    conserved, tokens against a cache-free paged engine, then a second
    turn all warm; (d) HTTP at llama-test in f32: the cold, hit and
    partial prompts answer as a cache-free server, and ``/healthz``
    carries ``prefix_cache``.
15. The serving operations layer (``phase_operations``, after the graphed
    training): the llama-1b paged engine (``ops_engine_turns``: phase 12's
    requests, counted clean turns, tokens/s and ms a segment with the
    layer on, the analytic roofline's utilization of the segment), a
    turn with ``OPS_FAULTS`` armed (every request ends in tokens or an
    error, the pool's pages and the goodput ledger conserved), a clean
    turn with the same tokens after it, and a whole segment with the
    fault sites, ledger, profiler, tracer and flight recorder on under
    ``set_sync_debug_mode("error")`` but for its own readback. The engine
    carries its black box (``build_black_box``: the flight recorder, the
    incident correlator, the engine tripwires), and the phase holds it to
    one record a segment the engine ran, every record's page partition
    conserved, an engine-reset dump from the armed turn with its reason
    and error, the restart tripwire fired with an incident naming that
    dump, and the page-partition and ledger-conservation tripwires never
    fired. Then HTTP at llama-test: ``/metrics``, ``/debug/ledger``,
    ``/debug/profile``, ``/debug/trace/<id>``, ``/debug/flightrec`` (with
    segments) and ``/debug/alerts`` (the engine tripwires' rules) answer,
    ``/healthz`` carries the alert summary, a full queue sheds with 429,
    an expired deadline gives 504, ``POST /drain`` turns ``/healthz`` to
    draining, closes the server and leaves one drain dump.
16. Speculation (``phase_speculation``, after the operations layer):
    (a) the chunk route of decode attention (verify windows of c query
    positions a row, each with its own limit) against the plain version
    at c 2, 5, 9 and 16 on both routes, dense and paged, ragged (llama-1b's
    engine verify at the engine traffic's positions) and uniform, with
    NaN in every slot no column admits, paged bitwise dense; at c 9 the
    times of llama-1b's verify (dense, paged), llama-70b's widths (72
    columns, 8 × 4,096 paged) and llama-test f32 (the CUDA-core route),
    each beside the plain version's, the bound and one masked SDPA call
    over the repeat_kv'd cache; (b) the llama-1b slot engine with
    SERVE_DRAFT_K 8 verify rounds, n-gram lookup, a random llama-125m
    draft and the perfect draft (the engine's own greedy tokens as
    proposals), dense and paged, against the plain engine: tokens (up to
    near-ties), ms a round, tokens a round, tokens/s in turns, one
    capture a key, every round's decode attention on the chunk route;
    (c) the solo lookup lane at llama-1b over a 1,000-token prompt; (d)
    HTTP at llama-test f32 with lookup solo, lookup on the engine and a
    draft model, ids equal to the plain solo server's; (e) run_serving's
    lookup and draft modes equal to the plain greedy job's.
17. Int8 serving (``phase_int8``, last, in a process of its own:
    ``phase_int8_child``): the weight-only int8 matmul at llama-1b's five
    weight shapes (bf16: its tensor-core route ``w8_matmul_tc``, and the
    CUDA-core ``w8_matmul`` forced at 2048 x 5632) and llama-test's (f32:
    ``w8_matmul``), at 4, 8 and 72 rows, against its plain version, the
    72-row call bitwise the 8-row call, timed at 8 rows beside its bound,
    a ``torch.matmul`` of the shape and ``torch._weight_int8pack_mm``
    where the card's torch has it; decode attention over an int8 cache
    (dense and paged, one position a row and a verify window of 9,
    llama-1b and moe-1b's d 64 on the tensor-core route
    ``decode_attention_tc_q8``, the CUDA-core ``decode_attention_q8``
    forced at the paged traffic shape and on its own at llama-test f32)
    against its plain version, paged bitwise the dense, timed beside
    ``decode_attention_tc`` on the same cache in bf16; llama-1b on int8
    weights and the int8 cache: the weight, cache and page bytes against
    the reckoning, the solo lane beside the bf16 lane in turns, the int8
    dense and paged engines beside the bf16 paged engine (tokens
    identical dense to paged, each request against the int8 solo lane up
    to near-ties; the tensor-core int8 kernels alone, in replay-only
    profiles); moe-1b grouped on int8 weights; HTTP at llama-test f32
    with ``SERVE_QUANT=int8 SERVE_KV_QUANT=1`` (the CUDA-core int8
    kernels, in a replay-only profile) and a verify-round turn on an int8
    draft cache.
18. Sharded training (``phase_parallel``, last, in a process of its own:
    ``phase_parallel_child``; ``--parallel-phase OUT.json`` runs it
    alone): a 1-rank NCCL world captures the collectives of
    ``parallel/collectives.py`` (the shift included) into one CUDA graph
    and replays them; then four gloo ranks sharing cuda:0 run
    ``make_sharded_train_step`` (eager) for llama-1b at fsdp=2, tensor=2
    and data=2,tensor=2 and moe-1b grouped at expert=2 and
    expert=2,tensor=2 in bf16 (4 x 2048 global rows), and llama-1b
    (fsdp=2,tensor=2 and data=2,fsdp=2) and moe-1b (expert=2,tensor=2)
    in f32 (4 x 512), at depth 2, 3 steps; ``make_pipeline_train_step``
    for llama-1b at depth 4 with 2 microbatches at stage=2 and
    data=2,stage=2 in bf16 and stage=2,tensor=2 in f32; and
    ``make_sharded_lora_step`` for llama-1b at depth 2 (rank 8 on wq,
    wk, wv, wo) at fsdp=2,tensor=2 in bf16: each step's loss, the
    params' (adapters') change and the AdamW moments after the last step
    against ``make_train_step`` (``make_lora_step``) on rank 0 from the
    same seed and batches (``PAR_TOL``), the states every rank gathers
    equal (no replica drifted), the LoRA base bit for bit, each rank's
    launches of the five kernels and the AdamW pair equal to the count
    layers x steps (x microbatches / stages) predict (joined to the
    kernels line's ``launches_by_path``), and each rank's step seconds
    (gloo through host memory on one card: not a multi-card rate). Then
    ring attention (``ring_attention_sharded``) over a sequence ring of
    the four ranks at llama-1b's attention layout, sequence RING_SEQ,
    bf16, causal, forward and backward, against ``flash_attention`` on
    the whole sequence within ``RING_ULPS`` bf16 ulps, with no
    hand-written kernel launched, its seconds and memory peak a rank.
19. One JSON line of the kernels, then the result line
    ``{"ok": true, "device": {...}}``.

Under CUDA graphs the wrappers count the launches a capture records
(and does not run); the counts read here are the launches the card ran:
those taken out, each capture's launches times its replays added
(``util/graphs.py`` ``device_launches``). The train job (phases 7 and 9)
runs its step as one CUDA graph. Every count includes the AdamW
kernels' (one each an optimizer step).

Phase 2 includes the HTTP phase's own shapes; phase 10 also replays its
greedy requests on an f32 server and holds their token ids to a
ServingState whose prefill takes the plain lane. Each path's launch
counts include the routed wrappers' counts by route (``flash_fwd.tc``,
``flash_bwd_dq.tc``, ``flash_bwd_dkv.tc``, ``gmm.simt``, ``gmm_drhs.tc``,
..., ``decode_attention.tc``): phases 5-9 and 12-13 require every bf16
launch of the flash forward, dQ and dK/dV and of decode attention at d
64/128 and of the grouped forward and drhs to take the tensor-core route,
and every f32 or d 16 launch the CUDA-core route.
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import gc
import http.client
import importlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
BF16_TFLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_TFLOPS = 67e12        # H100 SXM f32 outside the tensor cores
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3

# |kernel − plain| <= atol + rtol·|plain|, elementwise. f32: both sides
# compute in f32 and differ by summation order and exp ulps. bf16: the
# plain version rounds the normalised P to bf16 before P·V; the CUDA-core
# kernel keeps P in f32, the tensor-core kernel rounds the unnormalised P
# (each in [0, 1]) to bf16 and divides by the f32 row sum after P·V, and
# scales the f32 scores instead of a pre-scaled Q; O is rounded to bf16 on
# every side, so they may land one bf16 ulp apart (2^-8 relative, 0.0156
# at |O| in [2, 4)).
O_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = 1e-3            # f32 scores from the same inputs on both sides
# flash_fwd_tc, held tighter besides: against the same attention in f32 on
# the same bf16 inputs. A bf16 rounding moves a value by at most 2^-8 of
# it (half an ulp at the bottom of a binade), so rounding each
# unnormalised P moves O by at most 2^-8 of the P-weighted mean of |V|
# (attention over |V|), and the final rounding by 2^-8 of |O|; the bound
# is their sum, and still catches one V tile read from the wrong rows
# (about 16 / n of |V| for a row of n keys).
TC_REL = 2.0 ** -8
TC_ATOL = 1e-6
# llama-1b bf16 logits, kernel lane vs plain lane: the attention outputs
# differ by the bf16 P roundings above and the difference rides 16 layers
# of bf16 residual stream. The logits leave a bf16 matmul, so they move in
# bf16 ulps: 2^-5 = 0.031 for a largest logit in [4, 8), where this seed
# lands (measured: 0.078 of 4.625, 1.7 %, 2.5 ulps). 3 % of the largest
# logit allows about 4 ulps there; the greedy argmax must agree on every row.
LOGIT_REL_TOL = 3e-2

# dq, dk, dv, kernel vs plain (both from the same O and LSE, both f32
# inside): |kernel − plain| <= atol + rtol·|plain|. f32: summation order
# only. bf16: the outputs are rounded to bf16 at the end on both sides from
# f32 values that differ by summation order, so they may land one bf16 ulp
# apart (at most 2^-7 relative).
GRAD_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
# dq, dk, dv against the autograd gradient of attention_reference. f32:
# summation order. bf16: that gradient also rounds P to bf16 before P·V (so
# dV sums bf16 P) and rounds dP to bf16 on its way back through the cast,
# where the kernels keep both in f32: a few bf16 ulps of the outputs.
AUTOGRAD_TOL = {"bfloat16": (3e-2, 3e-2), "float32": (1e-4, 1e-4)}
# llama-1b (2 layers, 1 × 2048, bf16): every gradient leaf and the loss,
# kernel lane vs plain lane, as ‖g_kernel − g_plain‖ / ‖g_plain‖. The two
# lanes' attention outputs differ by the plain lane's bf16 rounding of P
# (PR 1: logits within 1.7 %), and its gradient by the bf16 rounding of P
# and dP above, carried through bf16 weight products into every leaf.
TRAIN_GRAD_REL_TOL = 3e-2
TRAIN_LOSS_REL_TOL = 1e-3

SERVE_SHAPE = (4, 16, 1024, 128)   # llama-1b prefill: 4 rows × width 1024
TRAIN_SHAPE = (4, 16, 2048, 128)  # llama-1b training: 4 rows × 2048
MOE_SHAPE = (4, 16, 2048, 64)     # moe-1b training: 16 heads of 64
MOE_F32_SHAPE = (1, 16, 2048, 64)  # moe-1b's f32 gradient check, 1 × 2048
TIMED_SHAPES = (TRAIN_SHAPE, SERVE_SHAPE, MOE_SHAPE)
TRAIN_ENV = {"JOB_DEVICE": "cuda", "JOB_MODEL": "llama-1b", "JOB_BATCH": "4",
             "JOB_SEQ": "2048", "JOB_STEPS": "10"}
MOE_ENV = {**TRAIN_ENV, "JOB_MODEL": "moe-1b"}
# the llama-1b job's held-out loss: every 5 of its 10 steps, 2 batches
TRAIN_EVAL_ENV = {"JOB_EVAL_EVERY": "5", "JOB_EVAL_BATCHES": "2"}


# grouped kernels, kernel vs plain: |kernel − plain| <= tol·(1 + |plain|).
# f32: the same f32 products summed in another order, an error that grows
# like √K (K the contraction: K, N for dlhs, M for drhs). bf16: the same
# (the tensor-core route sums the bf16 products in f32 too), then both
# sides round to bf16 once, so they may land one bf16 ulp apart (2^-8
# relative).
def gmm_tol(dtype_name: str, depth: int) -> float:
    return 1e-4 * math.sqrt(depth / 128) if dtype_name == "float32" else 1e-2


# gmm_forward_tc, held tighter besides: against the same product in f32 on
# the same bf16 inputs, |kernel − f32| <= TC_REL·|f32| + 1e-4·K/128. Past
# its f32 sum the kernel rounds once to bf16 (at most 2^-8 of the value,
# reached just above a power of two). Its sum is
# the tensor cores' f32 accumulation, which drifts further from a rounded
# f32 sum as K grows than gmm_tol's √K allows (on an H100, an error 1.38
# times the bound built on it at K = 8192), so the absolute term grows
# like K, the worst case of a summation. A k-slice read from a stage the
# producer already refilled moves an output by about √64 times a product:
# several units, dozens of bf16 ulps.
def gmm_tc_bound(ref32, depth: int):
    return TC_REL * ref32.abs() + 1e-4 * depth / 128


# moe-1b in f32, kernel lane vs plain lane, with every routing decision
# equal: the grouped and flash kernels sum in another order than cuBLAS and
# the plain attention, a relative difference near 1e-6 in each layer's
# output (measured: logits within 8.6e-06 of a largest logit of 4.24 after
# 12 layers), so 1e-4 of the largest logit, and 1e-4 of each gradient
# leaf's norm, leave room for the depth and still catch a wrong row.
MOE_LOGIT_REL_TOL = 1e-4
MOE_GRAD_REL_TOL = 1e-4
MOE_LOSS_REL_TOL = 1e-5
# moe-1b's expert products: (K, N) of w_gate / w_up and of w_down
MOE_D, MOE_FF, MOE_E = 1024, 3584, 8


class SmokeError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def say(*args) -> None:
    print(*args, flush=True)


_CLOCK = {"start": time.perf_counter(), "phase": None}


def begin(phase: str) -> None:
    """Name the phase on stderr (a crash's last lines then say where it
    was) with the seconds since the script started and those the phase
    before it took, and collect the garbage of the phases before it, so
    that their servers' and lanes' graphs are destroyed here, with nothing
    capturing, profiled or running on another thread."""
    now = time.perf_counter()
    since = now - _CLOCK["start"]
    last = (f"; {_CLOCK['phase'][0]} {now - _CLOCK['phase'][1]:.1f} s"
            if _CLOCK["phase"] else "")
    _CLOCK["phase"] = (phase, now)
    print(f"chip_smoke: {phase} (at {since:.1f} s{last})", file=sys.stderr,
          flush=True)
    gc.collect()


@contextlib.contextmanager
def no_gc():
    """No garbage collection inside: a collection that destroys an
    earlier phase's CUDA graphs mid-capture invalidates the capture, and
    inside a profile it adds the destruction to the window."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, after one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(b, h, sq, sk, d, causal, itemsize):
    """(operations, bytes) this call needs: the unmasked score pairs × 2
    products × 2 ops × d, and q/k/v read once, O and LSE written once."""
    ops = 4 * b * h * causal_pairs(sq, sk, causal) * d
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize + b * h * sq * 4
    return ops, nbytes


def causal_pairs(sq, sk, causal):
    """Unmasked (q, k) pairs of one (batch, head)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, r + off + 1) for r in range(sq))


def attention_bwd_work(kernel, b, h, sq, sk, d, causal, itemsize):
    """(operations, bytes) of one backward kernel: the unmasked pairs × its
    products × 2 ops × d (dQ: S, dP and dS·K; dK/dV: S, dP, Pᵀ·dO and
    dSᵀ·Q), and q, k, v, dO read once, lse and delta (f32) read once, its
    outputs written once."""
    products, outputs = {"dq": (3, b * h * sq * d),
                         "dkv": (4, 2 * b * h * sk * d)}[kernel]
    ops = 2 * products * b * h * causal_pairs(sq, sk, causal) * d
    nbytes = ((2 * b * h * sq * d + 2 * b * h * sk * d + outputs) * itemsize
              + 2 * b * h * sq * 4)
    return ops, nbytes


def bound(ops, nbytes, dtype_name):
    peak = BF16_TFLOPS if dtype_name == "bfloat16" else F32_TFLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_cases(torch):
    """(b, h, seq_q, seq_k, d, dtype, causal) of both kernel phases."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        (1, 16, 2048, 2048, 128, bf16, True),
        (4, 16, 512, 512, 128, bf16, True),
        (1, 16, 2048, 2048, 128, f32, True),
        (4, 16, 512, 512, 128, f32, True),
        (2, 4, 64, 64, 16, bf16, True),
        (2, 4, 64, 64, 16, f32, True),
        (1, 16, 256, 512, 128, bf16, True),
        (1, 16, 256, 512, 128, f32, True),
        (2, 16, 512, 512, 128, bf16, False),
        (2, 8, 256, 384, 64, f32, False),
        (1, 4, 200, 328, 32, f32, True),
        (1, 4, 200, 328, 32, bf16, True),
        # the HTTP phase's shapes (llama-test, one row bucketed to 16 or 32
        # tokens: a q tile mostly of padding), and one with an offset
        (1, 4, 16, 16, 16, bf16, True),
        (1, 4, 32, 32, 16, bf16, True),
        (1, 4, 16, 16, 16, f32, True),
        (1, 4, 32, 32, 16, f32, True),
        (1, 4, 16, 48, 16, bf16, True),
        # the tensor-core route's edges: seq off its 128-row tiles,
        # seq_q < seq_k, non-causal, at d 64 and 128
        (1, 16, 200, 200, 128, bf16, True),
        (1, 8, 300, 700, 64, bf16, True),
        (2, 8, 256, 384, 64, bf16, False),
        (1, 8, 130, 250, 128, bf16, False),
        *((*s[:3], s[2], s[3], bf16, True) for s in TIMED_SHAPES),
        # the CUDA-core dK/dV kernel's main path: moe-1b in f32
        (*MOE_F32_SHAPE[:3], MOE_F32_SHAPE[2], MOE_F32_SHAPE[3], f32, True),
    ]


def random_qkv(torch, g, b, h, sq, sk, d, dtype):
    dev = torch.device("cuda")
    return tuple(torch.randn((b, h, n, d), generator=g, device=dev).to(dtype)
                 for n in (sq, sk, sk))


def sdpa_causal(torch, q, k, v, scale):
    """One ``scaled_dot_product_attention`` call with the kernels' causal
    mask, aligned bottom-right when seq_q < seq_k (SDPA's ``is_causal``
    aligns it top-left) → a function of no arguments."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, sk = q.shape[2], k.shape[2]
    if sq == sk:
        return lambda: sdpa(q, k, v, is_causal=True, scale=scale)
    try:
        from torch.nn.attention.bias import causal_lower_right

        mask = causal_lower_right(sq, sk)
    except ImportError:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)


def time_fwd(torch, fa, q, k, v, scale) -> dict:
    """Both forward routes' times at q's and k's shapes (bf16, causal),
    the plain version's, the bound and one SDPA call's (a yardstick only)
    → by route."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    ms = {"tc": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale), 20),
          "simt": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale,
                                                    route="simt"), 5)}
    plain_ms = cuda_ms(
        lambda: fa.attention_reference(q, k, v, causal=True, sm_scale=scale), 5)
    library_ms = cuda_ms(sdpa_causal(torch, q, k, v, scale), 20)
    ops, nbytes = attention_work(b, h, sq, sk, d, True, q.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    say(f"kernel flash_fwd bf16 {tuple(q.shape)} against {sk} keys causal: "
        f"tensor cores "
        f"{ms['tc']:.4f} ms, CUDA cores {ms['simt']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa (yardstick) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({ops:.4e} ops, {nbytes} bytes); "
        f"tensor cores {ms['tc'] / library_ms:.2f}x sdpa, "
        f"{ms['tc'] / bound_ms:.2f}x bound")
    return {route: {"ms": t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms}
            for route, t in ms.items()}


def check_fwd(torch, fa, q, k, v, causal, scale, route) -> float:
    """One forward launch on ``route`` against the plain version → O's
    max abs error; raises when O or LSE is out of tolerance."""
    b, h, sq, d = q.shape
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, route=route)
    torch.cuda.synchronize()
    ref = fa.attention_reference(q, k, v, causal=causal, sm_scale=scale)
    lse_ref = fa.logsumexp_reference(q, k, causal, scale)
    name = str(q.dtype).split(".")[-1]
    atol, rtol = O_TOL[name]
    err, within = _max_err_within(o, ref, atol, rtol)
    lse_err = (lse - lse_ref).abs().max().item()
    ok = within and math.isfinite(err) and lse_err <= LSE_TOL
    tight = ""
    if route == "tc":
        qf, kf, vf = q.float(), k.float(), v.float()
        ref32 = fa.attention_reference(qf, kf, vf, causal=causal,
                                       sm_scale=scale)
        mean_abs_v = fa.attention_reference(qf, kf, vf.abs(), causal=causal,
                                            sm_scale=scale)
        diff = (o.float() - ref32).abs()
        slack = diff / (TC_REL * (ref32.abs() + mean_abs_v) + TC_ATOL)
        ok &= bool((slack <= 1).all())
        tight = (f"; vs f32 {diff.max().item():.3e}, at most "
                 f"{slack.max().item():.3f} of 2^-8·(|O| + P·|V|)")
        del qf, kf, vf, ref32, mean_abs_v, diff, slack
    say(f"kernel {fa.FWD_ENTRY[route]} {name} b={b} h={h} sq={sq} "
        f"sk={k.shape[2]} d={d} causal={causal}: max_abs_err O {err:.3e} "
        f"(tol {atol:.0e} + {rtol:.0e}*|O|) LSE {lse_err:.3e} (tol "
        f"{LSE_TOL:.0e}){tight} {'ok' if ok else 'FAIL'}")
    check(ok, f"{fa.FWD_ENTRY[route]} disagrees with attention_reference at "
              f"{(b, h, sq, k.shape[2], d, name, causal)}")
    return err


def phase_kernel(torch, fa) -> list:
    """Forward kernel vs plain over the listed cases, on the route each
    case takes and, for bf16 at d 64/128, on the CUDA-core route too;
    both routes timed at TIMED_SHAPES."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    timed, errs = {}, {}
    for b, h, sq, sk, d, dtype, causal in attention_cases(torch):
        q, k, v = random_qkv(torch, g, b, h, sq, sk, d, dtype)
        scale = 1.0 / math.sqrt(d)
        routes = {fa._route(dtype, d), "simt"}
        for route in sorted(routes):
            errs[(b, h, sq, sk, d, dtype, route)] = check_fwd(
                torch, fa, q, k, v, causal, scale, route)
        if (b, h, sq, d) in TIMED_SHAPES and sk == sq \
                and dtype == torch.bfloat16:
            timed[(b, h, sq, d)] = time_fwd(torch, fa, q, k, v, scale)
        del q, k, v

    def entry(name, route):
        b, h, s, d = TRAIN_SHAPE
        return {
            "name": name,
            "route": "cuda",
            "source": "tpu_kubernetes_torch/csrc/flash_fwd.cu",
            "replaces": "tpu_kubernetes/ops/flash_attention.py:96",
            "launches": None,        # filled from its main path's run
            "max_abs_err": errs[(b, h, s, s, d, torch.bfloat16, route)],
            **timed[TRAIN_SHAPE][route],
            "at_serve_shape": timed[SERVE_SHAPE][route],
            "at_moe_shape": timed[MOE_SHAPE][route],
        }

    # the training path's shape first, the serving path's and moe-1b's
    # beside it; the CUDA-core kernel's numbers are its bf16 ones
    return [entry("flash_fwd_tc", "tc"), entry("flash_fwd", "simt")]


def _max_err_within(got, ref, atol, rtol) -> tuple[float, bool]:
    diff = (got.float() - ref.float()).abs()
    return (diff.max().item(),
            bool((diff <= atol + rtol * ref.float().abs()).all()))


def dkv_tc_share(torch, fa, q, k, v, do, lse, delta, causal, scale,
                 got) -> float:
    """flash_bwd_dkv_tc's (dk, dv) against the f32 dK, dV of the same bf16
    inputs, lse and delta → the largest share of its bound used. The kernel
    rounds each Pᵀ (dSᵀ) to bf16 before dV += Pᵀ·dO (dK += dSᵀ·Q), which
    moves an output by at most 2^-8·Σ|Pᵀ|·|dO| (2^-8·Σ|dSᵀ|·|Q|), and
    rounds the output once, 2^-8 of it: the bound is their sum."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p, ds = fa._probs_and_ds(qf, kf, vf, dof, lse, delta, causal, scale)
    share = 0.0
    for g, w, x in ((got[0], ds, qf), (got[1], p, dof)):
        ref = torch.einsum("bhqk,bhqd->bhkd", w, x)
        spread = torch.einsum("bhqk,bhqd->bhkd", w.abs(), x.abs())
        bound = TC_REL * (ref.abs() + spread) + TC_ATOL
        share = max(share, ((g.float() - ref).abs() / bound).max().item())
        del ref, spread, bound
    return share


def dq_tc_share(torch, fa, q, k, v, do, lse, delta, causal, scale,
                got) -> tuple[float, float, str]:
    """flash_bwd_dq_tc's dq against the f32 dQ of the same bf16 inputs, lse
    and delta → (the largest share of its bound used, the largest share of
    the rounding term and TC_ATOL alone, the worst element's parts). The
    kernel rounds each dS to bf16 before dQ += dS·K, which moves an output
    by at most 2^-8·Σ|dS|·|K|, and rounds the output once, 2^-8 of it, as
    dK/dV's. Besides, both sides sum dP = dO·Vᵀ in f32 in another order,
    each within γ_d·Σ_d|dO|·|V| (γ_d = d·2^-24), and dP − delta cancels
    where P sits on one key (a row's first keys under causal masking: row
    0's O is V[0] itself): there dS is f32 noise of that size, which no
    share of |dS| covers, so the bound adds 2·γ_d·sm_scale·Σ P·Σ_d|dO|·|V|
    ·|K|."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p, ds = fa._probs_and_ds(qf, kf, vf, dof, lse, delta, causal, scale)
    ref = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    rounding = TC_REL * (ref.abs() + torch.einsum("bhqk,bhkd->bhqd",
                                                  ds.abs(), kf.abs()))
    del ds
    p *= torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
    noise = (2 * q.shape[-1] * 2.0 ** -24 * scale
             * torch.einsum("bhqk,bhkd->bhqd", p, kf.abs()))
    del p
    err = (got.float() - ref).abs()
    share = err / (rounding + noise + TC_ATOL)
    at = int(share.argmax())
    worst = (f"err {err.flatten()[at].item():.3e}, |f32| "
             f"{ref.abs().flatten()[at].item():.3e}, rounding term "
             f"{rounding.flatten()[at].item():.3e}, dP noise term "
             f"{noise.flatten()[at].item():.3e} at q row "
             f"{at // q.shape[-1] % q.shape[2]}")
    return (share.max().item(),
            (err / (rounding + TC_ATOL)).max().item(), worst)


def sdpa_bwd_ms(torch, q, k, v, do, scale) -> float:
    """The yardstick of both backward kernels: the autograd backward of
    one SDPA call (dq, dk and dv; its forward outside the timed window)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=scale)
    return cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)


def time_bwd(torch, fa, kernel, q, k, v, do, lse, delta, scale,
             library_ms) -> dict:
    """Both routes' times of the dQ (``kernel="dq"``) or dK/dV
    (``"dkv"``) kernel at q's shape (bf16, causal), the plain version's
    and the bound, beside ``library_ms`` → by route."""
    wrapper, plain = {
        "dq": (fa.flash_bwd_dq_cuda, fa.attention_bwd_dq_reference),
        "dkv": (fa.flash_bwd_dkv_cuda, fa.attention_bwd_dkv_reference),
    }[kernel]
    b, h, sq, d = q.shape
    ms = {"tc": cuda_ms(lambda: wrapper(q, k, v, do, lse, delta, True,
                                        scale), 20),
          "simt": cuda_ms(lambda: wrapper(q, k, v, do, lse, delta, True,
                                          scale, route="simt"), 3)}
    plain_ms = cuda_ms(lambda: plain(q, k, v, do, lse, delta, True, scale), 3)
    ops, nbytes = attention_bwd_work(kernel, b, h, sq, sq, d, True,
                                     q.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    say(f"kernel flash_bwd_{kernel} bf16 {tuple(q.shape)} causal: tensor "
        f"cores {ms['tc']:.4f} ms, CUDA cores {ms['simt']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward (yardstick, dq+dk+dv) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops:.4e} ops, {nbytes} bytes); tensor cores "
        f"{ms['tc'] / library_ms:.2f}x sdpa backward, "
        f"{ms['tc'] / bound_ms:.2f}x bound")
    return {route: {"ms": t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms}
            for route, t in ms.items()}


def phase_backward(torch, fa) -> list:
    """dq, dk, dv from the two backward kernels against the plain version
    (same O, LSE and dO) and against autograd through attention_reference,
    over the listed cases, both kernels on the route each case takes and,
    for bf16 at d 64/128, on the CUDA-core route too (the tensor-core
    routes held besides to the f32 result within their roundings, the
    CUDA-core dQ to the plain version bit for bit); both routes of both
    kernels timed at TRAIN_SHAPE and MOE_SHAPE."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    errs, timed, share, dq_share, dq_rounding = {}, {}, 0.0, 0.0, 0.0
    for b, h, sq, sk, d, dtype, causal in attention_cases(torch):
        q, k, v = random_qkv(torch, g, b, h, sq, sk, d, dtype)
        do = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        got = fa.flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
        delta = (do.float() * o.float()).sum(-1)
        route = fa._route(dtype, d)
        if route == "tc":
            simt_dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                           scale, route="simt")
            simt = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                         scale, route="simt")
        torch.cuda.synchronize()
        plain = fa.attention_bwd_reference(q, k, v, o, lse, do, causal, scale)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(
            fa.attention_reference(*leaves, causal=causal, sm_scale=scale),
            leaves, do)
        name = str(dtype).split(".")[-1]
        line, ok = [], True
        for gname, gk, gp, ga in zip(("dq", "dk", "dv"), got, plain, auto):
            e_p, in_p = _max_err_within(gk, gp, *GRAD_TOL[name])
            e_a, in_a = _max_err_within(gk, ga, *AUTOGRAD_TOL[name])
            e_pa, in_pa = _max_err_within(gp, ga, *AUTOGRAD_TOL[name])
            ok &= in_p and in_a and in_pa and math.isfinite(e_p)
            line.append(f"{gname} {e_p:.3e} (autograd: kernel {e_a:.3e}, "
                        f"plain {e_pa:.3e})")
            key = ("dq" if gname == "dq" else "dkv", route)
            errs[(key, b, h, sq, sk, d, dtype)] = max(
                errs.get((key, b, h, sq, sk, d, dtype), 0.0), e_p)
        if route == "tc":
            # the CUDA-core kernels on the same bf16 inputs, and the
            # tensor-core kernels against the f32 result of those inputs
            e_q = (simt_dq.float() - plain[0].float()).abs().max().item()
            same = bool(torch.equal(simt_dq, plain[0]))
            ok &= same
            errs[(("dq", "simt"), b, h, sq, sk, d, dtype)] = e_q
            used_q, rounding_q, worst = dq_tc_share(
                torch, fa, q, k, v, do, lse, delta, causal, scale, got[0])
            ok &= used_q <= 1
            dq_share = max(dq_share, used_q)
            dq_rounding = max(dq_rounding, rounding_q)
            line.append(f"dq on CUDA cores {e_q:.3e} "
                        f"({'bit-equal' if same else 'NOT bit-equal'}); "
                        f"tensor cores vs f32 at most {used_q:.3f} of "
                        f"2^-8·(|f32| + Σ|dS|·|K|) + 2γ_d·s·ΣP·|dO|·|V|·|K| "
                        f"+ 1e-6 ({rounding_q:.3f} of the first and last "
                        f"terms alone; worst: {worst})")
            del simt_dq
            e_s = 0.0
            for gk, gp in zip(simt, plain[1:]):
                e, within = _max_err_within(gk, gp, *GRAD_TOL[name])
                ok &= within and math.isfinite(e)
                e_s = max(e_s, e)
            errs[(("dkv", "simt"), b, h, sq, sk, d, dtype)] = e_s
            used = dkv_tc_share(torch, fa, q, k, v, do, lse, delta, causal,
                                scale, got[1:])
            del simt
            ok &= used <= 1
            share = max(share, used)
            line.append(f"dk/dv on CUDA cores {e_s:.3e}; tensor cores vs "
                        f"f32 at most {used:.3f} of 2^-8·(|f32| + Σ|Pᵀ|·|dO| "
                        f"or Σ|dSᵀ|·|Q|)")
        say(f"kernel flash_bwd {name} b={b} h={h} sq={sq} sk={sk} d={d} "
            f"causal={causal} on {fa.DQ_ENTRY[route]} and "
            f"{fa.DKV_ENTRY[route]}: max_abs_err vs "
            f"plain " + ", ".join(line) + f" (tol {GRAD_TOL[name]}, autograd "
            f"{AUTOGRAD_TOL[name]}) " + ("ok" if ok else "FAIL"))
        check(ok, f"flash_bwd disagrees with the plain backward at "
                  f"{(b, h, sq, sk, d, name, causal)}")
        del got, plain, leaves, auto
        if (b, h, sq, d) in (TRAIN_SHAPE, MOE_SHAPE) and sk == sq \
                and dtype == torch.bfloat16:
            library_ms = sdpa_bwd_ms(torch, q, k, v, do, scale)
            for kernel in ("dq", "dkv"):
                timed[(kernel, b, h, sq, d)] = time_bwd(
                    torch, fa, kernel, q, k, v, do, lse, delta, scale,
                    library_ms)
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    say(f"flash_bwd_dkv_tc: at most {share:.3f} of its bound over the bf16 "
        f"cases at d 64/128")
    say(f"flash_bwd_dq_tc: at most {dq_share:.3f} of its bound over the bf16 "
        f"cases at d 64/128 ({dq_rounding:.3f} of its rounding and 1e-6 "
        f"terms alone)")

    b, h, s, d = TRAIN_SHAPE
    bf16 = torch.bfloat16
    common = {"route": "cuda", "source": "tpu_kubernetes_torch/csrc/flash_bwd.cu",
              "launches": None}       # filled from its main path's run

    def entry(kernel, name, route, err_at, replaces):
        return {"name": name, **common, "replaces": replaces,
                "max_abs_err": errs[((kernel, route), *err_at)],
                **timed[(kernel, *TRAIN_SHAPE)][route],
                "at_moe_shape": timed[(kernel, *MOE_SHAPE)][route]}

    # max_abs_err at each route's main path's shape: the tensor-core kernels
    # at llama-1b's training shape, the CUDA-core ones at moe-1b's in f32;
    # the CUDA-core kernels' times are their bf16 ones
    train_at = (b, h, s, s, d, bf16)
    f32_at = (*MOE_F32_SHAPE[:3], MOE_F32_SHAPE[2], MOE_F32_SHAPE[3],
              torch.float32)
    dq_site = "tpu_kubernetes/ops/flash_attention.py:185"
    dkv_site = "tpu_kubernetes/ops/flash_attention.py:232"
    return [
        {**entry("dq", "flash_bwd_dq_tc", "tc", train_at, dq_site),
         "bound_share": dq_share, "rounding_term_share": dq_rounding},
        entry("dq", "flash_bwd_dq", "simt", f32_at, dq_site),
        {**entry("dkv", "flash_bwd_dkv_tc", "tc", train_at, dkv_site),
         "bound_share": share},
        entry("dkv", "flash_bwd_dkv", "simt", f32_at, dkv_site),
    ]


def group_sizes(torch, m: int, e: int, seed: int):
    """A router's split of m rows over e experts, mildly unbalanced
    (weights softmax(0.3·z)), from a seeded generator; int32 on the card."""
    g = torch.Generator().manual_seed(seed)
    w = torch.softmax(0.3 * torch.randn(e, generator=g), 0)
    sizes = (w * m).floor().to(torch.int64)
    sizes[-1] += m - int(sizes.sum())
    return sizes.to(torch.int32).cuda()


def gmm_cases(torch):
    """(m, k, n, sizes, dtype) of the grouped kernels' comparison; the
    moe-1b training shapes last."""
    bf16, f32 = torch.bfloat16, torch.float32
    patterns = [[64, 64, 64, 64], [0, 100, 0, 156], [256, 0, 0, 0],
                [1, 2, 3, 250], [37, 99, 13, 107]]
    decode = [1, 2, 0, 1, 1, 1, 1, 121]   # 8 rows routed, 120 pad rows
    cases = []
    for dtype in (bf16, f32):
        cases += [(256, 128, 256, p, dtype) for p in patterns]
        cases += [(128, 512, 256, [50, 14, 0, 64], dtype),
                  (256, 128, 128, [40, 0, 77, 100, 39], dtype),
                  (200, 128, 128, [30, 10], dtype),       # rows past the sum
                  # M off the 128-row tiles, rows past the sum; an empty
                  # last group; 8 groups over more slices than stages
                  (300, 256, 256, [100, 0, 150, 20], dtype),
                  (200, 128, 128, [60, 70, 0], dtype),
                  (640, 384, 256, [90, 0, 170, 33, 1, 200, 100, 46], dtype),
                  (128, MOE_D, MOE_FF, decode, dtype),
                  (128, MOE_FF, MOE_D, decode, dtype)]
    # each CTA of the tensor-core forward laps its 5-stage ring about 14
    # times (296 items of 32 k-slices over 132 SMs)
    ring = [700, 300, 0, 548, 1000, 12, 900, 636]
    cases += [(4096, 2048, 1024, ring, bf16)]
    # moe-1b's prefill (4 × 1024 × top-2 rows: the f32 serving path's
    # shapes, and the bf16 one's) and its training shapes
    prefill = [int(x) for x in group_sizes(torch, 8192, MOE_E, 1).tolist()]
    train = [int(x) for x in group_sizes(torch, 16384, MOE_E, 0).tolist()]
    for dtype in (bf16, f32):
        cases += [(8192, MOE_D, MOE_FF, prefill, dtype),
                  (8192, MOE_FF, MOE_D, prefill, dtype)]
    # moe-1b's 2-layer f32 gradient check (1 × 2048 × top-2 rows, already
    # a whole number of 128-row blocks): the CUDA-core kernels' shapes on
    # their training path
    grad = [int(x) for x in group_sizes(torch, 4096, MOE_E, 2).tolist()]
    cases += [(4096, MOE_D, MOE_FF, grad, f32),
              (4096, MOE_FF, MOE_D, grad, f32)]
    cases += [(16384, MOE_D, MOE_FF, train, bf16),
              (16384, MOE_FF, MOE_D, train, bf16)]
    return cases


def gmm_work(m, k, n, sizes, itemsize, drhs=False):
    """(operations, bytes) of one grouped product: 2·rows·K·N for the rows
    that belong to a group, lhs read once, the weights of the groups that
    own rows read once (drhs: written once), the output written once."""
    rows = min(sum(sizes), m)
    used = sum(1 for x in sizes if x > 0)
    ops = 2 * rows * k * n
    nbytes = (m * k + m * n + used * k * n) * itemsize
    if drhs:    # lhs and dout read, every group's (k, n) written
        nbytes = (m * k + m * n + len(sizes) * k * n) * itemsize
    return ops, nbytes


def gmm_inputs(torch, g, m, k, n, sizes, dtype):
    dev = torch.device("cuda")
    lhs = torch.randn((m, k), generator=g, device=dev).to(dtype)
    rhs = torch.randn((len(sizes), k, n), generator=g, device=dev).to(dtype)
    dout = torch.randn((m, n), generator=g, device=dev).to(dtype)
    return lhs, rhs, dout, torch.tensor(sizes, dtype=torch.int32, device=dev)


def time_gmm(torch, gm, label, lhs, rhs, dout, gs) -> dict:
    """Both forward routes' times at lhs's shape (bf16) and their dlhs
    forms', the plain version's, the bound, and one torch._grouped_mm call
    (a yardstick only; offsets are the running sum of the group sizes)
    → by route."""
    m, k = lhs.shape
    n = rhs.shape[2]
    sizes = [int(x) for x in gs.tolist()]
    offs = torch.cumsum(gs, 0).to(torch.int32)
    ms, dlhs_ms = {}, {}
    for route, iters in (("tc", 20), ("simt", 5)):
        ms[route] = cuda_ms(lambda: gm.gmm_cuda(lhs, rhs, gs, route=route),
                            iters)
        dlhs_ms[route] = cuda_ms(lambda: gm.gmm_cuda(
            dout, rhs, gs, trans_rhs=True, route=route), iters)
    plain_ms = cuda_ms(lambda: gm.grouped_matmul_reference(lhs, rhs, gs), 3)
    library_ms = cuda_ms(lambda: torch._grouped_mm(lhs, rhs, offs=offs), 20)
    ops, nbytes = gmm_work(m, k, n, sizes, lhs.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    say(f"kernel gmm bf16 {label} M={m} K={k} N={n} sizes={sizes}: tensor "
        f"cores {ms['tc']:.4f} ms (dlhs form {dlhs_ms['tc']:.4f} ms), CUDA "
        f"cores {ms['simt']:.4f} ms (dlhs {dlhs_ms['simt']:.4f} ms), plain "
        f"{plain_ms:.4f} ms, _grouped_mm (yardstick) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.4e} ops, {nbytes} "
        f"bytes); tensor cores {ms['tc'] / library_ms:.2f}x _grouped_mm "
        f"(dlhs {dlhs_ms['tc'] / library_ms:.2f}x), "
        f"{ms['tc'] / bound_ms:.2f}x bound")
    return {route: {"ms": ms[route], "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "dlhs_ms": dlhs_ms[route]}
            for route in ms}


def time_drhs(torch, gm, label, lhs, dout, gs) -> dict:
    """Both weight-gradient routes' times at lhs's shape (bf16), the plain
    version's, the bound and one torch._grouped_mm call (a yardstick only)
    → by route."""
    m, k = lhs.shape
    n = dout.shape[1]
    e = gs.shape[0]
    sizes = [int(x) for x in gs.tolist()]
    offs = torch.cumsum(gs, 0).to(torch.int32)
    ms = {"tc": cuda_ms(lambda: gm.gmm_drhs_cuda(lhs, dout, gs), 20),
          "simt": cuda_ms(lambda: gm.gmm_drhs_cuda(lhs, dout, gs,
                                                   route="simt"), 5)}
    plain_ms = cuda_ms(lambda: gm.gmm_drhs_reference(lhs, dout, gs, e,
                                                     lhs.dtype), 3)
    # 2-D x 2-D with offsets along the contraction (M): lhsᵀ as a view
    library_ms = cuda_ms(lambda: torch._grouped_mm(lhs.t(), dout, offs=offs),
                         20)
    ops, nbytes = gmm_work(m, k, n, sizes, lhs.element_size(), drhs=True)
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    say(f"kernel gmm_drhs bf16 {label} M={m} K={k} N={n}: tensor cores "
        f"{ms['tc']:.4f} ms, CUDA cores {ms['simt']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, _grouped_mm (yardstick) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.4e} ops, {nbytes} "
        f"bytes); tensor cores {ms['tc'] / library_ms:.2f}x _grouped_mm, "
        f"{ms['tc'] / bound_ms:.2f}x bound")
    return {route: {"ms": t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms}
            for route, t in ms.items()}


# gmm_drhs_tc, held tighter besides: against the same weight gradient in
# f32 on the same bf16 inputs, group by group, within gmm_tc_bound with the
# group's rows as the depth; an empty group is exactly zero.
def drhs_tc_share(torch, gm, lhs, dout, gs, got) -> float:
    sizes = [int(x) for x in gs.tolist()]
    ref32 = gm.gmm_drhs_reference(lhs.float(), dout.float(), gs, len(sizes),
                                  torch.float32)
    share = 0.0
    for e, rows in enumerate(sizes):
        if rows > 0:
            share = max(share, ((got[e].float() - ref32[e]).abs()
                                / gmm_tc_bound(ref32[e], rows)).max().item())
    return share


def drhs_tc_sweep(torch, gm) -> dict:
    """gmm_drhs_tc's tight check over more draws: moe-1b's training shapes
    in both orientations, 4 seeds of the inputs × 3 router splits (even,
    group_sizes' mild split, a skewed one with an empty group). → the
    largest share of the whole bound, and the largest share of its depth
    term that an error uses past half an ulp of the kernel's bf16 output
    (the output's own rounding): a lower bound on how far the tensor cores'
    f32 sum lies from the f32 reference's."""
    skewed = [6000, 4000, 2500, 1500, 1000, 800, 584, 0]
    share = past = 0.0
    draws = 0
    for seed in range(4):
        g = torch.Generator(device="cuda").manual_seed(1357 + seed)
        mild = [int(x) for x in group_sizes(torch, 16384, MOE_E,
                                            10 + seed).tolist()]
        for sizes in ([2048] * MOE_E, mild, skewed):
            for k, n in ((MOE_D, MOE_FF), (MOE_FF, MOE_D)):
                lhs, _, dout, gs = gmm_inputs(torch, g, 16384, k, n, sizes,
                                              torch.bfloat16)
                got = gm.gmm_drhs_cuda(lhs, dout, gs)
                ref32 = gm.gmm_drhs_reference(lhs.float(), dout.float(), gs,
                                              MOE_E, torch.float32)
                for e, rows in enumerate(sizes):
                    if rows == 0:
                        check(not bool(got[e].any()),
                              "gmm_drhs_tc: an empty group is not zero")
                        continue
                    out = got[e].float()
                    err = (out - ref32[e]).abs()
                    half_ulp = torch.where(
                        out == 0, 0.0,
                        torch.ldexp(torch.ones_like(out),
                                    torch.frexp(out).exponent - 9))
                    share = max(share, (err / gmm_tc_bound(ref32[e], rows))
                                .max().item())
                    past = max(past, ((err - half_ulp).clamp(min=0)
                                      / (1e-4 * rows / 128)).max().item())
                draws += 1
                del lhs, dout, gs, got, ref32
    torch.cuda.empty_cache()
    say(f"gmm_drhs_tc sweep ({draws} draws, moe-1b training shapes): at "
        f"most {share:.4f} of its bound, at most {past:.4f} of the depth "
        f"term 1e-4·rows/128 past half an ulp of the output")
    check(share <= 1, f"gmm_drhs_tc: {share:.4f} of its bound in the sweep")
    return {"draws": draws, "bound_share": share, "depth_term_share": past}


def phase_grouped(torch, gm) -> list:
    """Both grouped kernels vs their plain versions over gmm_cases, the
    forward on the route each case takes and, for bf16, on the CUDA-core
    route too; timings at moe-1b's training (w_gate's K, N), prefill and
    decode shapes."""
    g = torch.Generator(device="cuda").manual_seed(2468)
    errs, timed_drhs, drhs_share = {}, {}, 0.0
    for m, k, n, sizes, dtype in gmm_cases(torch):
        lhs, rhs, dout, gs = gmm_inputs(torch, g, m, k, n, sizes, dtype)
        name = str(dtype).split(".")[-1]
        rhs_t = rhs.transpose(1, 2).contiguous()
        ref_out = gm.grouped_matmul_reference(lhs, rhs, gs)
        ref_dlhs = gm.grouped_matmul_reference(dout, rhs_t, gs)
        for route in sorted({gm._route(dtype), "simt"}):
            out = gm.gmm_cuda(lhs, rhs, gs, route=route)
            dlhs = gm.gmm_cuda(dout, rhs, gs, trans_rhs=True, route=route)
            torch.cuda.synchronize()
            e_out, in_out = _max_err_within(out, ref_out, gmm_tol(name, k),
                                            gmm_tol(name, k))
            e_dlhs, in_dlhs = _max_err_within(
                dlhs, ref_dlhs, gmm_tol(name, n), gmm_tol(name, n))
            ok = in_out and in_dlhs and math.isfinite(e_out + e_dlhs)
            tight = ""
            if route == "tc":
                slack = 0.0
                for got, a, b, depth in ((out, lhs, rhs, k),
                                         (dlhs, dout, rhs_t, n)):
                    ref32 = gm.grouped_matmul_reference(a.float(), b.float(),
                                                        gs)
                    slack = max(slack, ((got.float() - ref32).abs()
                                        / gmm_tc_bound(ref32, depth))
                                .max().item())
                    del ref32
                ok &= slack <= 1
                tight = f"; vs f32 at most {slack:.3f} of its bound"
            say(f"kernel {gm.GMM_ENTRY[route]} {name} M={m} K={k} N={n} "
                f"sizes={sizes if len(sizes) < 9 else '...'}: max_abs_err "
                f"out {e_out:.3e} dlhs {e_dlhs:.3e} (tol "
                f"{gmm_tol(name, k):.1e}/{gmm_tol(name, n):.1e}·(1+|plain|))"
                f"{tight} {'ok' if ok else 'FAIL'}")
            check(ok, f"{gm.GMM_ENTRY[route]} disagrees with the plain "
                      f"version at {(m, k, n, sizes, name)}")
            errs[(m, k, dtype, route)] = e_out
            del out, dlhs
        del ref_out, ref_dlhs, rhs_t
        ref_drhs = gm.gmm_drhs_reference(lhs, dout, gs, len(sizes), dtype)
        for route in sorted({gm._route(dtype), "simt"}):
            drhs = gm.gmm_drhs_cuda(lhs, dout, gs, route=route)
            torch.cuda.synchronize()
            e_drhs, in_drhs = _max_err_within(drhs, ref_drhs, gmm_tol(name, m),
                                              gmm_tol(name, m))
            empty_zero = all(not bool(drhs[i].any())
                             for i, x in enumerate(sizes) if x == 0)
            ok = in_drhs and empty_zero and math.isfinite(e_drhs)
            tight = ""
            if route == "tc":
                used = drhs_tc_share(torch, gm, lhs, dout, gs, drhs)
                drhs_share = max(drhs_share, used)
                ok &= used <= 1
                tight = f"; vs f32 at most {used:.3f} of its bound"
            say(f"kernel {gm.DRHS_ENTRY[route]} {name} M={m} K={k} N={n} "
                f"sizes={sizes if len(sizes) < 9 else '...'}: max_abs_err "
                f"{e_drhs:.3e} (tol {gmm_tol(name, m):.1e}·(1+|plain|)), "
                f"empty groups zero {empty_zero}{tight} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{gm.DRHS_ENTRY[route]} disagrees with the plain "
                      f"version at {(m, k, n, sizes, name)}")
            errs[("drhs", m, k, dtype, route)] = e_drhs
            del drhs
        if m == 16384:
            # moe-1b's training shapes: w_gate / w_up (K, N) = (1024, 3584)
            # and w_down (3584, 1024)
            timed_drhs[k] = time_drhs(torch, gm, "train", lhs, dout, gs)
        if m == 16384 and k == MOE_D:
            timed = time_gmm(torch, gm, "train", lhs, rhs, dout, gs)
        if m == 8192 and k == MOE_D and dtype == torch.bfloat16:
            # the serving path's shapes: prefill 4 × 1024 × top-2 rows on
            # the inputs just compared, decode 4 rows
            at_prefill = time_gmm(torch, gm, "prefill", lhs, rhs, dout, gs)
            decode_gs = torch.tensor([1, 2, 0, 1, 1, 1, 1, 121],
                                     dtype=torch.int32, device="cuda")
            at_decode = time_gmm(torch, gm, "decode", lhs[:128].contiguous(),
                                 rhs, dout[:128].contiguous(), decode_gs)
        del lhs, rhs, dout, gs, ref_drhs
    torch.cuda.empty_cache()
    say(f"gmm_drhs_tc: at most {drhs_share:.3f} of its bound over the bf16 "
        f"cases")
    common = {"route": "cuda",
              "source": "tpu_kubernetes_torch/csrc/grouped_matmul.cu",
              "launches": None}       # filled from its main path's run

    def forward(name, route):
        # max_abs_err at the main path's shapes, both orientations: moe-1b's
        # bf16 training shapes for the tensor-core kernel, its f32 prefill's
        # for the other
        m, dtype = ((16384, torch.bfloat16) if route == "tc"
                    else (8192, torch.float32))
        return {"name": name, **common,
                "replaces": "tpu_kubernetes/ops/grouped_matmul.py:187",
                "max_abs_err": max(errs[(m, k, dtype, route)]
                                   for k in (MOE_D, MOE_FF)),
                **timed[route], "at_prefill_shape": at_prefill[route],
                "at_decode_shape": at_decode[route]}

    def weight_grad(name, route):
        # max_abs_err at the main path's shapes, both orientations: moe-1b's
        # bf16 training shapes for the tensor-core kernel, its f32 gradient
        # check's for the other; times at w_gate's (K, N), w_down's beside
        # them, the CUDA-core kernel's in bf16
        m, dtype = ((16384, torch.bfloat16) if route == "tc"
                    else (4096, torch.float32))
        return {"name": name, **common,
                "replaces": "tpu_kubernetes/ops/grouped_matmul.py:248",
                "max_abs_err": max(errs[("drhs", m, k, dtype, route)]
                                   for k in (MOE_D, MOE_FF)),
                **timed_drhs[MOE_D][route],
                "at_w_down_shape": timed_drhs[MOE_FF][route]}

    return [forward("gmm_tc", "tc"), forward("gmm", "simt"),
            {**weight_grad("gmm_drhs_tc", "tc"),
             "bound_sweep": drhs_tc_sweep(torch, gm)},
            weight_grad("gmm_drhs", "simt")]


def phase_grouped_autograd(torch, gm) -> None:
    """grouped_matmul's kernel lane under autograd: one forward launch,
    then one dlhs (forward kernel) and one drhs launch a backward, with
    the plain lane's gradients."""
    g = torch.Generator(device="cuda").manual_seed(1357)
    for m, k, n, sizes, dtype in (
            (512, 256, 384, [100, 0, 211, 50, 151], torch.float32),
            (2048, MOE_D, 512, [300, 700, 0, 500, 548], torch.bfloat16)):
        lhs, rhs, dout, gs = gmm_inputs(torch, g, m, k, n, sizes, dtype)
        lhs.requires_grad_(True)
        rhs.requires_grad_(True)
        route = gm._route(dtype)
        before = (gm.gmm_cuda.launches, gm.gmm_drhs_cuda.launches,
                  gm.gmm_cuda.route_launches[route],
                  gm.gmm_drhs_cuda.route_launches[route])
        out = gm.grouped_matmul(lhs, rhs, gs)
        gk = torch.autograd.grad(out, (lhs, rhs), dout)
        torch.cuda.synchronize()
        after = (gm.gmm_cuda.launches, gm.gmm_drhs_cuda.launches,
                 gm.gmm_cuda.route_launches[route],
                 gm.gmm_drhs_cuda.route_launches[route])
        gp = torch.autograd.grad(
            gm.grouped_matmul(lhs, rhs, gs, use_kernel=False), (lhs, rhs), dout)
        name = str(dtype).split(".")[-1]
        e_l, in_l = _max_err_within(gk[0], gp[0], gmm_tol(name, n),
                                    gmm_tol(name, n))
        e_r, in_r = _max_err_within(gk[1], gp[1], gmm_tol(name, m),
                                    gmm_tol(name, m))
        counted = tuple(a - b for a, b in zip(after, before))
        say(f"grouped_matmul autograd {name} M={m} K={k} N={n}: dlhs "
            f"{e_l:.3e}, drhs {e_r:.3e} vs the plain lane; launches "
            f"(forward kernel, drhs, each on route {route}) {counted}")
        check(out.grad_fn is not None and in_l and in_r
              and counted == (2, 1, 2, 1),
              f"grouped_matmul kernel-lane gradients at {(m, k, n, name)}")


def device_rows(prof) -> list:
    """(name, ms, count) of every record a profile took on the card
    (kernels, copies, fills), the longest first, summed from the trace's
    events: ``key_averages`` builds the whole tree of host ops first, tens
    of seconds over an eager request."""
    from torch.autograd import DeviceType

    acc: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in acc.items()),
                  key=lambda r: -r[1])


def profile_window(torch, label: str, fn, card: str) -> dict:
    """Kernel time by name and the device's busy share over one call of
    ``fn`` under torch.profiler (one stream, so the kernel times add).
    → {"wall_ms", "kernel_ms", "busy", "names": every kernel's name}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with no_gc(), profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the card's records only: the CPU ops that launched them carry their
    # time too
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    out = {"wall_ms": wall * 1e3, "kernel_ms": busy, "busy": None,
           "names": {r[0] for r in rows}, "rows": rows}
    if busy <= 0:
        say(f"profile {label}: device time not measured (the profiler "
            f"saw no kernels) [{card}]")
        return out
    out["busy"] = busy / (wall * 1e3)
    say(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"kernels {busy:.3f} ms, device busy {busy / (wall * 1e3):.3f} "
        f"[{card}]")
    for name, ms, count in rows[:6]:
        say(f"  {ms:9.3f} ms {ms / busy:6.3f} x{count:<5d} {name[:110]}")
    return out


def phase_llama_1b(torch, fa, card: str) -> dict:
    """llama-1b prefill + generate through the kernel; → launch counts."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import (
        decode_segment,
        decode_step,
        generate,
        prefill,
    )

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    b, width, new = 4, 1024, 64
    tokens = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    span = width + new

    prefill(params, tokens, cfg, max_seq=span, lengths=lengths)   # warm-up
    torch.cuda.synchronize()

    # -- the serving path: every count at 0 just before, read just after -
    reset_counts(fa)
    t0 = time.perf_counter()
    logits, _ = prefill(params, tokens, cfg, max_seq=span, lengths=lengths)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = fa.flash_fwd_cuda.launches
    t0 = time.perf_counter()
    out = generate(params, tokens, cfg, new, prompt_lengths=lengths)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    launches = counts["flash_fwd"]

    check(after_prefill == cfg.n_layers,
          f"prefill launched the kernel {after_prefill} times, not "
          f"{cfg.n_layers}")
    check(launches == 2 * cfg.n_layers,
          f"prefill + generate launched the kernel {launches} times, not "
          f"{2 * cfg.n_layers}")
    check(counts == want_counts(fwd_tc=2 * cfg.n_layers,
                                dattn_tc=(new - 1) * cfg.n_layers),
          f"llama-1b serving launches {counts}: every bf16 d-128 forward "
          f"should take the tensor-core route, no backward kernel, decode "
          f"attention once a layer a step")
    check(tuple(out.shape) == (b, new), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated token out of [0, vocab)")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    plain = replace(cfg, use_kernel=False)
    ref, _ = prefill(params, tokens, plain, max_seq=span, lengths=lengths)
    torch.cuda.synchronize()
    check(fa.flash_fwd_cuda.launches == launches,
          "the plain lane launched the kernel")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    say(f"llama-1b prefill logits kernel vs plain: max_abs_err {err:.4e}, "
        f"max |logit| {scale:.4e}, rel {err / scale:.3e} (tol "
        f"{LOGIT_REL_TOL:.0e}), argmax agreement {agree:.2f}")
    check(err <= LOGIT_REL_TOL * scale,
          "llama-1b kernel logits disagree with the plain lane")
    check(agree == 1.0, "llama-1b greedy argmax differs between the kernel "
                        "and the plain lane")
    # one decode step on the same cache, decode attention kernel vs plain
    _, cache = prefill(params, tokens, cfg, max_seq=span, lengths=lengths)
    first = logits.argmax(-1).to(torch.int32)
    mark = read_counts(fa)["decode_attention"]
    step_ref, _ = decode_step(params, replace(cache), first, plain)
    check(read_counts(fa)["decode_attention"] == mark,
          "the plain lane launched the decode-attention kernel")
    # each step writes its own K/V at the same slot before it attends
    step, _ = decode_step(params, replace(cache), first, cfg)
    torch.cuda.synchronize()
    err = (step - step_ref).abs().max().item()
    scale = step_ref.abs().max().item()
    agree = (step.argmax(-1) == step_ref.argmax(-1)).float().mean().item()
    say(f"llama-1b decode-step logits, decode-attention kernel vs plain: "
        f"max_abs_err {err:.4e}, max |logit| {scale:.4e}, rel "
        f"{err / scale:.3e} (tol {LOGIT_REL_TOL:.0e}), argmax agreement "
        f"{agree:.2f}")
    check(err <= LOGIT_REL_TOL * scale,
          "llama-1b decode-step logits disagree with the plain lane")

    real = int(lengths.sum())
    decode_ms = (t_generate - t_prefill) / (new - 1) * 1e3
    say(f"llama-1b prefill: {b}x{width} padded ({real} real tokens) in "
        f"{t_prefill * 1e3:.2f} ms = {b * width / t_prefill:.1f} padded "
        f"tokens/s, {real / t_prefill:.1f} real tokens/s [{card}]")
    say(f"llama-1b decode: generate {new} tokens x {b} rows in "
        f"{t_generate * 1e3:.2f} ms; (generate - prefill) / {new - 1} = "
        f"{decode_ms:.3f} ms/step [{card}]")

    def decode8():
        logits, cache = prefill(params, tokens, cfg, max_seq=span,
                                lengths=lengths)
        torch.cuda.synchronize()
        first = logits.argmax(-1).to(torch.int32)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        return lambda: decode_segment(params, cache, first, done, cfg, 8)

    profile_window(torch, "llama-1b prefill 4x1024", lambda: prefill(
        params, tokens, cfg, max_seq=span, lengths=lengths), card)
    profile_window(torch, "llama-1b decode_segment 8 steps x 4 rows",
                   decode8(), card)
    del params
    torch.cuda.empty_cache()
    return counts


def reset_counts(fa) -> None:
    """Every wrapper's launch count, and the graphs' tallies of captured
    and replayed launches, to 0."""
    importlib.import_module("tpu_kubernetes_torch.ops").reset_launch_counts()
    importlib.import_module("tpu_kubernetes_torch.util.graphs") \
        .reset_launches()


def read_counts(fa) -> dict:
    """The launches the card ran, by kernel name, and the routed wrappers'
    by route as ``name.route``: each wrapper's own count, less what CUDA
    graph captures recorded without running, plus what their replays ran
    (each capture's launches times its replays)."""
    ops = importlib.import_module("tpu_kubernetes_torch.ops")
    graphs = importlib.import_module("tpu_kubernetes_torch.util.graphs")
    return graphs.device_launches(ops.launch_counts())


def want_counts(fwd_tc=0, fwd_simt=0, dq_tc=0, dq_simt=0, dkv_tc=0,
                dkv_simt=0, gmm_tc=0, gmm_simt=0, drhs_tc=0,
                drhs_simt=0, adamw=0, dattn_tc=0, dattn_simt=0,
                chunk_tc=0, chunk_simt=0, dattn_q8=0, chunk_q8=0,
                dattn_tc8=0, chunk_tc8=0, w8_tc=0, w8_gemv=0,
                w8_dequant=0) -> dict:
    """The counts read_counts should read: each kernel's launches by route
    and in all; ``adamw`` optimizer steps launch each AdamW kernel once;
    ``dattn_*`` decode-attention launches (one a layer a decode step),
    ``chunk_*`` those of them with more than one position a row; ``w8_tc``
    and ``w8_gemv`` the weight-only int8 matmul's launches on the tensor
    cores and on the CUDA cores, ``w8_dequant`` its calls of more than
    MAX_ROWS rows (dequantize + torch.matmul, no kernel of its own)."""
    return {"flash_fwd": fwd_tc + fwd_simt, "flash_fwd.tc": fwd_tc,
            "flash_fwd.simt": fwd_simt, "flash_bwd_dq": dq_tc + dq_simt,
            "flash_bwd_dq.tc": dq_tc, "flash_bwd_dq.simt": dq_simt,
            "flash_bwd_dkv": dkv_tc + dkv_simt, "flash_bwd_dkv.tc": dkv_tc,
            "flash_bwd_dkv.simt": dkv_simt, "gmm": gmm_tc + gmm_simt,
            "gmm.tc": gmm_tc, "gmm.simt": gmm_simt,
            "gmm_drhs": drhs_tc + drhs_simt, "gmm_drhs.tc": drhs_tc,
            "gmm_drhs.simt": drhs_simt, "adamw_sumsq": adamw,
            "adamw_update": adamw,
            "decode_attention": dattn_tc + dattn_simt + dattn_q8 + dattn_tc8,
            "decode_attention.tc": dattn_tc,
            "decode_attention.simt": dattn_simt,
            "decode_attention.q8": dattn_q8,
            "decode_attention.tc8": dattn_tc8,
            "decode_attention.tc8.chunk": chunk_tc8,
            "decode_attention.tc.chunk": chunk_tc,
            "decode_attention.simt.chunk": chunk_simt,
            "decode_attention.q8.chunk": chunk_q8,
            "w8_matmul": w8_tc + w8_gemv, "w8_matmul.tc": w8_tc,
            "w8_matmul.gemv": w8_gemv, "w8_matmul.dequant": w8_dequant}


def _loss_and_grads(torch, params, tokens, cfg):
    from tpu_kubernetes_torch.models import loss_fn
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tokens, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def phase_train(torch, fa, card: str) -> dict:
    """llama-1b training through the job's entry point; → launch counts."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        synthetic_batches,
        train_step,
    )
    from tpu_kubernetes_torch.train import job

    import io
    import tempfile

    import numpy as np

    dev = torch.device("cuda")
    cfg = CONFIGS[TRAIN_ENV["JOB_MODEL"]]
    steps = int(TRAIN_ENV["JOB_STEPS"])
    check(cfg.remat and cfg.remat_policy == "dots",
          "llama-1b should train under remat 'dots'")
    evals = steps // int(TRAIN_EVAL_ENV["JOB_EVAL_EVERY"])
    eval_batches = int(TRAIN_EVAL_ENV["JOB_EVAL_BATCHES"])

    with tempfile.TemporaryDirectory() as tmp:
        # a held-out token file from a seed: 16 windows of 2,049 tokens
        held_out = Path(tmp) / "eval.bin"
        np.random.default_rng(11).integers(
            0, cfg.vocab_size, 16 * 2049, dtype=np.uint16).tofile(held_out)
        env = {**TRAIN_ENV, **TRAIN_EVAL_ENV,
               "JOB_EVAL_DATA_PATH": str(held_out)}
        # -- the main path: every count at 0 just before, read just after --
        torch.cuda.reset_peak_memory_stats()    # the job's peak line: its own
        reset_counts(fa)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            out = job.main(env)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(fa)
        # ---------------------------------------------------------------
    sys.stderr.write(err.getvalue())
    eval_lines = re.findall(r"eval step=(\d+) loss=(\S+)", err.getvalue())
    check([int(s) for s, _ in eval_lines] == [
        (i + 1) * int(TRAIN_EVAL_ENV["JOB_EVAL_EVERY"]) for i in range(evals)]
          and all(math.isfinite(float(x)) for _, x in eval_lines),
          f"the job's eval lines {eval_lines}")

    # per step: a forward per layer, the same again when remat recomputes
    # the block in the backward, and one of each backward kernel per layer;
    # per eval batch one forward per layer (the eval step's graph)
    want = want_counts(
        fwd_tc=2 * cfg.n_layers * steps + evals * eval_batches * cfg.n_layers,
        dq_tc=cfg.n_layers * steps, dkv_tc=cfg.n_layers * steps, adamw=steps)
    say(f"llama-1b train job: {steps} steps of {TRAIN_ENV['JOB_BATCH']}x"
        f"{TRAIN_ENV['JOB_SEQ']}, eval of {eval_batches} held-out batches "
        f"at steps {[int(s) for s, _ in eval_lines]} (losses "
        f"{[float(x) for _, x in eval_lines]}) in {wall:.2f} s (first step at "
        f"+{out['first_step_s']:.2f} s, includes set-up), last loss "
        f"{out['loss']:.4f}, launches {launches} (want {want})")
    check(launches == want, f"train launches {launches} != {want}")
    check(out["loss"] is not None and math.isfinite(out["loss"]),
          f"non-finite training loss {out['loss']}")
    check(out["tokens_per_s"] is not None and out["tokens_per_s"] > 0,
          "the job logged no tokens/s")
    say(f"llama-1b train: {out['tokens_per_s']:.1f} tokens/s over steps "
        f"1-{steps} (the job's own window, first step included) [{card}]")

    # -- overfitting one batch: the loss must fall -------------------------
    tc = TrainConfig(warmup_steps=2)
    state = init_state(torch.Generator(device=dev).manual_seed(1), cfg, tc,
                       dev)
    batch = next(synthetic_batches(cfg.vocab_size, 4, 2048, seed=7,
                                   device=dev))
    losses, times = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, batch, cfg, tc)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    say(f"llama-1b overfit one 4x2048 batch, 5 train_steps: losses "
        f"{[round(x, 4) for x in losses]}; step wall "
        f"{[round(t * 1e3, 1) for t in times]} ms, steady "
        f"{4 * 2048 / min(times[1:]):.1f} tokens/s [{card}]")
    check(all(math.isfinite(x) for x in losses), "non-finite overfit loss")
    check(losses[-1] < losses[0], f"the overfit loss did not fall: {losses}")
    profile_window(torch, "llama-1b train_step 4x2048",
                   lambda: train_step(state, batch, cfg, tc), card)
    del state, batch
    torch.cuda.empty_cache()

    # -- kernel-lane gradients against plain-lane gradients ----------------
    small = replace(cfg, n_layers=2)
    params = init_params(small, torch.Generator(device=dev).manual_seed(2),
                         dev)
    tokens = torch.randint(0, small.vocab_size, (1, 2049), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3),
                           dtype=torch.int32)
    reset_counts(fa)
    lk, gk = _loss_and_grads(torch, params, tokens, small)
    torch.cuda.synchronize()
    mark = read_counts(fa)
    check(mark == want_counts(fwd_tc=4, dq_tc=2, dkv_tc=2),
          f"2-layer kernel-lane launches {mark}")
    lp, gp = _loss_and_grads(torch, params, tokens,
                             replace(small, use_kernel=False))
    torch.cuda.synchronize()
    check(read_counts(fa) == mark, "the plain lane launched a kernel")
    names = [".".join(k) for k in _leaf_names(params)]
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, gk, gp)}
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    say(f"llama-1b (2 layers, 1x2048) kernel vs plain lane: loss "
        f"{lk.item():.6f} vs {lp.item():.6f} (rel {loss_rel:.3e}, tol "
        f"{TRAIN_LOSS_REL_TOL:.0e}); gradient ||diff||/||plain|| per leaf "
        + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
        + f" (tol {TRAIN_GRAD_REL_TOL:.0e})")
    check(loss_rel <= TRAIN_LOSS_REL_TOL, "llama-1b loss kernel vs plain")
    check(all(math.isfinite(r) and r <= TRAIN_GRAD_REL_TOL
              for r in rel.values()),
          "llama-1b gradients through the kernels disagree with the plain "
          "lane's")
    del params, gk, gp
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def routing_log(torch, moe):
    """Record every routing decision (the chosen experts, (k, b, s)) and
    the smallest margin between the top-k gates and the next one."""
    seen, margins, inner = [], [], moe._topk_selection

    def record(gates, k):
        idxs, masks = inner(gates, k)
        top = torch.sort(gates, dim=-1, descending=True).values
        seen.append(torch.stack(idxs))
        margins.append((top[..., :k] - top[..., 1:k + 1]).min())
        return idxs, masks

    moe._topk_selection = record
    try:
        yield seen, margins
    finally:
        moe._topk_selection = inner


def moe_cfg():
    from tpu_kubernetes_torch.models import CONFIGS

    return replace(CONFIGS["moe-1b"], dispatch_mode="grouped")


def phase_moe_serve(torch, fa, card: str) -> tuple[dict, dict]:
    """moe-1b (grouped) prefill + generate through the kernels, then the
    f32 kernel lane against the plain lane; → the counts of both paths."""
    from tpu_kubernetes_torch.models import init_params, moe
    from tpu_kubernetes_torch.models.decode import (
        decode_segment,
        generate,
        prefill,
    )

    dev = torch.device("cuda")
    cfg = moe_cfg()
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    b, width, new = 4, 1024, 64
    tokens = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    span = width + new
    prefill(params, tokens, cfg, max_seq=span, lengths=lengths)   # warm-up
    torch.cuda.synchronize()

    # -- the serving path: every count at 0 just before, read just after -
    reset_counts(fa)
    t0 = time.perf_counter()
    logits, _ = prefill(params, tokens, cfg, max_seq=span, lengths=lengths)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = read_counts(fa)
    t0 = time.perf_counter()
    out = generate(params, tokens, cfg, new, prompt_lengths=lengths)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    say(f"moe-1b prefill launches {after_prefill}; prefill + generate "
        f"{counts}")
    check(after_prefill["gmm"] == 3 * L and after_prefill["flash_fwd"] == L,
          f"moe-1b prefill launches {after_prefill}, want gmm {3 * L}, "
          f"flash_fwd {L}")
    # generate: its prefill, then new - 1 decode steps of 3 per layer
    want_gmm = 3 * L * (1 + 1 + new - 1)
    check(counts == want_counts(fwd_tc=2 * L, gmm_tc=want_gmm,
                                dattn_tc=(new - 1) * L),
          f"moe-1b prefill + generate launches {counts}, want gmm "
          f"{want_gmm}, flash_fwd {2 * L}, all on the tensor-core routes, "
          f"no backward kernel")
    check(tuple(out.shape) == (b, new), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated token out of [0, vocab)")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    real = int(lengths.sum())
    say(f"moe-1b prefill: {b}x{width} padded ({real} real tokens) in "
        f"{t_prefill * 1e3:.2f} ms = {b * width / t_prefill:.1f} padded "
        f"tokens/s, {real / t_prefill:.1f} real tokens/s [{card}]")
    say(f"moe-1b decode: generate {new} tokens x {b} rows in "
        f"{t_generate * 1e3:.2f} ms; (generate - prefill) / {new - 1} = "
        f"{(t_generate - t_prefill) / (new - 1) * 1e3:.3f} ms/step [{card}]")

    def decode8():
        logits, cache = prefill(params, tokens, cfg, max_seq=span,
                                lengths=lengths)
        torch.cuda.synchronize()
        first = logits.argmax(-1).to(torch.int32)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        return lambda: decode_segment(params, cache, first, done, cfg, 8)

    profile_window(torch, "moe-1b prefill 4x1024", lambda: prefill(
        params, tokens, cfg, max_seq=span, lengths=lengths), card)
    profile_window(torch, "moe-1b decode_segment 8 steps x 4 rows",
                   decode8(), card)

    # -- f32: kernel lane vs plain lane, decision for decision ------------
    cfg32 = replace(cfg, dtype=torch.float32)
    p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    lanes = {}
    for lane, c in (("kernel", cfg32), ("plain", replace(cfg32,
                                                         use_kernel=False))):
        if lane == "kernel":
            reset_counts(fa)     # the f32 path: every count at 0 just before
        mark = read_counts(fa)
        with routing_log(torch, moe) as (seen, margins):
            lg, _ = prefill(p32, tokens, c, max_seq=span, lengths=lengths)
            toks = generate(p32, tokens, c, new, prompt_lengths=lengths)
            torch.cuda.synchronize()
        if lane == "kernel":
            f32_counts = read_counts(fa)                # ... read just after
        launched = read_counts(fa) != mark
        check(launched == (lane == "kernel"),
              f"the {lane} lane launched kernels: {launched}")
        lanes[lane] = (lg, toks, seen, min(float(m) for m in margins))
    check(f32_counts == want_counts(fwd_simt=2 * L, gmm_simt=want_gmm,
                                    dattn_simt=(new - 1) * L),
          f"moe-1b f32 kernel-lane launches {f32_counts}: f32 takes the "
          f"CUDA-core routes")
    (lk, tk, rk, _), (lp, tp, rp, margin) = lanes["kernel"], lanes["plain"]
    flips = sum(int((a != b).sum()) for a, b in zip(rk, rp))
    decisions = sum(a.numel() for a in rp)
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    same = tk.tolist() == tp.tolist()
    say(f"moe-1b f32 kernel vs plain lane: prefill logits max_abs_err "
        f"{err:.4e} of max |logit| {scale:.4e} (rel {err / scale:.3e}, tol "
        f"{MOE_LOGIT_REL_TOL:.0e}); routing decisions differing {flips} of "
        f"{decisions} (smallest top-2 gate margin {margin:.3e}); greedy "
        f"{new} tokens x {b} rows {'identical' if same else 'DIFFER'}")
    check(len(rk) == len(rp) and flips == 0,
          f"{flips} routing decisions differ between the lanes")
    check(err <= MOE_LOGIT_REL_TOL * scale,
          "moe-1b f32 kernel logits disagree with the plain lane")
    check(same, "moe-1b f32 greedy tokens differ between the lanes")
    del p32, lanes, lk, lp
    torch.cuda.empty_cache()
    return counts, f32_counts


def phase_moe_train(torch, fa, card: str) -> tuple[dict, dict]:
    """moe-1b (grouped) train steps through the kernels, then a 2-layer
    f32 gradient check; → the launch counts of both paths."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        synthetic_batches,
        train_step,
    )

    dev = torch.device("cuda")
    cfg = moe_cfg()
    L, steps, b, seq = cfg.n_layers, 10, 4, 2048
    check(cfg.remat and cfg.remat_policy == "moe",
          "moe-1b should train under remat 'moe'")
    tc = TrainConfig()
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, tc,
                       dev)
    batches = synthetic_batches(cfg.vocab_size, b, seq, seed=0, device=dev)
    state, loss = train_step(state, next(batches), cfg, tc)      # warm-up
    torch.cuda.synchronize()

    # -- the main path: every count at 0 just before, read just after ----
    reset_counts(fa)
    walls, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = train_step(state, next(batches), cfg, tc)
        losses.append(loss.item())        # waits for the step
        walls.append(time.perf_counter() - t0)
    launches = read_counts(fa)
    # -----------------------------------------------------------------------
    # per layer and step: 3 grouped products forward, w_gate's and w_up's
    # again under remat "moe", 3 dlhs; 3 drhs; flash 2 forward (remat), 1+1
    want = want_counts(fwd_tc=2 * L * steps, dq_tc=L * steps,
                       dkv_tc=L * steps, gmm_tc=8 * L * steps,
                       drhs_tc=3 * L * steps, adamw=steps)
    steady = b * seq / min(walls)
    say(f"moe-1b grouped train: {steps} train_steps of {b}x{seq}, losses "
        f"{[round(x, 4) for x in losses]}, step wall "
        f"{[round(w * 1e3, 1) for w in walls]} ms, launches {launches} "
        f"(want {want})")
    say(f"moe-1b grouped train: steady {steady:.1f} tokens/s (fastest step "
        f"of {steps}), {b * seq * steps / sum(walls):.1f} tokens/s over the "
        f"{steps} steps; device memory peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")
    check(launches == want, f"moe train launches {launches} != {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite moe loss")
    batch = next(batches)
    profile_window(torch, "moe-1b grouped train_step 4x2048",
                   lambda: train_step(state, batch, cfg, tc), card)
    del state
    torch.cuda.empty_cache()

    # -- overfitting one batch: the loss must fall -------------------------
    tc2 = TrainConfig(warmup_steps=2)
    state = init_state(torch.Generator(device=dev).manual_seed(1), cfg, tc2,
                       dev)
    over = []
    for _ in range(5):
        state, loss = train_step(state, batch, cfg, tc2)
        over.append(loss.item())
    say(f"moe-1b overfit one 4x2048 batch, 5 train_steps: losses "
        f"{[round(x, 4) for x in over]}")
    check(all(math.isfinite(x) for x in over), "non-finite overfit loss")
    check(over[-1] < over[0], f"the moe overfit loss did not fall: {over}")
    del state, batch, batches
    torch.cuda.empty_cache()

    # -- 2 layers in f32: kernel-lane gradients against plain-lane ---------
    # (the main path of the CUDA-core dQ, dK/dV and drhs kernels)
    small = replace(cfg, n_layers=2, dtype=torch.float32)
    params = init_params(small, torch.Generator(device=dev).manual_seed(2),
                         dev)
    tokens = torch.randint(0, small.vocab_size, (1, seq + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3),
                           dtype=torch.int32)
    reset_counts(fa)     # every count at 0 just before, read just after
    lk, gk = _loss_and_grads(torch, params, tokens, small)
    torch.cuda.synchronize()
    mark = read_counts(fa)
    check(mark == want_counts(fwd_simt=4, dq_simt=2, dkv_simt=2,
                              gmm_simt=16, drhs_simt=6),
          f"2-layer moe kernel-lane launches {mark} (f32: the CUDA-core "
          f"routes)")
    lp, gp = _loss_and_grads(torch, params, tokens,
                             replace(small, use_kernel=False))
    torch.cuda.synchronize()
    check(read_counts(fa) == mark, "the plain lane launched a kernel")
    names = [".".join(k) for k in _leaf_names(params)]
    rel = {n: ((a - b).norm() / b.norm()).item()
           for n, a, b in zip(names, gk, gp)}
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    say(f"moe-1b (2 layers, 1x2048, f32) kernel vs plain lane: loss "
        f"{lk.item():.6f} vs {lp.item():.6f} (rel {loss_rel:.3e}, tol "
        f"{MOE_LOSS_REL_TOL:.0e}); gradient ||diff||/||plain|| per leaf "
        + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
        + f" (tol {MOE_GRAD_REL_TOL:.0e})")
    check("layers.w_router" in rel, "no router gradient")
    check(loss_rel <= MOE_LOSS_REL_TOL, "moe-1b loss kernel vs plain")
    check(all(math.isfinite(r) and r <= MOE_GRAD_REL_TOL
              for r in rel.values()),
          "moe-1b gradients through the kernels disagree with the plain "
          "lane's")
    del params, gk, gp
    torch.cuda.empty_cache()
    return launches, mark


def phase_moe_job(torch, fa, card: str) -> dict:
    """train.job.main() at JOB_MODEL=moe-1b: the preset's "gather"
    dispatch, so flash launches only; → launch counts."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.train import job

    cfg = CONFIGS[MOE_ENV["JOB_MODEL"]]
    L, steps = cfg.n_layers, int(MOE_ENV["JOB_STEPS"])
    check(cfg.dispatch_mode == "gather", "moe-1b's preset dispatch")
    torch.cuda.reset_peak_memory_stats()    # the job's peak line: its own
    reset_counts(fa)
    t0 = time.perf_counter()
    out = job.main(dict(MOE_ENV))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa)
    want = want_counts(fwd_tc=2 * L * steps, dq_tc=L * steps,
                       dkv_tc=L * steps, adamw=steps)
    say(f"moe-1b train job (gather): {steps} steps of {MOE_ENV['JOB_BATCH']}"
        f"x{MOE_ENV['JOB_SEQ']} in {wall:.2f} s, last loss {out['loss']:.4f}, "
        f"launches {launches} (want {want})")
    check(launches == want, f"moe job launches {launches} != {want}")
    check(out["loss"] is not None and math.isfinite(out["loss"]),
          f"non-finite moe job loss {out['loss']}")
    check(out["tokens_per_s"] is not None and out["tokens_per_s"] > 0,
          "the moe job logged no tokens/s")
    say(f"moe-1b train job: {out['tokens_per_s']:.1f} tokens/s over steps "
        f"1-{steps} (the job's own window, first step included) [{card}]")
    torch.cuda.empty_cache()
    return launches


# -- the rest of one-device training and the model tooling (phase 9b) -------
# the Adafactor job, its checkpoint and resume: llama-1b at 4 x 2048 on a
# token file (a resumed run carries on through it from its step)
ADAFACTOR_ENV = {**TRAIN_ENV, "JOB_OPTIMIZER": "adafactor"}
# the LoRA finetune: llama-1b at 4 x 2048, rank 8 on the attention
# projections, 10 steps on one batch of a token file, so the loss falls
FT_ENV = {"FT_DEVICE": "cuda", "FT_MODEL": "llama-1b", "FT_STEPS": "10",
          "FT_BATCH": "4", "FT_SEQ": "2048", "FT_RANK": "8",
          "FT_TARGETS": "wq,wk,wv,wo", "FT_LR": "1e-3"}


def _quiet(fn, *args):
    """fn(*args) with its stderr captured → (result, the stderr text),
    echoed after."""
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args)
    sys.stderr.write(err.getvalue())
    return out, err.getvalue()


def _tree_bytes(tree) -> int:
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _job_peak(text: str) -> float:
    return float(re.search(r"device memory peak=([\d.]+)GiB", text).group(1))


def tooling_adafactor(torch, fa, card: str, tmp: Path) -> dict:
    """The Adafactor job uninterrupted, then five steps that save once and
    a second main() that resumes from step 5 to 10; the AdamW job beside
    it; the optimizer states and the graphed steps of both in turns.
    → launch counts of the uninterrupted Adafactor job."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        job,
        make_train_step,
    )
    from tpu_kubernetes_torch.train.trainer import factored_dims, tree_leaves

    import numpy as np

    dev = torch.device("cuda")
    cfg = CONFIGS[ADAFACTOR_ENV["JOB_MODEL"]]
    L, steps = cfg.n_layers, int(ADAFACTOR_ENV["JOB_STEPS"])
    b, seq = int(ADAFACTOR_ENV["JOB_BATCH"]), int(ADAFACTOR_ENV["JOB_SEQ"])
    data = tmp / "train.bin"     # 48 windows: more than one epoch of steps
    np.random.default_rng(12).integers(
        0, cfg.vocab_size, 48 * (seq + 1), dtype=np.uint16).tofile(data)
    env = {**ADAFACTOR_ENV, "JOB_DATA_PATH": str(data)}

    # -- the main path: every count at 0 just before, read just after ------
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    full, text = _quiet(job.main, env)
    torch.cuda.synchronize()
    launches = read_counts(fa)
    # -----------------------------------------------------------------------
    want = {**want_counts(fwd_tc=2 * L * steps, dq_tc=L * steps,
                          dkv_tc=L * steps), "adamw_sumsq": steps}
    say(f"llama-1b adafactor job: {steps} steps of {b}x{seq}, losses "
        f"{[round(x, 4) for x in full['losses']]}, launches {launches} "
        f"(want {want})")
    check(launches == want, f"adafactor job launches {launches} != {want}")
    check(all(math.isfinite(x) for x in full["losses"]),
          "non-finite adafactor loss")
    peaks = {"adafactor": _job_peak(text)}
    tps = {"adafactor": full["tokens_per_s"]}
    torch.cuda.reset_peak_memory_stats()
    adamw, text = _quiet(job.main, {**env, "JOB_OPTIMIZER": "adamw"})
    peaks["adamw"], tps["adamw"] = _job_peak(text), adamw["tokens_per_s"]
    check(all(math.isfinite(x) for x in adamw["losses"]),
          "non-finite adamw loss")

    # -- five steps that save once, then a resume from step 5 to 10 ---------
    ck = tmp / "adafactor-ckpt"
    first, text1 = _quiet(job.main, {**env, "JOB_STEPS": "5",
                                     "JOB_CHECKPOINT_DIR": str(ck),
                                     "JOB_CHECKPOINT_EVERY": "5"})
    ck_bytes = _dir_bytes(ck)
    second, text2 = _quiet(job.main, {**env, "JOB_CHECKPOINT_DIR": str(ck),
                                      "JOB_CHECKPOINT_EVERY": "1000"})
    shutil.rmtree(ck)
    save_s = float(re.search(r"checkpointed step 5 \(([\d.]+)s\)",
                             text1).group(1))
    restore_s = float(re.search(r"resumed from step 5 \(([\d.]+)s\)",
                                text2).group(1))
    resumed = first["losses"] + second["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, full["losses"]))
    say(f"llama-1b adafactor resume: steps 1-5 then 6-10 after a restore "
        f"{[round(x, 4) for x in resumed]}; bitwise equal to the "
        f"uninterrupted run: {resumed == full['losses']} (max rel diff "
        f"{rel:.3e}); checkpoint {ck_bytes} bytes, save {save_s:.2f} s, "
        f"restore {restore_s:.2f} s [{card}]")
    check(second["start_step"] == 5 and len(second["losses"]) == 5,
          f"the second job started at {second['start_step']}")
    # a resumed step replays the same kernels on the same bits: equal
    # unless a kernel is not deterministic, and then within the bound the
    # graphed and eager steps are held to
    check(rel <= TRAIN_LOSS_REL_TOL, "the resumed losses differ from the "
                                     "uninterrupted run's")

    # -- the optimizer states, and the graphed steps in turns ---------------
    fns, sizes = {}, {}
    for name in ("adamw", "adafactor"):
        tc = TrainConfig(optimizer=name)
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           tc, dev)
        sizes[name] = _tree_bytes(state["opt_state"])
        if name == "adafactor":
            opt = state["opt_state"]
            leaves = tree_leaves(state["params"])
            rows = tree_leaves(opt["v_row"])
            factored = [factored_dims(tuple(p.shape)) is not None
                        for p in leaves]
            check(all(r.dtype == torch.bfloat16 for r in rows)
                  and all(c.dtype == torch.bfloat16
                          for c in tree_leaves(opt["v_col"]))
                  and all(m.dtype == torch.bfloat16
                          for m in tree_leaves(opt["mu"])),
                  "adafactor's statistics should be bf16 at llama-1b")
            check(factored.count(True) == 9 and factored.count(False) == 3,
                  f"factored leaves {factored}")
        fns[name] = make_train_step(cfg, tc, state, (b, seq + 1))
    check(sizes["adafactor"] < sizes["adamw"],
          f"adafactor state {sizes['adafactor']} not under adamw's")
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = torch.randint(0, cfg.vocab_size, (b, seq + 1), generator=gen,
                          device=dev, dtype=torch.int32)
    for name in fns:                     # the capture
        fns[name](batch)
    walls = {name: [] for name in fns}
    for rep in range(2):
        for name in (("adamw", "adafactor") if rep % 2 == 0
                     else ("adafactor", "adamw")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fns[name](batch)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / 3 * 1e3)
    for name in ("adamw", "adafactor"):
        ms = min(walls[name])
        say(f"llama-1b {name}: graphed step wall {spread(walls[name])} ms "
            f"({b * seq / ms * 1e3:.1f} tokens/s at the best), the job's "
            f"tokens/s over steps 1-{steps} {tps[name]:.1f} (first step "
            f"included), the job's device memory peak {peaks[name]:.2f} "
            f"GiB, optimizer state {sizes[name]} bytes [{card}]")
    del fns
    torch.cuda.empty_cache()
    return launches


def tooling_lora(torch, fa, card: str, tmp: Path) -> dict:
    """run_finetune at llama-1b: the loss falls, the merged w_gate is the
    base's bit for bit and wq is not, the graphed step's losses equal an
    eager step's within the bf16 training bound. → launch counts."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.train import input_pipeline
    from tpu_kubernetes_torch.train.checkpoint import restore
    from tpu_kubernetes_torch.train.finetune import run_finetune
    from tpu_kubernetes_torch.train.lora import (
        LoraConfig,
        init_lora_state,
        make_lora_step,
    )

    import numpy as np

    dev = torch.device("cuda")
    cfg = CONFIGS[FT_ENV["FT_MODEL"]]
    L, steps = cfg.n_layers, int(FT_ENV["FT_STEPS"])
    b, seq = int(FT_ENV["FT_BATCH"]), int(FT_ENV["FT_SEQ"])
    lr = float(FT_ENV["FT_LR"])
    data = tmp / "finetune.bin"           # one batch: every step sees it
    np.random.default_rng(13).integers(
        0, cfg.vocab_size, b * (seq + 1), dtype=np.uint16).tofile(data)
    out_dir = tmp / "merged"
    env = {**FT_ENV, "FT_DATA_PATH": str(data), "FT_OUT": str(out_dir)}

    # -- the main path: every count at 0 just before, read just after ------
    reset_counts(fa)
    t0 = time.perf_counter()
    out, _ = _quiet(run_finetune, env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa)
    # -----------------------------------------------------------------------
    # per step as the train step (forward, remat's forward, both backward
    # kernels a layer); the adapters' update without a clip: no norm kernel
    want = {**want_counts(fwd_tc=2 * L * steps, dq_tc=L * steps,
                          dkv_tc=L * steps), "adamw_update": steps}
    losses = out["losses"]
    say(f"llama-1b LoRA finetune: {steps} steps of {b}x{seq}, rank "
        f"{FT_ENV['FT_RANK']} on {FT_ENV['FT_TARGETS']}, losses "
        f"{[round(x, 4) for x in losses]} in {wall:.2f} s (merge and save "
        f"included), launches {launches} (want {want})")
    check(launches == want, f"LoRA launches {launches} != {want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the LoRA loss did not fall: {losses}")
    say(f"llama-1b LoRA graphed step wall {out['step_s'] * 1e3:.3f} ms "
        f"(steps 2-{steps}, mean) [{card}]")

    # -- the merged weights: adapted leaves moved, the others the base's ----
    base = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    like = {"params": init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(5), dev)}
    restore(out_dir, like=like)
    shutil.rmtree(out_dir)
    merged = like["params"]["layers"]
    for name in ("w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"):
        check(torch.equal(merged[name], base["layers"][name]),
              f"merged {name} is not the base's")
    for name in FT_ENV["FT_TARGETS"].split(","):
        check(not torch.equal(merged[name], base["layers"][name]),
              f"merged {name} is the base's")
    say("llama-1b LoRA merge: w_gate, w_up, w_down and the norms bit for "
        "bit the base's; wq, wk, wv, wo moved")
    del like, merged

    # -- the same steps eagerly, from the same seeds and batches ------------
    lc = LoraConfig(rank=int(FT_ENV["FT_RANK"]),
                    targets=tuple(FT_ENV["FT_TARGETS"].split(",")))
    state = init_lora_state(torch.Generator(device=dev).manual_seed(1), base,
                            cfg, lc, learning_rate=lr)
    step = make_lora_step(cfg, lc, state, base, (b, seq + 1),
                          learning_rate=lr, graphs=False)
    batches = input_pipeline(data, b, seq, cfg.vocab_size, dev)
    eager, times = [], []
    for _ in range(steps):
        x = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.append(step(x).item())
        times.append(time.perf_counter() - t0)
    batches.close()
    rel = max(abs(g - e) / abs(e) for g, e in zip(losses, eager))
    say(f"llama-1b LoRA eager steps {[round(x, 4) for x in eager]}: max rel "
        f"diff to the graphed {rel:.3e} (tol {TRAIN_LOSS_REL_TOL:.0e}); "
        f"eager step wall {statistics.median(times[1:]) * 1e3:.3f} ms "
        f"(median of steps 2-{steps}) [{card}]")
    check(rel <= TRAIN_LOSS_REL_TOL, "graphed LoRA losses differ from eager")
    del state, step, base
    torch.cuda.empty_cache()
    return launches


def tooling_hf_round_trip(torch, card: str) -> None:
    """llama-1b params from a seed → hf_state_dict_from_params →
    params_from_hf_state_dict, on the card (no transformers): every leaf
    and one prefill's logits bit for bit."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.convert_hf import (
        hf_state_dict_from_params,
        params_from_hf_state_dict,
    )
    from tpu_kubernetes_torch.models.decode import prefill
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = hf_state_dict_from_params(params, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = params_from_hf_state_dict(sd, cfg, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(len(sd) == 3 + 9 * cfg.n_layers, f"{len(sd)} HF tensors")
    del sd
    pairs = list(zip(tree_leaves(params), tree_leaves(back)))
    check(all(a.dtype == c.dtype and torch.equal(a, c) for a, c in pairs),
          "the HF round trip changed a leaf")
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    la, _ = prefill(params, tokens, cfg)
    lb, _ = prefill(back, tokens, cfg)
    check(torch.equal(la, lb), "the round trip's prefill logits differ")
    say(f"llama-1b HF round trip without transformers: {len(pairs)} leaves "
        f"bit for bit, prefill logits (2 x 1024) bit for bit; to HF "
        f"{t1 - t0:.3f} s, back {t2 - t1:.3f} s [{card}]")
    del params, back
    torch.cuda.empty_cache()


def phase_tooling(torch, fa, card: str) -> tuple[dict, dict]:
    """Adafactor with checkpoints and resume through the job, the LoRA
    finetune and the HF round trip, at llama-1b width and depth; the
    temporary checkpoints deleted as soon as each is checked. → (launch
    counts of the Adafactor job, of the finetune)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        adafactor = tooling_adafactor(torch, fa, card, Path(tmp))
        lora = tooling_lora(torch, fa, card, Path(tmp))
    tooling_hf_round_trip(torch, card)
    return adafactor, lora


def _leaf_names(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


HTTP_ENV = {"SERVE_MODEL": "llama-test", "SERVER_HOST": "127.0.0.1",
            "SERVER_PORT": "0", "SERVE_MAX_NEW": "32"}
# prompts of 19 and 0 bytes: widths 32 and 16 (an empty prompt is [0])
GREEDY = [{"prompt": "hello from the card", "max_tokens": 8},
          {"prompt": "", "max_tokens": 20}]
SAMPLED = {"prompt": "sample me", "max_tokens": 12, "temperature": 0.8,
           "top_p": 0.9, "seed": 7}


@contextlib.contextmanager
def serving(env: dict):
    """A warmed server on an ephemeral port, answering in a thread
    → (its ServingState, port); shut down on exit, its engine's scheduler
    (and with it the black box's tick) and its alert manager closed."""
    from tpu_kubernetes_torch.serve.server import make_server

    server = make_server(env)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    state = server.RequestHandlerClass.state
    try:
        check(state.device.type == "cuda", "the server is not on the card")
        yield state, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if state._engine is not None:
            state._engine.close()
        if state.alerts is not None:
            state.alerts.close()


def record_ids(state) -> list:
    """Keep the token ids of each completion ``state`` renders."""
    seen, inner = [], state.decode_text

    def decode_text(ids):
        seen.append(list(ids))
        return inner(ids)

    state.decode_text = decode_text
    return seen


def phase_http(torch, fa) -> dict:
    """Three completions over HTTP at the default bf16 (the serving path;
    the greedy ones through the server's CUDA graphs); then the greedy
    ones again at f32, where kernel and plain differ by summation order
    only, held token for token against a ServingState on the same weights
    whose greedy lane takes the plain lane, eagerly."""
    from tpu_kubernetes_torch.serve.server import GreedyLane

    with serving(HTTP_ENV) as (state, port):
        # -- the HTTP path: every count at 0 just before, read just after -
        reset_counts(fa)
        code, health = _request(port, "GET", "/healthz")
        check(code == 200 and health.get("status") == "ok",
              f"/healthz {code} {health}")
        for body in [*GREEDY, SAMPLED]:
            if body is SAMPLED:
                mark = read_counts(fa)["decode_attention"]
            code, out = _request(port, "POST", "/v1/completions", body)
            say(f"http /v1/completions {json.dumps(body)} -> {code} "
                f"tokens={out.get('tokens')} "
                f"finish={out.get('finish_reason')}")
            check(code == 200, f"/v1/completions {code}: {out}")
            check(out["tokens"] == body["max_tokens"],
                  f"tokens {out['tokens']} != max_tokens {body['max_tokens']}")
        counts = read_counts(fa)
        # -------------------------------------------------------------------
        # the same sampled request streamed (the lane's draw and step
        # programs) and again in full (a replay of its generate program)
        streamed, reason = sse_text(port, "/v1/completions", SAMPLED)
        code, again = _request(port, "POST", "/v1/completions", SAMPLED)
        check(code == 200 and again["text"] == out["text"],
              "a seeded sampled completion changed on its replay")
        check(streamed == out["text"] and reason == out["finish_reason"],
              f"the streamed sampled completion {streamed!r} differs from "
              f"the non-streamed {out['text']!r}")
        programs = state.greedy.programs
        sampled_keys = {k: n for k, n in programs.captures.items()
                        if k[0] in ("generate", "draw", "step")}
        check({k[0] for k in sampled_keys} == {"generate", "draw", "step"}
              and all(n == 1 for n in programs.captures.values()),
              f"http program captures {programs.captures}")
        say(f"http: the sampled request streamed == non-streamed for seed "
            f"{SAMPLED['seed']}, through the programs {sampled_keys} "
            f"(captures), replays { {k: programs.replays.get(k, 0) for k in sampled_keys} }")
    sampled = counts["decode_attention"] - mark
    say(f"http: the sampled completion (the graphed generate program) "
        f"launched the decode-attention kernel {sampled} times")
    check(sampled > 0, "the sampled lane never launched the decode-attention "
                       "kernel")
    launches = counts["flash_fwd"]
    check(launches > 0, "the HTTP requests never launched the kernel")
    check(counts["decode_attention"] > 0 and counts == want_counts(
        fwd_simt=launches, dattn_simt=counts["decode_attention"]),
          f"http launches {counts}: llama-test's head_dim 16 takes the "
          f"CUDA-core route, and decode runs the decode-attention kernel")
    say(f"http: 3 completions on the card, {launches} kernel launches")

    with serving({**HTTP_ENV, "SERVE_DTYPE": "float32"}) as (state, port):
        plain = copy.copy(state)
        plain.cfg = replace(state.cfg, use_kernel=False)
        plain.greedy = GreedyLane(state.params, plain.cfg, state.eos_id,
                                  graphs=False)
        plain._lock = threading.Lock()
        served, ref = record_ids(state), record_ids(plain)
        mark = read_counts(fa)["flash_fwd"]
        for body in GREEDY:
            code, out = _request(port, "POST", "/v1/completions", body)
            check(code == 200, f"/v1/completions f32 {code}: {out}")
        check(read_counts(fa)["flash_fwd"] > mark,
              "the f32 server never launched the kernel")
        mark = read_counts(fa)["flash_fwd"]
        for body in GREEDY:
            plain.complete(body["prompt"], body["max_tokens"])
        check(read_counts(fa)["flash_fwd"] == mark,
              "the plain lane launched the kernel")
    say(f"http f32 greedy token ids, kernel lane {served} vs plain lane "
        f"{ref}: {'identical' if served == ref else 'DIFFER'}")
    check(served == ref, "greedy HTTP completions through the kernel differ "
                         "from the plain lane's")
    return counts


# ---------------------------------------------------------------------------
# compiled programs: CUDA graphs against the same bodies run eagerly
# ---------------------------------------------------------------------------

REPEATS = 2          # timed repeats of each variant, in turns
# each kernel line entry's function in csrc/, as the profiler names it
KERNEL_FUNCTIONS = {
    "flash_fwd_tc": "flash_fwd_tc_kernel", "flash_fwd": "flash_fwd_kernel",
    "flash_bwd_dq_tc": "flash_bwd_dq_tc_kernel",
    "flash_bwd_dq": "flash_bwd_dq_kernel",
    "flash_bwd_dkv_tc": "flash_bwd_dkv_tc_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
    "gmm_tc": "gmm_tc_kernel", "gmm": "gmm_kernel",
    "gmm_drhs_tc": "gmm_drhs_tc_kernel", "gmm_drhs": "gmm_drhs_kernel",
    "adamw_sumsq": "adamw_sumsq_kernel",
    "adamw_update": "adamw_update_kernel",
    "decode_attention_tc": "decode_attention_tc_kernel",
    "decode_attention": "decode_attention_kernel",
    "decode_attention_q8": "decode_attention_q8_kernel",
    "decode_attention_tc_q8": "decode_attention_tc_q8_kernel",
    "w8_matmul": "w8_matmul_kernel",
    "w8_matmul_tc": "w8_matmul_tc_kernel",
}


def profiled_launches(by_name: dict) -> dict:
    """Launches by kernel name, as a profile saw them on the card → the
    hand-written kernels' by the names of read_counts."""
    return {MAIN_PATHS[entry][0]: sum(
        n for name, n in by_name.items() if re.search(rf"\b{fn}\b", name))
        for entry, fn in KERNEL_FUNCTIONS.items()}


# Host seconds of idle card at each edge of a replay's profile window,
# with a marker kernel (torch.cuda._sleep's spin_kernel, EDGE_SPIN cycles)
# launched just before the replay and one just after. In this script's
# main process the profiler loses a device record in a window: a train
# step's flash_fwd in every window of one run; with the markers in place,
# the marker launched first after the gap in every window, and neither
# marker in the windows of the int8 phase's own process; in later runs
# the marker and the replay's first kernel, in all three windows of the
# f32 moe-1b train step, with four markers before it as with one: every
# record in the window's first ~55 ms, whatever their number. So the
# window idles LEAD_S before the replay. The markers' records say which
# edge, if any, a window lost.
EDGE_S = 0.05
LEAD_S = 0.5
EDGE_SPIN = 100_000


def check_replay_launches(torch, fa, label: str, fn, card: str,
                          tries: int = 3) -> set:
    """Profile ``fn``, one replay of one program, up to ``tries`` times,
    every count at 0 just before and read just after each: each
    hand-written kernel's launches that the profiler saw on the card never
    exceed the counts (each capture's launches times its replays), and
    equal them in some window. Under graphs the profiler loses a kernel
    record now and then, and never adds one; a replay
    that ran fewer launches than its capture recorded falls short in
    every window. Each window idles LEAD_S before the replay and EDGE_S
    after it, between two spin_kernel markers, and reports which markers
    it kept. → the kernel names of the last window."""
    from torch.profiler import ProfilerActivity, profile

    windows = []
    for _ in range(tries):
        reset_counts(fa)
        torch.cuda.synchronize()
        with no_gc(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a kernel of the window before the replay, finished first, so
            # that the tracing runs when the replay's first kernel starts
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(LEAD_S)
            before = time.time_ns()
            torch.cuda._sleep(EDGE_SPIN)
            fn()
            torch.cuda._sleep(EDGE_SPIN)
            torch.cuda.synchronize()
            after = time.time_ns()
            time.sleep(EDGE_S)
        counts = read_counts(fa)
        by_name = {name: n for name, _, n in device_rows(prof)}
        seen = profiled_launches(by_name)
        want = {k: counts[k] for k in seen}
        check(all(seen[k] <= want[k] for k in seen),
              f"{label}: the profiler saw launches {seen} beyond the "
              f"counts {want}")
        windows.append({k: n for k, n in seen.items() if n or want[k]})
        # the markers the profiler kept: a record that starts in the first
        # half of the span from `before` to `after` is the one launched
        # before the replay; the µs from `before` to the first one's start
        # and from the last one's end to `after`, both on the host's clock
        spins = sorted((e.start_ns(), e.end_ns())
                       for e in prof.profiler.kineto_results.events()
                       if "spin_kernel" in e.name())
        middle = (before + after) / 2
        windows[-1]["markers"] = "+".join(
            "pre" if start < middle else "post" for start, _ in spins
        ) or "none"
        if spins:
            windows[-1]["edges_us"] = (
                round((spins[0][0] - before) / 1e3, 1),
                round((after - spins[-1][1]) / 1e3, 1))
        if seen == want:
            break
    check(seen == want, f"{label}: the profiler saw fewer launches than "
                        f"the counts {want} in all {tries} windows: "
                        f"{windows}")
    say(f"{label}: the profiler's launches of the hand-written kernels "
        f"equal the counts {windows[-1]} in window {len(windows)} of at "
        f"most {tries} (earlier windows {windows[:-1]}) [{card}]")
    return set(by_name)


def spread(xs) -> str:
    """min / median / max of a few runs."""
    xs = sorted(xs)
    return (f"{xs[0]:.3f} / {xs[len(xs) // 2]:.3f} / {xs[-1]:.3f} "
            f"(min / median / max of {len(xs)})")


def in_turns(rep: int) -> tuple[str, str]:
    return ("eager", "graphed") if rep % 2 == 0 else ("graphed", "eager")


def serve_run(torch, lane, rows, lengths, new: int):
    """One greedy batch through ``lane``: a prefill alone, then the whole
    request (prefill, then new - 1 steps in segments of 8 with the
    server's liveness check between them). → (tokens, prefill ms, decode
    ms/step = (request − prefill) / (new − 1))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lane.prefill(rows, lengths, rows.shape[1] + new)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, _ = lane.run(rows, lengths, [new] * rows.shape[0], new, 8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prefill_ms = (t1 - t0) * 1e3
    return out, prefill_ms, ((t2 - t1) * 1e3 - prefill_ms) / (new - 1)


def phase_graph_serve(torch, fa, card: str, name: str, cfg,
                      plain: bool = False) -> tuple[dict, set]:
    """Greedy serving at full width through the program cache
    (``serve.server.GreedyLane``): 4 ragged rows at 1024 (1024, 1000,
    777, 333), 64 tokens, CUDA graphs against the same bodies run eagerly.
    Tokens identical, each key captured once, prefill ms and decode
    ms/step of both over REPEATS turns, busy share from a profile of each,
    one replay of each program under set_sync_debug_mode("error"), the
    decode-attention kernel among the decode segment's replayed kernels.
    With ``plain``, a third, graphed lane with ``cfg.use_kernel=False``
    (no hand-written kernel: the plain f32 decode attention) runs in the
    same turns, for its decode ms/step; its tokens are reported beside the
    kernel lanes'. → (launch counts over the timed turns, kernel names of
    the replay-only window)."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane

    dev = torch.device("cuda")
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    b, width, new = 4, 1024, 64
    rows = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                         device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    lanes = {"eager": GreedyLane(params, cfg, graphs=False),
             "graphed": GreedyLane(params, cfg)}
    if plain:
        lanes["graphed plain"] = GreedyLane(params,
                                            replace(cfg, use_kernel=False))
    # the first request of each: the graphed lanes capture their keys here
    want = {v: serve_run(torch, lane, rows, lengths, new)[0]
            for v, lane in lanes.items()}
    check(want["graphed"] == want["eager"],
          f"{name}: graphed greedy tokens differ from eager")
    if plain:
        same = sum(a == b for a, b in zip(want["graphed plain"],
                                          want["graphed"]))
        first = [next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                      None)
                 for a, b in zip(want["graphed plain"], want["graphed"])]
        say(f"{name} plain-attention lane against the kernel lanes: {same} "
            f"of {b} rows identical, first divergent steps {first} (bf16 "
            f"logit near-ties; the decode step's logits are held to plain "
            f"in the serving phase)")

    # -- the serving path: every count at 0 just before, read just after -
    reset_counts(fa)
    times = {v: [] for v in lanes}
    for rep in range(REPEATS):
        for v in (list(lanes) if rep % 2 == 0 else list(reversed(lanes))):
            out, pf, dec = serve_run(torch, lanes[v], rows, lengths, new)
            check(out == want[v], f"{name}: {v} tokens moved in turn {rep}")
            times[v].append((pf, dec))
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    # both lanes, each request two prefills (flash and, in the MoE model,
    # 3 grouped products a layer) and new - 1 decode steps (grouped only)
    runs = 2 * REPEATS
    grouped = int(hasattr(cfg, "n_experts"))
    wanted = want_counts(fwd_tc=2 * runs * L,
                         gmm_tc=runs * (2 + new - 1) * 3 * L * grouped,
                         dattn_tc=runs * (new - 1) * L)
    check(counts == wanted, f"{name} graphed serving launches {counts} != "
                            f"{wanted}")
    graphed = lanes["graphed"].programs
    keys = {("prefill", b, width, width + new),
            ("decode", b, width, width + new, 8),
            ("decode", b, width, width + new, 7)}
    check(graphed.captures == {k: 1 for k in keys},
          f"{name}: captures {graphed.captures}, want each of {keys} once")
    say(f"{name} greedy 4x1024 ragged, {new} tokens, graphed == eager tokens "
        f"in all {1 + REPEATS} turns; captures {graphed.captures}, replays "
        f"{graphed.replays}; launches {counts}")
    for v in lanes:
        say(f"{name} {v}: prefill ms {spread([t[0] for t in times[v]])}; "
            f"decode ms/step {spread([t[1] for t in times[v]])} [{card}]")
    prof = {v: profile_window(torch, f"{name} {v} greedy request 4x1024 + "
                                     f"{new - 1} steps",
                              lambda v=v: lanes[v].run(
                                  rows, lengths, [new] * b, new, 8), card)
            for v in ("eager", "graphed")}

    # one replay of each program with every synchronising call an error
    st = lanes["graphed"].slots(b, width, width + new)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lanes["graphed"].prefill(rows, lengths, width + new)
        lanes["graphed"].decode(st, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"{name}: a prefill and a decode-segment replay ran under "
        f"set_sync_debug_mode('error')")
    lane = lanes["graphed"]
    check_replay_launches(torch, fa, f"{name} prefill replay",
                          lambda: lane.prefill(rows, lengths, width + new),
                          card)
    names = check_replay_launches(torch, fa, f"{name} decode-segment replay",
                                  lambda: lane.decode(st, 8), card)
    check(any(re.search(r"\bdecode_attention_tc_kernel\b", n)
              for n in names),
          f"{name}: decode_attention_tc_kernel not seen in a replay-only "
          f"profile of a decode segment")
    say(f"{name}: decode_attention_tc_kernel seen in a replay-only profile "
        f"of the solo lane's decode segment")
    del lanes, lane, params, st
    torch.cuda.empty_cache()
    return counts, prof["graphed"]["names"]


# ---------------------------------------------------------------------------
# the sampled lane: sampled generate, the streamed loop, the eval step
# ---------------------------------------------------------------------------

SAMPLE_KNOBS = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
SAMPLE_SEED = 7
# the sampler's own kernels in a profile, by the names torch gives them
SAMPLER_KERNELS = {"sort": r"[Ss]ort", "softmax": r"[Ss]oft[Mm]ax",
                   "cumsum": r"[Ss]can", "uniform draw": r"distribution",
                   "log": r"\blog_kernel", "argmax": r"ArgMax|argmax"}


def timed(torch, fn) -> tuple[object, float]:
    """(fn()'s result, its wall ms on the host clock, the device finished)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sampler_rows(label: str, prof: dict, steps: int, card: str) -> None:
    """The sampler's kernels: by kind, the ms and count of a profile of the
    sampled generate program less those of the greedy one (the same
    program without the sampler; at an MoE model the router's sorts and
    softmax sit in both), and per decode step."""
    def kind_ms(p, pattern):
        rows = [r for r in p["rows"] if re.search(pattern, r[0])]
        return sum(r[1] for r in rows), sum(r[2] for r in rows), rows

    total = 0.0
    for kind, pattern in SAMPLER_KERNELS.items():
        ms_s, n_s, rows = kind_ms(prof["sampled"], pattern)
        ms_g, n_g, _ = kind_ms(prof["greedy"], pattern)
        total += ms_s - ms_g
        say(f"{label} sampler kernels, {kind}: {ms_s - ms_g:.3f} ms "
            f"(sampled {ms_s:.3f} x{n_s} less greedy {ms_g:.3f} x{n_g}), "
            f"{(ms_s - ms_g) / steps * 1e3:.1f} us a step: "
            + "; ".join(f"{r[0][:60]} {r[1]:.3f}" for r in rows[:2])
            + f" [{card}]")
    diff = prof["sampled"]["kernel_ms"] - prof["greedy"]["kernel_ms"]
    say(f"{label} sampler: all kernels of the sampled program less the "
        f"greedy one's {diff:.3f} ms ({diff / steps * 1e3:.1f} us a step), "
        f"the kinds above {total:.3f} ms [{card}]")


def top1_ties(torch, params, cfg, rows, lengths, span: int, greedy: list,
              top1: list) -> list:
    """top_k = 1 keeps every token tied at the maximum logit and the draw
    picks among them, where greedy takes the first: the two may part only
    at an exact tie. Each row's first divergent step is held to the greedy
    run's logits there, recomputed eagerly (the greedy and the top_k = 1
    token both at the maximum). → the (row, step) of each divergence."""
    from tpu_kubernetes_torch.models.decode import decode_step, prefill

    firsts = {}
    for i, (a, g) in enumerate(zip(top1, greedy)):
        step = next((t for t, (x, y) in enumerate(zip(a, g)) if x != y),
                    None)
        if step is not None:
            firsts[i] = step
    if not firsts:
        return []
    logits, cache = prefill(params, rows, cfg, max_seq=span, lengths=lengths)
    for step in range(max(firsts.values()) + 1):
        if step:
            logits, cache = decode_step(params, cache, torch.tensor(
                [g[step - 1] for g in greedy], dtype=torch.int32,
                device=rows.device), cfg)
        for i, t in firsts.items():
            if t == step:
                row = logits[i]
                hi = row.max()
                check(bool(row[greedy[i][t]] == hi and row[top1[i][t]] == hi),
                      f"top_k=1 parts from greedy at row {i} step {t} "
                      f"without a tie: logits {row[greedy[i][t]].item()} "
                      f"(greedy) {row[top1[i][t]].item()} (top_k=1), max "
                      f"{hi.item()}")
    return sorted(firsts.items())


def phase_sampled_serve(torch, fa, card: str, name: str, cfg, new: int,
                        stream: bool = False) -> tuple[dict, set]:
    """The sampled lane at full width and depth (``serve.server``
    ``SampledLane``): 4 prompts padded to 1024 (1024, 1000, 777, 333
    real), ``new`` tokens at temperature 0.8, top_k 50, top_p 0.9, seed 7,
    through the graphed generate program against the same body run
    eagerly. Graphed tokens equal the eager ones at the first call and at
    a later replay, another seed draws others, top_k = 1 gives the greedy
    lane's tokens up to exact ties of the greedy logits (``top1_ties``);
    decode ms/step eager, sampled graphed and greedy
    graphed in turns, with every count at 0 just before and read just
    after; captures 1 per key; one replay-only profile of the generate
    program holds ``flash_fwd_tc`` and ``decode_attention_tc`` (and
    ``gmm_tc`` for an MoE model) and, against one of the greedy generate
    program, the sampler's kernels by kind; the sampler alone is timed in
    a graph of back-to-back calls. With
    ``stream``, the lane's token loop (prefill, draw, one step replay and
    one int read back a token) greedy and sampled against the generate
    program's tokens, ms per token beside the decode step. → (launch
    counts of the turns, kernel names of the replay-only profile)."""
    from tpu_kubernetes_torch.models import (
        init_params,
        sample_tokens,
        sampling_knobs,
    )
    from tpu_kubernetes_torch.serve.server import (
        GreedyLane,
        SampledLane,
        _pad_rows,
    )

    dev = torch.device("cuda")
    L = cfg.n_layers
    grouped = int(hasattr(cfg, "n_experts"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    b, width = 4, 1024
    span = width + new
    rows = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                         device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    eager = SampledLane(GreedyLane(params, cfg, graphs=False))
    graphed = SampledLane(GreedyLane(params, cfg))
    knobs = SAMPLE_KNOBS

    def sampled(lane, seed=SAMPLE_SEED, **kw):
        return lane.generate(rows, lengths, new, span, seed=seed,
                             **{**knobs, **kw})

    def greedy():
        # the same program form at the greedy variant: no sampler
        return graphed.generate(rows, lengths, new, span)

    want = sampled(eager)
    first = sampled(graphed)                       # the warm-up + capture
    check(torch.equal(first, want), f"{name}: the graphed sampled tokens "
                                    f"of the first call differ from eager")
    later = sampled(graphed)
    check(torch.equal(later, want), f"{name}: a replay's sampled tokens "
                                    f"differ from eager")
    other = sampled(graphed, seed=SAMPLE_SEED + 1)
    check(not torch.equal(other, want), f"{name}: seeds 7 and 8 drew the "
                                        f"same tokens")
    top1 = sampled(graphed, top_k=1)
    # the greedy lane's tokens (segments of 8 steps), the greedy program's
    lane_tokens, _ = graphed.greedy.run(rows, lengths, [new] * b, new, 8)
    greedy_tokens = greedy()
    check(greedy_tokens.tolist() == lane_tokens,
          f"{name}: the greedy generate program's tokens differ from the "
          f"greedy lane's")
    ties = top1_ties(torch, params, cfg, rows, lengths, span, lane_tokens,
                     top1.tolist())
    say(f"{name} sampled 4x1024 ragged, {new} tokens, {knobs}, seed "
        f"{SAMPLE_SEED}: graphed == eager at the first call and a replay; "
        f"seed {SAMPLE_SEED + 1} differs in "
        f"{int((other != want).sum())} of {want.numel()} tokens; the greedy "
        f"program == the greedy lane; top_k=1 == the greedy lane in "
        f"{b - len(ties)} of {b} rows, the others parting first at an exact "
        f"tie of the greedy logits' maximum (row, step): {ties}")
    graphed.greedy.prefill(rows, lengths, span)    # captured before timing

    # -- the sampled path: every count at 0 just before, read just after -
    reset_counts(fa)
    prefills = steps = 0
    runs = {"eager": (eager, lambda: sampled(eager), want),
            "sampled graphed": (graphed, lambda: sampled(graphed), want),
            "greedy graphed": (graphed, greedy, greedy_tokens)}
    times = {v: [] for v in runs}
    for rep in range(REPEATS):
        for v in (list(runs) if rep % 2 == 0 else list(reversed(runs))):
            # the prefill alone (the greedy lane's program at the same
            # shape), then the whole request: its prefill and new - 1 steps
            lane, request, tokens = runs[v]
            _, pf = timed(torch, lambda: lane.greedy.prefill(rows, lengths,
                                                             span))
            out, req = timed(torch, request)
            prefills += 2
            steps += new - 1
            check(torch.equal(out, tokens),
                  f"{name}: {v} tokens moved in turn {rep}")
            times[v].append((pf, (req - pf) / (new - 1)))
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    wanted = want_counts(fwd_tc=prefills * L, dattn_tc=steps * L,
                         gmm_tc=(prefills + steps) * 3 * L * grouped)
    check(counts == wanted, f"{name} sampled serving launches {counts} != "
                            f"{wanted}")
    key = ("generate", b, width, span, new, "sample+top_k+top_p")
    captured = graphed.programs.captures
    check(captured.get(key) == 1 and all(n == 1 for n in captured.values()),
          f"{name}: captures {captured}, want each key once")
    say(f"{name} sampled lane: captures {captured}, replays "
        f"{graphed.programs.replays}; launches {counts}")
    for v, ts in times.items():
        say(f"{name} {v}: prefill ms {spread([t[0] for t in ts])}; decode "
            f"ms/step {spread([t[1] for t in ts])} [{card}]")

    lane = graphed
    names = check_replay_launches(
        torch, fa, f"{name} sampled generate replay",
        lambda: sampled(lane), card)
    prof = {v: profile_window(torch, f"{name} {v} generate replay 4x1024 + "
                                     f"{new - 1} steps", fn, card)
            for v, fn in (("sampled", lambda: sampled(lane)),
                          ("greedy", greedy))}
    sampler_rows(name, prof, new - 1, card)
    # the sampler alone on the last prefill's logits, device time per call
    # from a graph of back-to-back calls (the default generator draws)
    logits = graphed.greedy.slots(b, width, span).logits.clone()
    values = sampling_knobs(*SAMPLE_KNOBS.values(), device=dev)
    alone = {v: graph_ms(torch, lambda v=v: sample_tokens(logits, values, v),
                         50) for v in ("sample+top_k+top_p", "greedy")}
    say(f"{name} sampler alone on {b} x {cfg.vocab_size} f32 logits, a CUDA "
        f"graph of 50 calls: sampled (top_k + top_p) "
        f"{alone['sample+top_k+top_p']:.4f} ms a call, greedy argmax "
        f"{alone['greedy']:.4f} ms; the difference "
        f"{alone['sample+top_k+top_p'] - alone['greedy']:.4f} ms a decode "
        f"step [{card}]")
    wanted_names = ["flash_fwd_tc_kernel", "decode_attention_tc_kernel"]
    wanted_names += ["gmm_tc_kernel"] * grouped
    for fn in wanted_names:
        check(any(re.search(rf"\b{fn}\b", n)
                  for n in prof["sampled"]["names"]),
              f"{name}: {fn} not seen in the sampled generate replay's "
              f"profile")
    say(f"{name}: {', '.join(wanted_names)} seen in a replay-only profile "
        f"of the sampled generate program")

    if stream:
        ids = rows[1, :1000].tolist()
        one = _pad_rows([ids], width)
        one_len = torch.tensor([1000], dtype=torch.int32)
        for label, kw in (("greedy", {"temperature": 0.0, "top_k": 0,
                                      "top_p": 0.0}), ("sampled", {})):
            ref = lane.generate(one, one_len, new, span, seed=SAMPLE_SEED,
                                **{**knobs, **kw})[0].tolist()
            per_token, req_ms, pf_ms = [], [], []
            # the first run builds and captures the draw and step programs
            for rep in range(1 + REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = []
                for t in lane.stream(ids, width, span, seed=SAMPLE_SEED,
                                     **{**knobs, **kw}):
                    got.append(t)
                    if len(got) == 1:
                        t1 = time.perf_counter()
                    if len(got) == new:
                        break
                t2 = time.perf_counter()
                check(got == ref, f"{name} {label} stream differs from the "
                                  f"generate program's tokens")
                if not rep:
                    continue
                per_token.append((t2 - t1) * 1e3 / (new - 1))
                _, pf = timed(torch, lambda: lane.greedy.prefill(
                    one, one_len, span))
                _, req = timed(torch, lambda: lane.generate(
                    one, one_len, new, span, seed=SAMPLE_SEED,
                    **{**knobs, **kw}))
                pf_ms.append(pf)
                req_ms.append((req - pf) / (new - 1))
            say(f"{name} {label} stream, 1 row of 1000 at width 1024, {new} "
                f"tokens == the generate program's: ms per token (one step "
                f"replay + one int read back) {spread(per_token)}; the "
                f"generate program's decode ms/step at 1 row "
                f"{spread(req_ms)} (prefill {spread(pf_ms)}) [{card}]")
        check(all(n == 1 for n in lane.programs.captures.values()),
              f"{name}: stream captures {lane.programs.captures}")
        say(f"{name} stream programs: captures "
            f"{_stream_keys(lane.programs.captures)}, replays "
            f"{_stream_keys(lane.programs.replays)}")
    del eager, graphed, greedy, lane, params
    torch.cuda.empty_cache()
    return counts, names


def _stream_keys(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if k[0] in ("draw", "step")}


EVAL_SHAPE = (4, 2049)     # llama-1b eval: 4 rows × 2048 positions
EVAL_TOL = 1e-6            # relative, graphed against eager


def phase_eval(torch, fa, card: str) -> dict:
    """The eval step (``train.trainer.make_eval_step``) at llama-1b, 4 ×
    2048, graphed against the same body run eagerly on the same params
    and batch, in turns: losses within 1e-6 relative, ms each, the flash
    forward once a layer a call. → launch counts."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.train import make_eval_step

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    gen = torch.Generator(device=dev).manual_seed(4)
    params = init_params(cfg, gen, dev)
    batch = torch.randint(0, cfg.vocab_size, EVAL_SHAPE, generator=gen,
                          device=dev, dtype=torch.int32)
    steps = {"eager": make_eval_step(cfg, params, EVAL_SHAPE, graphs=False),
             "graphed": make_eval_step(cfg, params, EVAL_SHAPE)}
    want = steps["eager"](batch).item()
    reset_counts(fa)
    losses = {v: [] for v in steps}
    times = {v: [] for v in steps}
    for rep in range(REPEATS + 1):
        for v in in_turns(rep):
            loss, ms = timed(torch, lambda: steps[v](batch).item())
            losses[v].append(loss)
            if rep:                  # the first turn builds and captures
                times[v].append(ms)
    counts = read_counts(fa)
    runs = 2 * (REPEATS + 1)
    check(counts == want_counts(fwd_tc=runs * cfg.n_layers),
          f"llama-1b eval launches {counts}")
    rel = max(abs(x - want) / abs(want) for v in losses for x in losses[v])
    say(f"llama-1b eval step 4x2048: loss {want:.6f}, graphed against eager "
        f"rel {rel:.3e} (tol {EVAL_TOL:.0e}); captures "
        f"{steps['graphed'].program.captures}, replays "
        f"{steps['graphed'].program.replays}")
    check(math.isfinite(want) and rel <= EVAL_TOL,
          "llama-1b eval losses graphed against eager")
    for v in steps:
        say(f"llama-1b eval step {v}: ms {spread(times[v])} [{card}]")
    del steps, params, batch
    torch.cuda.empty_cache()
    return counts


SERVE_JOB_PROMPTS = ["hello from the card", "a", "the quick brown fox",
                     "batch inference", "eleven prompts in three batches",
                     "x" * 40, "tokens", "sample me", "padded with repeats",
                     "the last batch", "ends here"]
SERVE_JOB_ENV = {"SERVE_MODEL": "llama-test", "SERVE_DTYPE": "float32",
                 "SERVE_BATCH": "4", "SERVE_MAX_NEW": "16"}


def run_serving_logged(job, env: dict) -> tuple[list, dict, dict]:
    """``run_serving(env)`` → (completions, captures, replays) read from
    its log line; its stderr is echoed."""
    import ast
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = job.run_serving(env)
    sys.stderr.write(err.getvalue())
    line = re.search(r"(?:generate program|speculative programs): "
                     r"captures (\{.*\}), replays (\{.*\})",
                     err.getvalue())
    check(bool(line) and "tok/s" in err.getvalue(),
          "run_serving logged no program counts or tokens/s")
    return out, ast.literal_eval(line.group(1)), ast.literal_eval(
        line.group(2))


def phase_serve_job(torch, fa, card: str) -> dict:
    """The batch inference job (``serve.job.run_serving``) on the card at
    llama-test in f32: 11 prompts, SERVE_BATCH=4 (3 batches, the last
    padded), 16 new tokens; greedy completions identical to the HTTP solo
    lane's for the same prompts, sampled (temperature 0.8, top_p 0.9)
    identical across two runs with one SERVE_SEED; one capture and two
    replays a run. → the greedy run's launch counts."""
    import tempfile

    from tpu_kubernetes_torch.serve import job

    with tempfile.TemporaryDirectory() as tmp:
        prompts = Path(tmp) / "prompts.txt"
        prompts.write_text("\n".join(SERVE_JOB_PROMPTS) + "\n")
        env = {**SERVE_JOB_ENV, "SERVE_PROMPTS": str(prompts),
               "SERVE_OUT": str(Path(tmp) / "greedy.txt")}
        # -- the job's path: every count at 0 just before, read just after
        reset_counts(fa)
        greedy, caps, reps = run_serving_logged(job, env)
        counts = read_counts(fa)
        # ---------------------------------------------------------------
        check(len(greedy) == len(SERVE_JOB_PROMPTS),
              f"run_serving returned {len(greedy)} completions")
        check(list(caps.values()) == [1] and list(reps.values()) == [2],
              f"run_serving captures {caps}, replays {reps}: want one "
              f"capture and two replays")
        check(counts["flash_fwd"] > 0 and counts == want_counts(
            fwd_simt=counts["flash_fwd"],
            dattn_simt=counts["decode_attention"]),
              f"run_serving launches {counts}")
        sampled = []
        for run in range(2):
            out, scaps, sreps = run_serving_logged(job, {
                **env, "SERVE_TEMPERATURE": "0.8", "SERVE_TOP_P": "0.9",
                "SERVE_SEED": "7", "SERVE_OUT": str(Path(tmp) / f"s{run}")})
            check(list(scaps.values()) == [1] and list(sreps.values()) == [2],
                  f"sampled run_serving captures {scaps}, replays {sreps}")
            sampled.append((out, (Path(tmp) / f"s{run}").read_bytes()))
        check(sampled[0] == sampled[1], "sampled run_serving differs across "
                                        "two runs with one SERVE_SEED")
        check(sampled[0][0] != greedy, "sampled run_serving equals greedy")
    with serving({**HTTP_ENV, "SERVE_DTYPE": "float32"}) as (state, port):
        solo = []
        for p in SERVE_JOB_PROMPTS:
            code, out = _request(port, "POST", "/v1/completions",
                                 {"prompt": p, "max_tokens": 16})
            check(code == 200, f"/v1/completions {code}: {out}")
            solo.append(out["text"])
    same = sum(a == b for a, b in zip(greedy, solo))
    say(f"run_serving llama-test f32, {len(SERVE_JOB_PROMPTS)} prompts in 3 "
        f"batches of 4: greedy == the HTTP solo lane's for {same} of "
        f"{len(solo)}; sampled identical across two runs with SERVE_SEED=7; "
        f"captures {caps} replays {reps}; launches {counts} [{card}]")
    check(same == len(solo), "run_serving's greedy completions differ from "
                             "the HTTP solo lane's")
    return counts


# ---------------------------------------------------------------------------
# the continuous slot engine: graphed against eager, against solo
# ---------------------------------------------------------------------------

ENGINE_SLOTS = 8
ENGINE_STEPS = 8
ENGINE_TURNS = 2     # counted turns of each variant, in turns
# prompt lengths over the 16-512 buckets (a 2,048 max_seq leaves room for
# every budget)
ENGINE_LENGTHS = (16, 23, 40, 64, 100, 128, 200, 256, 300, 400, 512, 9, 33,
                  77, 150, 480)


def engine_requests(torch, cfg, n: int, seed: int) -> list:
    """``n`` requests of random token ids from a seed: prompt lengths over
    the 16-512 buckets, budgets of 8-64 → [(ids, budget)]."""
    g = torch.Generator().manual_seed(seed)
    budgets = torch.randint(8, 65, (n,), generator=g).tolist()
    return [(torch.randint(1, cfg.vocab_size, (ENGINE_LENGTHS[i],),
                           generator=g).tolist(), budgets[i])
            for i in range(n)]


def engine_turn(eng, requests, gap_s: float = 0.003) -> tuple[list, float]:
    """Submit every request from its own thread, request i after i × gap,
    so rows are admitted mid-decode and slots recycled; → (each request's
    tokens, wall seconds from the first submission to the last result)."""
    entries = [None] * len(requests)

    def submit(i):
        time.sleep(i * gap_s)
        entries[i] = eng.enqueue(*requests[i])

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(all(e is not None and e["event"].wait(300) for e in entries),
          "an engine request never finished")
    wall = time.perf_counter() - t0
    for e in entries:
        check(e["error"] is None, f"engine request failed: {e['error']!r}")
    return [e["tokens"] for e in entries], wall


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def solo_shape(ids: list, budget: int) -> tuple[int, int]:
    """The solo path's (width bucket, run budget) of a request."""
    from tpu_kubernetes_torch.serve.server import _bucket

    return _bucket(len(ids)), _bucket(budget, lo=8)


def solo_logits(torch, params, cfg, ids: list, budget: int, tokens: list,
                step: int, kv_quant: bool = False):
    """The logits of the solo greedy run of ``ids`` at output step ``step``
    (0: the prefill's), eagerly, at the solo path's span (an int8 cache
    with ``kv_quant``)."""
    from tpu_kubernetes_torch.models.decode import decode_step, prefill

    dev = params["embed"].device
    width, run = solo_shape(ids, budget)
    rows = torch.zeros((1, width), dtype=torch.int32, device=dev)
    rows[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32, device=dev)
    logits, cache = prefill(params, rows, cfg, max_seq=width + run,
                            lengths=torch.tensor([len(ids)],
                                                 dtype=torch.int32,
                                                 device=dev),
                            kv_quant=kv_quant)
    for t in range(step):
        logits, cache = decode_step(
            params, cache, torch.tensor([tokens[t]], dtype=torch.int32,
                                        device=dev), cfg)
    return logits[0]


def near_tie_divergences(torch, params, cfg, label: str, requests, got,
                         solo, memo: dict | None = None,
                         kv_quant: bool = False) -> int:
    """Hold each request's tokens to its solo run's: where they differ, the
    first divergent step must be a near-tie of the solo run (its top-2
    logit gap within 2 bf16 ulps of the logit). Prints every divergence
    and its gap → how many requests diverged. ``memo`` keeps the solo
    runs' top-2 logits by (request, step) across calls."""
    diverged = 0
    memo = {} if memo is None else memo
    for i, ((ids, budget), a, b) in enumerate(zip(requests, got, solo)):
        if a == b:
            continue
        diverged += 1
        step = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        key = (tuple(ids), tuple(b[:step + 1]))
        if key not in memo:
            memo[key] = solo_logits(torch, params, cfg, ids, budget, b,
                                    step, kv_quant).topk(2).values.tolist()
        hi, lo = memo[key]
        gap, ulps = hi - lo, 2 * bf16_ulp(hi)
        say(f"{label} request {i} (prompt {len(ids)}, budget {budget}) "
            f"diverges from solo at step {step}: engine {a[step:step + 1]} "
            f"solo {b[step:step + 1]}, solo top-2 logits {hi:.6g} / "
            f"{lo:.6g}, gap {gap:.3g} (2 bf16 ulps {ulps:.3g})")
        check(gap <= ulps, f"{label} request {i}: a divergence from solo "
                           f"that is not a near-tie (gap {gap} > {ulps})")
    return diverged


# llama-1b's tight pools: 160 pages of 1 MiB, and the floor of one
# full-span row, 128 pages, where admissions may stall and top-ups preempt
TIGHT_POOLS_MB = {"tight": 160, "floor": 128}


def engine_replays(torch, fa, name: str, eng, ids: list, card: str,
                   kernels: set) -> set:
    """With ``eng`` idle: a segment replay under set_sync_debug_mode
    ("error"), then the hand-written launches of a segment and a prefill
    replay as the profiler sees them against the counts, and ``kernels``
    in that replay-only profile. → the profile's kernel names."""
    rows = torch.tensor([ids], dtype=torch.int32)
    lengths = torch.tensor([len(ids)], dtype=torch.int32)

    def replays():
        eng.launch_segment()
        eng.lane.prefill(rows, lengths, len(ids))

    with eng._lock:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.launch_segment()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        say(f"{name}: a segment replay ran under "
            f"set_sync_debug_mode('error')")
        names = check_replay_launches(
            torch, fa, f"{name} segment and prefill replays", replays, card)
    seen = {k for k in kernels if any(re.search(rf"\b{k}\b", n)
                                      for n in names)}
    say(f"{name}: {sorted(seen)} seen in replay-only profiles of a segment "
        f"and a prefill")
    check(seen == kernels, f"{name}: {sorted(kernels - seen)} not seen in a "
                           f"replay-only profile")
    return names


def phase_engine(torch, fa, card: str, name: str, cfg, n: int,
                 extra: bool = False) -> tuple[dict, dict, set]:
    """The continuous slot engine at full width and depth (bf16, 8 slots,
    segments of 8): ``n`` requests submitted from threads through the
    eager, the graphed and the graphed paged engine (a pool as large as
    the dense cache, pages of DECODE_PAGE) in turns, all with identical
    tokens; each request against the solo greedy lane (equal, or
    diverging first at a printed near-tie); requests/s and tokens/s of
    the engines and of the same requests one at a time through the solo
    lane; ms a segment; the busy share of a profile of engine traffic; the
    mean slot occupancy; the pool's stalls and preemptions, its pages
    conserved; for each graphed engine a segment replay under
    set_sync_debug_mode("error"), whose hand-written launches the profiler
    must count as captured, and the prefill's and the segment's kernels
    (the decode-attention kernel among them) in replay-only profiles.
    With ``extra`` (llama-1b), in the same turns, a graphed engine with
    ``cfg.use_kernel=False`` (the plain f32 decode attention; its
    divergences from the kernel engine only at printed near-ties) and
    paged engines of the TIGHT_POOLS_MB, where admissions may stall and a
    top-up that finds the pool dry preempts a row (identical tokens).
    → (launch counts over the counted turns of the dense engines, those
    of the paged engines, kernel names of the replay-only windows)."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    dev = torch.device("cuda")
    L = cfg.n_layers
    t_phase = [("start", time.perf_counter())]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    requests = engine_requests(torch, cfg, n, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    max_pages = cfg.max_seq // DECODE_PAGE
    pool_mb = ENGINE_SLOTS * max_pages * page_bytes(cfg, DECODE_PAGE) / 2 ** 20

    def engine(c=cfg, graphs=True, mb=0.0):
        return ContinuousEngine(GreedyLane(params, c, graphs=graphs),
                                slots=ENGINE_SLOTS, seg_steps=ENGINE_STEPS,
                                pool_mb=mb, page_size=DECODE_PAGE)

    engines = {"eager": engine(graphs=False), "graphed": engine(),
               "paged": engine(mb=pool_mb)}
    if extra:
        engines["plain"] = engine(c=replace(cfg, use_kernel=False))
        engines.update({v: engine(mb=mb) for v, mb in TIGHT_POOLS_MB.items()})
    paged = [v for v, e in engines.items() if e.paged]
    cache_gib = (engines["graphed"]._cache.k.numel() * 2
                 * engines["graphed"]._cache.k.element_size() / 2 ** 30)
    pool_gib = {v: engines[v]._pool.k.numel() * 2
                * engines[v]._pool.k.element_size() / 2 ** 30 for v in paged}
    seg_ms = {v: [] for v in engines}

    def timed(eng, v):
        inner = eng._run_segment

        def run():
            before = eng.segments
            t0 = time.perf_counter()
            inner()
            if eng.segments > before:
                seg_ms[v].append((time.perf_counter() - t0) * 1e3)
        eng._run_segment = run       # the scheduler calls it by attribute

    for v, eng in engines.items():
        eng.warm()
        timed(eng, v)
    # the first turn of each: the graphed engines capture their widths here
    first = {}
    for v, eng in engines.items():
        first[v], _ = engine_turn(eng, requests)
        wait_idle(eng)
    want = first["graphed"]
    for v in engines:
        if v != "plain":
            check(first[v] == want, f"{name} engine: {v} tokens differ from "
                                    f"graphed")
    t_phase.append(("set-up and first turns", time.perf_counter()))
    for v in seg_ms:
        seg_ms[v].clear()

    # -- the engine paths: every count at 0 just before, read just after --
    # (the dense engines' turns and the paged engines' turns, in turns)
    walls = {v: [] for v in engines}
    turn_ms = {v: [] for v in engines}
    marks = {v: (e.segments, e.live_steps, e.preemptions if e.paged else 0)
             for v, e in engines.items()}
    totals = {"dense": {}, "paged": {}}
    for rep in range(ENGINE_TURNS):
        for v in (list(engines) if rep % 2 == 0
                  else list(reversed(engines))):
            kind = "paged" if v in paged else "dense"
            reset_counts(fa)
            got, wall = engine_turn(engines[v], requests)
            wait_idle(engines[v])
            for k, c in read_counts(fa).items():
                totals[kind][k] = totals[kind].get(k, 0) + c
            if v == "plain":
                first["plain"] = got
            else:
                check(got == want, f"{name} engine: {v} tokens moved in turn "
                                   f"{rep}")
            walls[v].append(wall)
            turn_ms[v].append(sorted(seg_ms[v])[len(seg_ms[v]) // 2])
            seg_ms[v].clear()
    # -----------------------------------------------------------------------
    t_phase.append(("counted turns", time.perf_counter()))
    grouped = int(hasattr(cfg, "n_experts"))
    for kind, counts in totals.items():
        launching = [v for v in engines if v != "plain"
                     and (v in paged) == (kind == "paged")]
        steps_run = sum(engines[v].segments - marks[v][0]
                        for v in launching) * ENGINE_STEPS
        prefills = sum(ENGINE_TURNS * len(requests) + (
            engines[v].preemptions - marks[v][2] if engines[v].paged else 0)
            for v in launching)
        wanted = want_counts(fwd_tc=prefills * L,
                             gmm_tc=3 * L * (prefills + steps_run) * grouped,
                             dattn_tc=L * steps_run)
        check(counts == wanted, f"{name} {kind} engines' launches {counts} "
                                f"!= {wanted}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    eng = engines["graphed"]
    out_tokens = sum(len(t) for t in want)
    for v, e in engines.items():
        check(set(e.lane.programs.captures.values()) <= {1},
              f"{name} {v} engine: captures {e.lane.programs.captures}")
    say(f"{name} engine, {n} requests (prompts {min(ENGINE_LENGTHS[:n])}-"
        f"{max(ENGINE_LENGTHS[:n])}, budgets {min(b for _, b in requests)}-"
        f"{max(b for _, b in requests)}, {out_tokens} tokens), "
        f"{ENGINE_SLOTS} slots x {ENGINE_STEPS} steps: {sorted(engines)}; "
        f"eager, graphed and paged tokens identical in all "
        f"{1 + ENGINE_TURNS} turns; launches dense {totals['dense']}, "
        f"paged {totals['paged']}")
    for v, e in engines.items():
        med = sorted(walls[v])[len(walls[v]) // 2]
        segs = e.segments - marks[v][0]
        occupancy = ((e.live_steps - marks[v][1])
                     / (segs * ENGINE_STEPS * ENGINE_SLOTS))
        say(f"{name} engine {v}: wall s {spread(walls[v])}; "
            f"{n / med:.3f} requests/s, {out_tokens / med:.1f} tokens/s "
            f"(median turn); ms a segment, each turn's median "
            f"{spread(turn_ms[v])}; mean slot occupancy {occupancy:.3f} "
            f"over {segs} segments [{card}]")
    for v in paged:
        pages = engines[v].stats()["pages"]
        check(pages["free"] == pages["total"] and pages["live"] == 0,
              f"{name} {v} engine: pages not conserved {pages}")
        say(f"{name} engine {v}: pool {pool_gib[v]:.3f} GiB "
            f"({pages['total']} pages of {DECODE_PAGE} positions), "
            f"{pages['stalls']} stalls, {pages['preemptions']} preemptions; "
            f"all {pages['total']} pages free after the turns [{card}]")
    say(f"{name} engine: dense cache {cache_gib:.3f} GiB, device memory peak "
        f"above the weights {peak:.3f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB [{card}]")
    # a step of the plain lane reads the bf16 cache once, writes its f32
    # copy (twice the bytes) and reads that back, and reads the weights
    cache_bytes = (2 * L * ENGINE_SLOTS * cfg.n_kv_heads * cfg.max_seq
                   * cfg.head_dim * 2)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in tree_leaves(params))
    for v in engines:
        step_ms = sorted(turn_ms[v])[len(turn_ms[v]) // 2] / ENGINE_STEPS
        say(f"{name} engine {v} step: {step_ms:.3f} ms (segment median / "
            f"{ENGINE_STEPS}) [{card}]")
    say(f"{name} engine step bounds: reading the whole bf16 cache once and "
        f"the weights {(cache_bytes + weight_bytes) / HBM_BYTES_S * 1e3:.3f} "
        f"ms; the plain attention's f32 copy besides "
        f"{(5 * cache_bytes + weight_bytes) / HBM_BYTES_S * 1e3:.3f} ms "
        f"(bf16 cache {cache_bytes / 1e9:.3f} GB, weights "
        f"{weight_bytes / 1e9:.3f} GB) [{card}]")
    if extra:
        diverged = near_tie_divergences(
            torch, params, replace(cfg, use_kernel=False),
            f"{name} plain engine", requests, first["plain"], want)
        say(f"{name} plain-attention engine against the kernel engine: "
            f"{n - diverged} of {n} requests identical, {diverged} diverging "
            f"at a near-tie")

    # the same requests one at a time through the solo greedy lane: the
    # first pass captures its keys and gives the tokens, the second is timed
    lane = GreedyLane(params, cfg)

    def solo_pass():
        out = []
        for ids, budget in requests:
            width, run = solo_shape(ids, budget)
            rows = torch.zeros((1, width), dtype=torch.int32)
            rows[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
            toks, _ = lane.run(rows, torch.tensor([len(ids)],
                                                  dtype=torch.int32),
                               [budget], run, ENGINE_STEPS)
            out.append(toks[0][:budget])
        return out

    solo = solo_pass()
    torch.cuda.synchronize()
    t_phase.append(("solo lane's captures", time.perf_counter()))
    t0 = time.perf_counter()
    check(solo_pass() == solo, f"{name}: the solo lane's tokens moved")
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    say(f"{name} solo lane, the same {n} requests one at a time: "
        f"{solo_s:.3f} s, {n / solo_s:.3f} requests/s, "
        f"{out_tokens / solo_s:.1f} tokens/s [{card}]")
    diverged = near_tie_divergences(torch, params, cfg, f"{name} engine",
                                    requests, want, solo)
    say(f"{name} engine against solo: {n - diverged} of {n} requests "
        f"identical, {diverged} diverging at a near-tie")
    t_phase.append(("solo timing and near-ties", time.perf_counter()))

    prof = profile_window(torch, f"{name} engine traffic ({n} requests)",
                          lambda: engine_turn(eng, requests), card)
    say(f"{name} engine: busy share of engine traffic {prof['busy']}")
    # with each graphed engine idle: its replays, its kernels
    kernels = {"flash_fwd_tc_kernel", "decode_attention_tc_kernel"} | (
        {"gmm_tc_kernel"} if grouped else set())
    names = set()
    for v in ("graphed", "paged"):
        wait_idle(engines[v])
        names |= engine_replays(torch, fa, f"{name} {v} engine",
                                engines[v], requests[0][0], card, kernels)
    for e in engines.values():
        e.close()
    del engines, eng, lane, params
    torch.cuda.empty_cache()
    t_phase.append(("profiles and replay checks", time.perf_counter()))
    say(f"{name} engine phase seconds: " + ", ".join(
        f"{label} {t - t_prev:.1f}" for (_, t_prev), (label, t)
        in zip(t_phase, t_phase[1:])))
    return totals["dense"], totals["paged"], names


# the long-context turn: one request a slot, prompts of 1,600-1,984 tokens
# and budgets of 32-64, so every row's admitted positions end at or below
# 2,048; the engine buckets such a prompt to a width of 2,048 and refuses a
# width plus budget past its span, so the turn's engines run a span of 4,096
LONG_SPAN = 4096
LONG_LENGTHS = (1600, 1985)
LONG_BUDGETS = (32, 65)


def long_requests(torch, cfg, seed: int) -> list:
    """ENGINE_SLOTS requests of random token ids from a seed, prompt
    lengths and budgets drawn from LONG_LENGTHS and LONG_BUDGETS →
    [(ids, budget)]."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(*LONG_LENGTHS, (ENGINE_SLOTS,), generator=g)
    budgets = torch.randint(*LONG_BUDGETS, (ENGINE_SLOTS,), generator=g)
    return [(torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist(),
             m) for n, m in zip(lengths.tolist(), budgets.tolist())]


def long_context_model(torch) -> tuple:
    """llama-1b at span LONG_SPAN, bf16, random weights from seed 0 on the
    card → (cfg, params): the long-context turn's model, which the prefix
    cache phase reuses."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params

    dev = torch.device("cuda")
    cfg = replace(CONFIGS["llama-1b"], max_seq=LONG_SPAN)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)


def phase_long_context(torch, fa, card: str, check_counts: bool = True,
                       model: tuple | None = None) -> dict:
    """The slot engine in the long-context regime at llama-1b (bf16, 8
    slots, segments of 8, span LONG_SPAN): long_requests, all submitted
    at once, through four graphed engines in turns: dense and paged (a
    pool as large as the dense cache, pages of DECODE_PAGE) on the
    decode-attention kernel and on the plain f32 decode attention
    (``cfg.use_kernel=False``). Dense and paged tokens identical on each
    lane in every turn; the kernel lane's divergences from the plain lane
    printed (bf16 near-ties); ms a segment, ms a step and tokens/s of each;
    one profile of a kernel-lane turn (the kernels by time). With
    ``check_counts``, the kernel lanes' launches exactly as counted (the
    flash forward once a layer a prefill, decode attention once a layer a
    step, on the tensor-core route). ``model`` is long_context_model's
    (cfg, params), made here when None. → {"counts": launches over the
    counted turns of the kernel engines, "variants": each engine's
    numbers, "profile": the profile's kernels}."""
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane

    t0 = time.perf_counter()
    cfg, params = model if model is not None else long_context_model(torch)
    L = cfg.n_layers
    requests = long_requests(torch, cfg, seed=2)
    pool_mb = (ENGINE_SLOTS * (LONG_SPAN // DECODE_PAGE)
               * page_bytes(cfg, DECODE_PAGE) / 2 ** 20)
    plain = replace(cfg, use_kernel=False)
    engines = {v: ContinuousEngine(GreedyLane(params, c), slots=ENGINE_SLOTS,
                                   seg_steps=ENGINE_STEPS, pool_mb=mb,
                                   page_size=DECODE_PAGE)
               for v, c, mb in (("kernel dense", cfg, 0.0),
                                ("kernel paged", cfg, pool_mb),
                                ("plain dense", plain, 0.0),
                                ("plain paged", plain, pool_mb))}
    seg_ms = {v: [] for v in engines}
    for v, eng in engines.items():
        inner = eng._run_segment

        def run(eng=eng, v=v, inner=inner):
            before = eng.segments
            t = time.perf_counter()
            inner()
            if eng.segments > before:
                seg_ms[v].append((time.perf_counter() - t) * 1e3)
        eng._run_segment = run       # the scheduler calls it by attribute
        eng.warm()
    # the first turn of each captures its programs
    first = {}
    for v, eng in engines.items():
        first[v], _ = engine_turn(eng, requests, gap_s=0.0)
        wait_idle(eng)
        seg_ms[v].clear()
    for lane in ("kernel", "plain"):
        check(first[f"{lane} paged"] == first[f"{lane} dense"],
              f"long context, {lane} lane: paged tokens differ from dense")

    # -- the kernel engines' path: every count at 0 just before each turn --
    totals, walls, turn_ms = {}, {v: [] for v in engines}, {
        v: [] for v in engines}
    marks = {v: e.segments for v, e in engines.items()}
    for rep in range(ENGINE_TURNS):
        for v in (list(engines) if rep % 2 == 0
                  else list(reversed(engines))):
            reset_counts(fa)
            got, wall = engine_turn(engines[v], requests, gap_s=0.0)
            wait_idle(engines[v])
            if v.startswith("kernel"):
                for k, c in read_counts(fa).items():
                    totals[k] = totals.get(k, 0) + c
            check(got == first[v], f"long context {v}: tokens moved in turn "
                                   f"{rep}")
            walls[v].append(wall)
            turn_ms[v].append(sorted(seg_ms[v])[len(seg_ms[v]) // 2])
            seg_ms[v].clear()
    # -----------------------------------------------------------------------
    steps_run = sum(engines[v].segments - marks[v] for v in engines
                    if v.startswith("kernel")) * ENGINE_STEPS
    if check_counts:
        want = want_counts(fwd_tc=2 * ENGINE_TURNS * len(requests) * L,
                           dattn_tc=L * steps_run)
        check(totals == want, f"long context kernel engines' launches "
                              f"{totals} != {want}")
    want_tokens = first["kernel dense"]
    out_tokens = sum(len(t) for t in want_tokens)
    same = sum(a == b for a, b in zip(first["plain dense"], want_tokens))
    diverge = [next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None) for a, b in zip(first["plain dense"], want_tokens)]
    say(f"long context llama-1b, {len(requests)} requests (prompts "
        f"{sorted(len(i) for i, _ in requests)}, budgets "
        f"{sorted(b for _, b in requests)}, {out_tokens} tokens), span "
        f"{LONG_SPAN}: dense and paged tokens identical on both lanes in all "
        f"{1 + ENGINE_TURNS} turns; kernel against plain lane: {same} of "
        f"{len(requests)} requests identical, first divergent steps "
        f"{diverge} (bf16 near-ties); kernel launches {totals}")
    variants = {}
    for v in engines:
        med = sorted(walls[v])[len(walls[v]) // 2]
        seg = sorted(turn_ms[v])[len(turn_ms[v]) // 2]
        variants[v] = {"ms_segment": seg, "ms_step": seg / ENGINE_STEPS,
                       "tokens_s": out_tokens / med, "wall_s": walls[v]}
        say(f"long context engine {v}: ms a segment, each turn's median "
            f"{spread(turn_ms[v])}; {seg / ENGINE_STEPS:.3f} ms a step; "
            f"wall s {spread(walls[v])}; {out_tokens / med:.1f} tokens/s "
            f"(median turn) [{card}]")
    prof = profile_window(torch, "long context kernel dense engine turn",
                          lambda: engine_turn(engines["kernel dense"],
                                              requests, gap_s=0.0), card)
    for name, ms, count in prof["rows"]:
        if re.search(r"\bdecode_attention\w*_kernel\b", name):
            say(f"  decode attention in that turn: {ms:.3f} ms of "
                f"{prof['kernel_ms']:.3f} kernel ms ({ms / prof['kernel_ms']:.3f}),"
                f" {count} launches, {ms / count * 1e3:.1f} us each: "
                f"{name[:80]} [{card}]")
    for e in engines.values():
        e.close()
    del engines, params
    torch.cuda.empty_cache()
    say(f"long context phase seconds: {time.perf_counter() - t0:.1f}")
    return {"counts": totals, "variants": variants, "profile": prof["rows"]}


def wait_idle(eng, timeout: float = 30.0) -> None:
    """Wait for the engine's last drained rows to leave their slots (a
    row's result is handed back just before its slot is cleared)."""
    deadline = time.monotonic() + timeout
    while eng.stats()["occupied"] and time.monotonic() < deadline:
        time.sleep(0.01)
    check(eng.stats()["occupied"] == 0, "the engine never went idle")


# the prefix cache: llama-1b requests that open with one shared document
PREFIX_DOC = 1024          # the shared document's tokens: the reused prefix
PREFIX_REQUESTS = 4
PREFIX_BUDGET = 48
PREFIX_TURNS = 6           # timed turns of cold against warm, in turns
# llama-1b's warm prefill: the 1,024-position suffix against 2,048 keys
WARM_SHAPE = (1, 16, 1024, 2048, 128)
# the JAX prefix test's cold, hit and partial prompts
PREFIX_HTTP = ["the quick brown fox jumps over the lazy dog"] * 2 + [
    "the quick brown fox jumps over the lazy cat"]


def prefix_requests(torch, cfg, seed: int) -> list:
    """PREFIX_REQUESTS requests of LONG_LENGTHS tokens from a seed, each
    opening with the same PREFIX_DOC-token document (a long shared system
    prompt or document, as in the long-context turn's prompts) →
    [(ids, PREFIX_BUDGET)]."""
    g = torch.Generator().manual_seed(seed)
    doc = torch.randint(1, cfg.vocab_size, (PREFIX_DOC,), generator=g).tolist()
    lengths = torch.randint(*LONG_LENGTHS, (PREFIX_REQUESTS,), generator=g)
    return [(doc + torch.randint(1, cfg.vocab_size, (n - PREFIX_DOC,),
                                 generator=g).tolist(), PREFIX_BUDGET)
            for n in lengths.tolist()]


@contextlib.contextmanager
def watched_attention(fa):
    """While the block runs: the calls of both plain attention versions (the
    flash dispatcher's and decode attention's), and the (seq_q, seq_k) of
    every flash-forward launch the Python side makes (a capture's warm-up
    and capture; a replay runs no Python) → (calls by name, shapes)."""
    da = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    calls = {"attention_reference": 0, "decode_attention_reference": 0}
    shapes = []
    inner = (fa.attention_reference, da.decode_attention_reference,
             fa._check_kernel_inputs)

    def plain(i, name):
        def counted(*args, **kw):
            calls[name] += 1
            return inner[i](*args, **kw)
        return counted

    def checked(name, q, k, v, causal):
        if name == "flash_fwd_cuda":
            shapes.append((q.shape[2], k.shape[2]))
        return inner[2](name, q, k, v, causal)

    fa.attention_reference = plain(0, "attention_reference")
    da.decode_attention_reference = plain(1, "decode_attention_reference")
    fa._check_kernel_inputs = checked
    try:
        yield calls, shapes
    finally:
        (fa.attention_reference, da.decode_attention_reference,
         fa._check_kernel_inputs) = inner


def prefix_kernel(torch, fa) -> dict:
    """(a) The flash forward at the warm prefill's shapes against the plain
    version: llama-1b's WARM_SHAPE and a ragged q tile (1,008 rows against
    1,024, the diagonal 16 off the tile grid) on both routes, llama-test's
    f32 (48 rows against 64) on the CUDA-core route; at WARM_SHAPE both
    routes' times, the plain version's, the bound and a bottom-right
    causal SDPA call (a yardstick). → {kernel name: its numbers there}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    errs, timed = {}, None
    for b, h, sq, sk, d, dtype in (WARM_SHAPE + (bf16,),
                                   (1, 16, 1008, 1024, 128, bf16),
                                   (1, 4, 48, 64, 16, f32)):
        q, k, v = random_qkv(torch, g, b, h, sq, sk, d, dtype)
        scale = 1.0 / math.sqrt(d)
        for route in sorted({fa._route(dtype, d), "simt"}):
            errs[(b, h, sq, sk, d, route)] = check_fwd(
                torch, fa, q, k, v, True, scale, route)
        if (b, h, sq, sk, d) == WARM_SHAPE:
            timed = time_fwd(torch, fa, q, k, v, scale)
        del q, k, v
    return {name: {**timed[route], "max_abs_err": errs[WARM_SHAPE + (route,)]}
            for name, route in (("flash_fwd_tc", "tc"), ("flash_fwd", "simt"))}


def prefix_solo(torch, fa, card: str, cfg, params, requests) -> dict:
    """(b) The solo lane with a prefix store (``GreedyLane(prefix=...)``,
    the server's SERVE_PREFIX_CACHE_MB lane): with every count at 0 just
    before, the requests one after another, the first cold and stored, the
    rest warm at q = PREFIX_DOC; exactly one flash-forward launch a layer
    a prefill, the warm ones at seq_q = width - q against seq_k = width,
    no plain attention; greedy tokens against a cache-free lane's (equal,
    or diverging first at a printed near-tie); time to first token warm
    against cold on the same prompt, in turns. → {"counts", "ttft"}."""
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve.prefix_cache import PrefixCache
    from tpu_kubernetes_torch.serve.server import GreedyLane, _pad_rows

    L = cfg.n_layers

    def cold(lane, ids, budget):
        width, run = solo_shape(ids, budget)
        return lane.prefill(_pad_rows([ids], width),
                            torch.tensor([len(ids)], dtype=torch.int32),
                            width + run)

    def warm(lane, ids, budget):
        width, run = solo_shape(ids, budget)
        return lane.prefill_any(ids, width, width + run)

    def finish(lane, st, budget):
        out, steps = lane.decode_greedy(st, [budget], ENGINE_STEPS)
        return out[0][:budget], steps

    free_lane = GreedyLane(params, cfg)
    solo = [finish(free_lane, cold(free_lane, ids, b), b)[0]
            for ids, b in requests]
    # room for every prompt's positions (64 KiB a position at llama-1b)
    cap = 2 * sum(len(ids) for ids, _ in requests) * page_bytes(cfg, 1)
    lane = GreedyLane(params, cfg, prefix=PrefixCache(
        cap, sig=("llama-1b", "bfloat16", False)))
    # -- the prefix lane's path: every count at 0 just before ---------------
    with watched_attention(fa) as (plain, shapes):
        reset_counts(fa)
        got, steps = [], 0
        for i, (ids, b) in enumerate(requests):
            if i == 1:
                shapes.clear()          # the warm prefills' launches only
            toks, n = finish(lane, warm(lane, ids, b), b)
            got.append(toks)
            steps += n
        counts = read_counts(fa)
    # -------------------------------------------------------------------------
    width, run = solo_shape(*requests[0])
    key = ("prefill_warm", 1, PREFIX_DOC, width, width + run)
    warm_keys = [k for k in lane.programs.captures if k[0] == "prefill_warm"]
    looked = dict(lane.prefix_lookups)
    say(f"prefix cache solo lane llama-1b: {len(requests)} requests (prompts "
        f"{[len(i) for i, _ in requests]}, a {PREFIX_DOC}-token shared "
        f"document), lookups {looked}, warm programs {warm_keys}, warm "
        f"flash launches recorded at (seq_q, seq_k) {sorted(set(shapes))} "
        f"x{len(shapes)} (a capture's warm-up and capture), plain attention "
        f"calls {plain}, launches {counts}")
    check(looked["miss"] == 1 and looked["hit"] + looked["partial"]
          == len(requests) - 1, f"prefix lookups {looked}")
    check(warm_keys == [key], f"warm programs {warm_keys} != [{key}]")
    check(set(shapes) == {(width - PREFIX_DOC, width)} and len(shapes) == 2 * L,
          f"warm flash launches at {shapes}")
    check(lane.programs._programs[key].launches
          == {"flash_fwd": L, "flash_fwd.tc": L},
          f"the warm program records {lane.programs._programs[key].launches}")
    check(plain == {"attention_reference": 0,
                    "decode_attention_reference": 0},
          f"plain attention ran on the card's warm path: {plain}")
    want = want_counts(fwd_tc=L * len(requests), dattn_tc=L * steps)
    check(counts == want, f"prefix solo launches {counts} != {want}")
    diverged = near_tie_divergences(torch, params, cfg,
                                    "prefix cache solo warm", requests, got,
                                    solo)
    say(f"prefix cache solo lane: {len(requests) - diverged} of "
        f"{len(requests)} requests token-identical to the cache-free lane")

    # time to first token, cold (cache-free lane) against warm (the store
    # holds the prompt's document), the same prompt, in turns
    ids, b = requests[1]
    ms = {"cold": [], "warm": []}
    for rep in range(PREFIX_TURNS):
        for v in (("cold", "warm") if rep % 2 == 0 else ("warm", "cold")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = (cold(free_lane, ids, b) if v == "cold"
                  else warm(lane, ids, b))
            int(st.token[0])
            ms[v].append((time.perf_counter() - t) * 1e3)
    med = {v: sorted(x)[len(x) // 2] for v, x in ms.items()}
    say(f"prefix cache time to first token, llama-1b, prompt {len(ids)} "
        f"(width {width}): cold {spread(ms['cold'])} ms, warm at q = "
        f"{PREFIX_DOC} {spread(ms['warm'])} ms (prefill, lookup, copy-in and "
        f"store insert); median warm / cold {med['warm'] / med['cold']:.3f} "
        f"[{card}]")
    for v, fn in (("cold", lambda: cold(free_lane, ids, b)),
                  ("warm", lambda: warm(lane, ids, b))):
        profile_window(torch, f"prefix cache {v} prefill", fn, card)
    del free_lane, lane
    return {"counts": counts, "ttft": {v: {"ms": med[v], "turns": ms[v]}
                                       for v in ms}}


def prefix_paged(torch, fa, card: str, cfg, params, requests) -> dict:
    """(c) The paged engine with its store of pinned pages, on the
    long-context turn's 2,048-page pool, the store capped one entry short
    of the four prompts' pages: the requests at once, with every count at
    0 just before (the first admission cold, the rest warm, referencing
    the first's pinned pages and scattering only their suffix pages), one
    entry evicted; tokens against a cache-free paged engine's (equal, or
    a near-tie); pages pinned while stored, and free + live + pinned ==
    total after the drain; then a second turn, every admission warm, the
    evicted entry's shared pages still right. → the first turn's counts."""
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve.prefix_cache import PrefixCache
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane

    L = cfg.n_layers
    pb = page_bytes(cfg, DECODE_PAGE)
    pool_mb = ENGINE_SLOTS * (LONG_SPAN // DECODE_PAGE) * pb / 2 ** 20
    cap = sum(len(ids) // DECODE_PAGE * pb for ids, _ in requests) - 1

    def engine(store):
        return ContinuousEngine(
            GreedyLane(params, cfg, prefix=store), slots=ENGINE_SLOTS,
            seg_steps=ENGINE_STEPS, pool_mb=pool_mb, page_size=DECODE_PAGE)

    free = engine(None)
    eng = engine(PrefixCache(cap, sig=("llama-1b", "bfloat16", False)))
    for e in (free, eng):
        e.warm()
    ref, _ = engine_turn(free, requests)
    wait_idle(free)
    free.close()

    def conserved(label):
        wait_idle(eng)
        pages = eng.stats()["pages"]
        say(f"prefix cache paged engine, {label}: pages {pages}")
        check(pages["free"] + pages["live"] + pages["pinned"]
              == pages["total"] and pages["live"] == 0,
              f"pages not conserved {label}: {pages}")
        return pages

    # -- the paged engine's path: every count at 0 just before --------------
    reset_counts(fa)
    mark = eng.segments
    got, wall = engine_turn(eng, requests)
    wait_idle(eng)
    counts = read_counts(fa)
    # -------------------------------------------------------------------------
    want = want_counts(fwd_tc=L * len(requests),
                       dattn_tc=L * ENGINE_STEPS * (eng.segments - mark))
    check(counts == want, f"prefix paged engine launches {counts} != {want}")
    looked = dict(eng.lane.prefix_lookups)
    pages = conserved("after the first turn")
    width, _ = solo_shape(*requests[0])
    skip_key = ("paged_insert", width, PREFIX_DOC)
    check(looked["miss"] == 1 and looked["hit"] + looked["partial"]
          == len(requests) - 1, f"paged prefix lookups {looked}")
    check(skip_key in eng.lane.programs.captures,
          f"no warm insert {skip_key}: {list(eng.lane.programs.captures)}")
    check(pages["pinned"] > 0 and pages["prefix_entries"]
          == len(requests) - 1, f"the store after the turn: {pages}")
    diverged = near_tie_divergences(torch, params, cfg,
                                    "prefix cache paged engine", requests,
                                    got, ref)
    got2, _ = engine_turn(eng, requests)
    looked2 = {k: eng.lane.prefix_lookups[k] - looked[k] for k in looked}
    check(looked2["miss"] == 0, f"second turn lookups {looked2}")
    diverged2 = near_tie_divergences(torch, params, cfg,
                                     "prefix cache paged engine, all warm",
                                     requests, got2, ref)
    conserved("after the second turn")
    say(f"prefix cache paged engine llama-1b ({pages['total']} pages, store "
        f"cap {cap} B, one entry evicted): lookups {looked}, then all warm "
        f"{looked2}; {len(requests) - diverged} and "
        f"{len(requests) - diverged2} of {len(requests)} requests identical "
        f"to the cache-free engine; first turn wall {wall:.3f} s; launches "
        f"{counts} [{card}]")
    eng.close()
    return counts


def prefix_http(torch, fa) -> dict:
    """(d) HTTP at llama-test in f32 with SERVE_PREFIX_CACHE_MB=8: the cold,
    hit and partial prompts answer as a cache-free server does, and
    /healthz carries ``prefix_cache`` (its signature and the lookups). →
    the launch counts of the prefix server's requests."""
    env = {**HTTP_ENV, "SERVE_DTYPE": "float32"}
    bodies = [{"prompt": p, "max_tokens": 8} for p in PREFIX_HTTP]
    with serving(env) as (_, port):
        want = [_request(port, "POST", "/v1/completions", b)[1]["text"]
                for b in bodies]
    with serving({**env, "SERVE_PREFIX_CACHE_MB": "8"}) as (_, port):
        reset_counts(fa)
        got = []
        for body in bodies:
            code, out = _request(port, "POST", "/v1/completions", body)
            check(code == 200, f"/v1/completions {code}: {out}")
            got.append(out["text"])
        counts = read_counts(fa)
        code, health = _request(port, "GET", "/healthz")
    pc = health.get("prefix_cache")
    say(f"prefix cache http llama-test f32: texts "
        f"{'identical to' if got == want else 'DIFFER from'} the cache-free "
        f"server's; /healthz prefix_cache {pc}; launches {counts}")
    check(got == want, f"prefix server texts {got} != cache-free {want}")
    check(code == 200 and pc is not None
          and pc["sig"] == ["llama-test", "float32", False]
          and pc["lookups"] == {"hit": 1, "partial": 1, "miss": 1},
          f"/healthz prefix_cache {pc}")
    check(counts["flash_fwd.simt"] == 2 * len(bodies)
          and counts["flash_fwd.tc"] == 0,
          f"prefix http flash launches {counts}")
    return counts


def phase_prefix_cache(torch, fa, card: str, model: tuple) -> dict:
    """The prefix cache (SERVE_PREFIX_CACHE_MB): (a) the flash forward at
    the warm shapes, (b) the solo lane at llama-1b (long_context_model's
    parameters), (c) the paged engine with its page store, (d) HTTP at
    llama-test. → {"solo", "paged", "http": each path's launch counts,
    "at_warm_shape": the flash forward's numbers there, "ttft"}."""
    t0 = time.perf_counter()
    at_warm = prefix_kernel(torch, fa)
    cfg, params = model
    requests = prefix_requests(torch, cfg, seed=3)
    solo = prefix_solo(torch, fa, card, cfg, params, requests)
    paged = prefix_paged(torch, fa, card, cfg, params, requests)
    http = prefix_http(torch, fa)
    torch.cuda.empty_cache()
    say(f"prefix cache phase seconds: {time.perf_counter() - t0:.1f}")
    return {"solo": solo["counts"], "paged": paged, "http": http,
            "at_warm_shape": at_warm, "ttft": solo["ttft"]}



# four concurrent greedy completions of three widths and budgets, a
# streamed one and a chat one, for the batching servers at llama-test
HTTP_BATCH = [{"prompt": "alpha", "max_tokens": 8},
              {"prompt": "beta gamma delta epsilon zeta", "max_tokens": 12},
              {"prompt": "", "max_tokens": 5},
              {"prompt": "the quick brown fox jumps over the lazy dog "
                         "and keeps on running", "max_tokens": 16}]
HTTP_STREAM = {"prompt": "stream me on the card", "max_tokens": 12}
HTTP_CHAT = {"messages": [{"role": "system", "content": "be brief"},
                          {"role": "user", "content": "hello card"}],
             "max_tokens": 10}


def ids_by_text(state) -> dict:
    """Keep the token ids of each text ``state`` renders, by the text."""
    seen, inner = {}, state.decode_text

    def decode_text(ids):
        text = inner(ids)
        seen[text] = list(ids)
        return text

    state.decode_text = decode_text
    return seen


def http_concurrently(port: int, bodies: list) -> list:
    outs = [None] * len(bodies)

    def post(i):
        outs[i] = _request(port, "POST", "/v1/completions", bodies[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for i, out in enumerate(outs):
        check(out is not None and out[0] == 200,
              f"/v1/completions {bodies[i]} -> {out}")
    return [o[1] for o in outs]


def sse_text(port: int, path: str, body: dict) -> tuple[str, str | None]:
    """POST with "stream": true → (the joined deltas, the finish reason),
    after checking the event stream ends in data: [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=json.dumps({**body, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200 and resp.getheader("Content-Type")
              == "text/event-stream", f"stream {path} -> {resp.status}")
        lines = resp.read().decode().splitlines()
    finally:
        conn.close()
    frames = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    check(frames and frames[-1] == "[DONE]", f"stream {path}: no [DONE]")
    pieces, reason = [], None
    for frame in frames[:-1]:
        choice = json.loads(frame)["choices"][0]
        reason = choice.get("finish_reason") or reason
        pieces.append(choice.get("text")
                      or choice.get("delta", {}).get("content", ""))
    return "".join(pieces), reason


def phase_http_batching(torch, fa, card: str) -> tuple[dict, set]:
    """The batching servers over HTTP at llama-test (bf16, on the card):
    with SERVE_CONTINUOUS_BATCHING=1 and SERVER_BATCH=4, four concurrent
    greedy completions, a streamed completion and a chat completion; then
    the round batcher (SERVER_BATCH=4, engine off) with the same four.
    Each greedy response equals the solo server's or diverges first at a
    printed near-tie of the solo run; the joined stream deltas equal the
    solo server's text (the stream decodes at the solo span); the chat
    content equals the same server's completion of the rendered
    transcript. With the engine idle, a segment and a prefill replay: the
    CUDA-core kernels (head_dim 16) in a replay-only profile. → (launch
    counts over both servers' requests, kernel names of that profile)."""
    from tpu_kubernetes_torch.serve.server import _Handler

    with serving(HTTP_ENV) as (state, port):
        solo_ids = ids_by_text(state)
        solo = [_request(port, "POST", "/v1/completions", b)[1]
                for b in HTTP_BATCH]
        stream_plain = _request(port, "POST", "/v1/completions",
                                HTTP_STREAM)[1]
    rendered = _Handler._chat_prompt(HTTP_CHAT["messages"])
    counts = {}
    for mode, extra in (("engine", {"SERVE_CONTINUOUS_BATCHING": "1",
                                    "SERVER_BATCH": "4"}),
                        ("round batcher", {"SERVER_BATCH": "4"})):
        with serving({**HTTP_ENV, **extra}) as (state, port):
            check((state._engine is not None) == (mode == "engine")
                  and (state._batcher is not None) == (mode != "engine"),
                  f"http {mode}: the server did not build it")
            ids = ids_by_text(state)
            # -- the path: every count at 0 just before, read just after -
            reset_counts(fa)
            t0 = time.perf_counter()
            got = http_concurrently(port, HTTP_BATCH)
            wall = time.perf_counter() - t0
            if mode == "engine":
                text, reason = sse_text(port, "/v1/completions", HTTP_STREAM)
                code, chat = _request(port, "POST", "/v1/chat/completions",
                                      HTTP_CHAT)
                check(code == 200 and chat["object"] == "chat.completion",
                      f"chat -> {code} {chat}")
                code, plain = _request(port, "POST", "/v1/completions",
                                       {"prompt": rendered,
                                        "max_tokens": HTTP_CHAT[
                                            "max_tokens"]})
            for k, n in read_counts(fa).items():
                counts[k] = counts.get(k, 0) + n
            # -------------------------------------------------------------
            if mode == "engine":
                say(f"http engine stream: {text!r} ({reason}); solo "
                    f"non-streamed {stream_plain['text']!r}")
                check(text == stream_plain["text"]
                      and reason == stream_plain["finish_reason"],
                      "the joined stream deltas differ from the solo text")
                content = chat["choices"][0]["message"]["content"]
                check(content == plain["text"]
                      and chat["usage"]["completion_tokens"]
                      == plain["tokens"],
                      "the chat content differs from the completion of its "
                      "transcript")
                code, health = _request(port, "GET", "/healthz")
                say(f"http engine /healthz continuous_batching "
                    f"{health.get('continuous_batching')}")
                wait_idle(state._engine)
                # 16 ids: the width-16 prefill the requests captured
                names = engine_replays(
                    torch, fa, "http engine", state._engine,
                    (state.encode(HTTP_BATCH[0]["prompt"]) + [0] * 16)[:16],
                    card, {"flash_fwd_kernel", "decode_attention_kernel"})
            prompts = [state.encode(b["prompt"]) or [0] for b in HTTP_BATCH]
            requests = [(p, b["max_tokens"]) for p, b in zip(prompts,
                                                             HTTP_BATCH)]
            for out, b in zip(got, HTTP_BATCH):
                check(out["tokens"] == b["max_tokens"],
                      f"http {mode}: {out['tokens']} tokens for {b}")
            diverged = near_tie_divergences(
                torch, state.params, state.cfg, f"http {mode}", requests,
                [ids[o["text"]] for o in got],
                [solo_ids[o["text"]] for o in solo])
            say(f"http {mode}: 4 concurrent completions in "
                f"{wall * 1e3:.1f} ms, {4 - diverged} of 4 identical to the "
                f"solo server's, {diverged} diverging at a near-tie [{card}]")
    check(counts["flash_fwd"] > 0 and counts["decode_attention"] > 0
          and counts == want_counts(fwd_simt=counts["flash_fwd"],
                                    dattn_simt=counts["decode_attention"]),
          f"http batching launches {counts}: llama-test's head_dim 16 takes "
          f"the CUDA-core route, and decode runs the decode-attention kernel")
    return counts, names


def phase_graph_train(torch, fa, card: str, name: str, cfg, b: int, seq: int,
                      steps: int, loss_tol: float) -> tuple[dict, set]:
    """make_train_step as a CUDA graph against its body run eagerly, from
    two states made from one seed, on the same batches: a first step each
    (the graph's capture), then REPEATS turns of ``steps`` steps each,
    losses within ``loss_tol`` relative; step wall, tokens/s and device
    memory peak of both with spreads, kernels and busy share from a
    profile of one step of each, and the out-of-place ``train_step``'s
    peak beside them. → (launch counts over the turns, kernel names of
    the replay-only window)."""
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        make_train_step,
        synthetic_batches,
        train_step,
    )

    dev = torch.device("cuda")
    L = cfg.n_layers
    tc = TrainConfig()
    states = {v: init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                            tc, dev) for v in ("eager", "graphed")}
    fns = {"eager": make_train_step(cfg, tc, states["eager"], (b, seq + 1),
                                    graphs=False),
           "graphed": make_train_step(cfg, tc, states["graphed"],
                                      (b, seq + 1))}
    batches = synthetic_batches(cfg.vocab_size, b, seq, seed=0, device=dev)
    first = next(batches)
    # the first step of each (the graphed one's warm-up and capture): its
    # device memory peak above the memory resident before it
    losses, first_peak = {}, {}
    for v in ("eager", "graphed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        losses[v] = [fns[v](first).item()]
        first_peak[v] = (torch.cuda.max_memory_allocated(dev)
                         - resident) / 2**30

    # -- the main path: every count at 0 just before, read just after ----
    reset_counts(fa)
    stats = {"eager": [], "graphed": []}
    for rep in range(REPEATS):
        chunk = [next(batches) for _ in range(steps)]
        for v in in_turns(rep):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = [fns[v](x).clone() for x in chunk]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            stats[v].append((wall / steps * 1e3, b * seq * steps / wall,
                             peak / 2**30, (peak - resident) / 2**30))
            losses[v].extend(x.item() for x in out)
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    # per step and layer as in the eager phases, on the route of the dtype;
    # the grouped products only in the MoE model (grouped dispatch here)
    n = 2 * REPEATS * steps
    route = "tc" if cfg.dtype == torch.bfloat16 else "simt"
    grouped = int(hasattr(cfg, "n_experts"))
    per = {"fwd": 2, "dq": 1, "dkv": 1, "gmm": 8 * grouped,
           "drhs": 3 * grouped}
    wanted = want_counts(adamw=n, **{f"{k}_{route}": v * L * n
                                     for k, v in per.items()})
    check(counts == wanted, f"{name} train launches {counts} != {wanted}")
    rel = max(abs(g - e) / abs(e)
              for g, e in zip(losses["graphed"], losses["eager"]))
    graphed = fns["graphed"].program
    say(f"{name} train {b}x{seq}, graphed vs eager from one state: losses "
        f"eager {[round(x, 5) for x in losses['eager']]}, graphed "
        f"{[round(x, 5) for x in losses['graphed']]}; max rel diff "
        f"{rel:.3e} (tol {loss_tol:.0e}); captures {graphed.captures}, "
        f"replays {graphed.replays}; launches {counts}")
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          f"{name}: non-finite loss")
    check(rel <= loss_tol, f"{name}: graphed losses differ from eager")
    check(graphed.captures == 1 and graphed.replays == REPEATS * steps,
          f"{name}: captures {graphed.captures}, replays {graphed.replays}")
    for v in ("eager", "graphed"):
        st = stats[v]
        say(f"{name} {v} (in place): step wall ms "
            f"{spread([x[0] for x in st])}; tokens/s "
            f"{spread([x[1] for x in st])}; device memory peak GiB "
            f"{spread([x[2] for x in st])}, above the resident "
            f"{spread([x[3] for x in st])}; the first step's (the graph's "
            f"warm-up and capture) {first_peak[v]:.3f} GiB above the "
            f"resident [{card}]")
    reserved = torch.cuda.memory_reserved(dev) / 2**30
    say(f"{name}: device memory reserved {reserved:.3f} GiB with both "
        f"states and the graph's pool [{card}]")
    batch = next(batches)
    prof = {v: profile_window(torch, f"{name} {v} train step {b}x{seq}",
                              lambda v=v: fns[v](batch), card)
            for v in ("eager", "graphed")}
    check_replay_launches(torch, fa, f"{name} train-step replay",
                          lambda: fns["graphed"](batch), card)
    del fns
    # the out-of-place step of the parity tests: its peak, for the same
    # state (the eager one's, which it leaves as it was)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    new_state, _ = train_step(states["eager"], batch, cfg, tc)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"{name} out-of-place train_step: device memory peak "
        f"{peak / 2**30:.3f} GiB, above the resident "
        f"{(peak - resident) / 2**30:.3f} GiB (two states resident) "
        f"[{card}]")
    del states, new_state, batch, batches
    torch.cuda.empty_cache()
    return counts, prof["graphed"]["names"]


def adamw_leaves(torch, cfg, seed: int):
    """Gradient, params, mu and nu leaves of ``cfg``'s parameter tree
    (bf16, and f32 for MoE's router): params as init_params makes them,
    gradients ~ N(0, 1e-3²) (a global norm near 30, so the clip engages),
    mu ~ N(0, 1e-3²), nu = |N(0, 1e-6²)| as after a few steps."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_leaves(init_params(cfg, gen, dev))

    def rand(p, scale):
        return (torch.randn(p.shape, generator=gen, device=dev,
                            dtype=p.dtype) * scale)

    return ([rand(p, 1e-3) for p in params], params,
            [rand(p, 1e-3) for p in params],
            [rand(p, 1e-6).abs_() for p in params])


def library_norm(torch, grads):
    """The yardstick of adamw_sumsq: torch._foreach_norm in f32 over every
    leaf, then the norm of those norms."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2.0, dtype=torch.float32)))


def library_adamw(torch, grads, params, mus, nus, norm, scalars, h):
    """The yardstick of adamw_update: torch._fused_adamw_, one call per
    leaf dtype. Its decoupled decay p·(1 − lr·wd) − lr·m̂/(√v̂ + ε) is
    optax's p − lr·(m̂/(√v̂ + ε) + wd·p), and grad_scale = max(norm / clip,
    1) is optax's clip. It divides ``grads`` in place and moves its own
    step count, so it takes copies of the gradients; its steps start at
    the count scalars were made from (3)."""
    lr = -scalars[0]
    grad_scale = torch.clamp(norm / h.grad_clip, min=1.0)
    for dtype in {t.dtype for t in params}:
        idx = [i for i, t in enumerate(params) if t.dtype == dtype]
        torch._fused_adamw_(
            [params[i] for i in idx], [grads[i] for i in idx],
            [mus[i] for i in idx], [nus[i] for i in idx], [],
            [torch.full((), 3.0, device=norm.device) for _ in idx],
            lr=lr, beta1=h.b1, beta2=h.b2, weight_decay=h.weight_decay,
            eps=h.eps, amsgrad=False, maximize=False,
            grad_scale=grad_scale, found_inf=None)


def phase_adamw(torch, card: str) -> list:
    """The fused AdamW kernels against their plain versions on llama-1b's
    and moe-1b's leaves: the norm within f32 summation error of the plain
    one, and from the kernel's norm params, mu and nu equal to the plain
    update's bit for bit; each kernel's time, the plain version's, the
    library's (library_norm, library_adamw) and the bound. → the two
    kernel line entries."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.ops import adamw as tadamw
    from tpu_kubernetes_torch.train import TrainConfig, make_optimizer

    dev = torch.device("cuda")
    opt = make_optimizer(TrainConfig())
    h = opt.hyper()
    # count 3: the schedule and both bias corrections away from 0 and 1
    scalars = opt.scalars(torch.full((), 3, dtype=torch.int32, device=dev))
    out = {}
    for name, cfg in (("llama-1b", CONFIGS["llama-1b"]),
                      ("moe-1b", CONFIGS["moe-1b"])):
        g, p, mu, nu = adamw_leaves(torch, cfg, 31)
        start = [[t.clone() for t in group] for group in (p, mu, nu)]
        norm = tadamw.global_norm_cuda(g)
        plain_norm = tadamw.global_norm_reference(g)
        rel = abs(norm.item() - plain_norm.item()) / plain_norm.item()
        copies = [[t.clone() for t in group] for group in (p, mu, nu)]
        tadamw.adamw_update_reference_(g, *copies, norm, scalars, h)
        tadamw.adamw_update_cuda_(g, p, mu, nu, norm, scalars, h)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for got, want in zip((p, mu, nu), copies)
                  for a, b in zip(got, want))
        same = all(torch.equal(a, b) for got, want in zip((p, mu, nu), copies)
                   for a, b in zip(got, want))
        dtypes = sorted({str(t.dtype) for t in p})
        numel = sum(t.numel() for t in p)
        nbytes = sum(t.numel() * t.element_size() for t in p)
        say(f"adamw {name} ({len(p)} leaves, {numel} params, {dtypes}): "
            f"norm kernel {norm.item():.7e} vs plain {plain_norm.item():.7e} "
            f"(rel {rel:.3e}, tol 1e-5); from the same norm params, mu, nu "
            f"{'bit-identical' if same else 'DIFFER'} (max abs err {err})")
        check(rel <= 1e-5, f"adamw {name}: the kernel's norm is off")
        check(same, f"adamw {name}: the update differs from plain")
        del copies
        # the library's AdamW from the same start (yardstick only): its
        # update against the kernel's, its norm against the kernel's
        lib_norm = library_norm(torch, g)
        lib_g = [t.clone() for t in g]
        library_adamw(torch, lib_g, *start, norm, scalars, h)
        torch.cuda.synchronize()
        lib_err = [max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))
                   for got, want in zip(start, (p, mu, nu))]
        say(f"adamw {name} library yardsticks: norm "
            f"{lib_norm.item():.7e}; torch._fused_adamw_ from the same "
            f"start and norm, max abs diff to the kernel's params, mu, nu "
            f"{lib_err}")
        del start
        torch.cuda.empty_cache()
        ms_sumsq = cuda_ms(lambda: tadamw.global_norm_cuda(g), 10)
        ms_update = cuda_ms(lambda: tadamw.adamw_update_cuda_(
            g, p, mu, nu, norm, scalars, h), 10)
        plain_sumsq = cuda_ms(lambda: tadamw.global_norm_reference(g), 3)
        plain_update = cuda_ms(lambda: tadamw.adamw_update_reference_(
            g, p, mu, nu, norm, scalars, h), 3)
        lib_sumsq = cuda_ms(lambda: library_norm(torch, g), 10)
        lib_update = cuda_ms(lambda: library_adamw(
            torch, lib_g, p, mu, nu, norm, scalars, h), 10)
        del lib_g
        # bytes: g read once (the norm); g, p, mu, nu read and p, mu, nu
        # written once (the update). Operations: 2 (the norm) and 18 (the
        # update) f32 operations an element on the CUDA cores
        b_sumsq, b_update = (
            dict(zip(("bound_ms", "bound_by"), bound(ops, nb, "float32")))
            for ops, nb in ((2 * numel, nbytes), (18 * numel, 7 * nbytes)))
        out[name] = {
            "adamw_sumsq": {"ms": ms_sumsq, "plain_ms": plain_sumsq,
                            **b_sumsq, "library_ms": lib_sumsq,
                            "max_abs_err": abs(
                                norm.item() - plain_norm.item())},
            "adamw_update": {"ms": ms_update, "plain_ms": plain_update,
                             **b_update, "library_ms": lib_update,
                             "max_abs_err": err}}
        for k, v in out[name].items():
            say(f"adamw {name} {k}: {v['ms']:.4f} ms, bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']}), plain "
                f"{v['plain_ms']:.4f} ms, library {v['library_ms']:.4f} ms "
                f"[{card}]")
        del g, p, mu, nu, norm, plain_norm
        torch.cuda.empty_cache()

    def entry(kernel):
        return {"name": kernel, "route": "cuda",
                "source": "tpu_kubernetes_torch/csrc/adamw.cu",
                # no Pallas kernel: the optax chain XLA fuses in the step
                "replaces": "tpu_kubernetes/train/trainer.py:143",
                "launches": None,        # filled from its main path's run
                **out["llama-1b"][kernel],
                "at_moe_leaves": out["moe-1b"][kernel]}

    return [entry("adamw_sumsq"), entry("adamw_update")]


# ---------------------------------------------------------------------------
# decode attention (csrc/decode_attention.cu) against its plain version
# ---------------------------------------------------------------------------

DECODE_PAGE = 16       # the engine's default SERVE_KV_PAGE_SIZE
DECODE_COPIES = 4      # caches a timing loop rotates over (past the L2)


def decode_case(torch, label, cfg, b, S, dtype, rows, prompt_slots=None,
                paged=False, seed=0):
    """One decode-attention call at a model's widths: q (b, h, 1, d) and
    DECODE_COPIES dense caches (b, kv, S, d) from a seed; ``rows`` gives
    each row's (limit, prompt length, prompt width), and ``prompt_slots``
    an int for the whole batch instead of the per-row widths; ``paged``
    moves every cache into a pool of DECODE_PAGE-position pages through
    one shuffled table. → a dict of the call's arguments per copy, the
    dense caches (the yardstick's input) and the bytes the call needs."""
    dev = torch.device("cuda")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, 1, d), generator=g, device=dev).to(dtype)
    limits = torch.tensor([r[0] for r in rows], device=dev)[:, None]
    pl = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    ps = (prompt_slots if prompt_slots is not None else
          torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev))
    dense = [tuple(torch.randn((b, kv, S, d), generator=g, device=dev)
                   .to(dtype) for _ in range(2))
             for _ in range(DECODE_COPIES)]
    table = None
    calls = [(k, v) for k, v in dense]
    if paged:
        table = shuffled_table(torch, b, S, seed)
        calls = [tuple(to_pool(torch, t, table) for t in kv_)
                 for kv_ in dense]
    gap = [max(0, min(r[0], (prompt_slots if prompt_slots is not None
                             else r[2])) - r[1]) for r in rows]
    admitted = sum(min(r[0], S) - gp for r, gp in zip(rows, gap))
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * admitted * kv * d + 2 * b * h * d) * item + (
        b * (S // DECODE_PAGE) * 4 if paged else 0)
    return {"label": label, "q": q, "limits": limits, "pl": pl, "ps": ps,
            "table": table, "calls": calls, "dense": dense,
            "nbytes": nbytes, "admitted": admitted, "dtype": dtype,
            "S": S, "rows": rows}


def decode_tol(torch, ref) -> float:
    """The kernel's tolerance against the plain version: bf16, one bf16
    ulp of max |o| (both round an f32 result once, summed in other
    orders); f32, 2e-6 of max |o|."""
    scale = ref.abs().max().item()
    if ref.dtype == torch.bfloat16:
        return bf16_ulp(scale)
    return 2e-6 * scale


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls captured in
    one CUDA graph, as the decode paths replay it (the host's launch cost
    of a small call would otherwise be all an event pair measures), after
    a warm-up call and one untimed replay."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_gc(), torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def sdpa_decode(torch, case, i):
    """The yardstick: one scaled_dot_product_attention call on copy ``i``'s
    dense cache with the rows' masks as a boolean attn_mask (GQA by
    enable_gqa). The port never calls it."""
    import torch.nn.functional as F

    k, v = case["dense"][i]
    return F.scaled_dot_product_attention(case["q"], k, v,
                                          attn_mask=case["mask"],
                                          enable_gqa=True)


def decode_cases(torch) -> list:
    """phase_decode_attention's shapes (see there), as decode_case dicts."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.serve.server import _bucket

    bf16, f32 = torch.bfloat16, torch.float32
    llama, moe = CONFIGS["llama-1b"], CONFIGS["moe-1b"]
    test = CONFIGS["llama-test"]
    reqs = engine_requests(torch, llama, ENGINE_SLOTS, seed=1)
    # the engine traffic's rows mid-decode: each at width + half its budget
    engine_rows = [(_bucket(len(ids)) + budget // 2 + 1, len(ids),
                    _bucket(len(ids))) for ids, budget in reqs]
    full_rows = [(2048, 512, 512)] * ENGINE_SLOTS
    solo_rows = [(1024 + 33, n, 1024) for n in (1024, 1000, 777, 333)]
    test_rows = [(100, 40, 64), (20, 5, 16), (1, 0, 0), (128, 30, 32)]
    return [
        decode_case(torch, "llama-1b engine, every row at the full span",
                    llama, 8, 2048, bf16, full_rows),
        decode_case(torch, "llama-1b engine, traffic limits", llama, 8, 2048,
                    bf16, engine_rows),
        decode_case(torch, "llama-1b engine, traffic limits, paged", llama,
                    8, 2048, bf16, engine_rows, paged=True),
        decode_case(torch, "llama-1b solo lane, int prompt_slots", llama, 4,
                    1088, bf16, solo_rows, prompt_slots=1024),
        decode_case(torch, "moe-1b engine (d 64), traffic limits", moe, 8,
                    2048, bf16, engine_rows),
        decode_case(torch, "llama-7b widths (32/32 heads), every row at the "
                    "full span", CONFIGS["llama-7b"], 8, 2048, bf16,
                    full_rows),
        decode_case(torch, "llama-70b widths (64/8 heads), every row at the "
                    "full 4,096, paged", CONFIGS["llama-70b"], 8, 4096, bf16,
                    [(4096, 512, 512)] * ENGINE_SLOTS, paged=True),
        decode_case(torch, "llama-test (d 16) bf16", test, 4, 128, bf16,
                    test_rows),
        decode_case(torch, "llama-test (d 16) f32", test, 4, 128, f32,
                    test_rows),
        decode_case(torch, "llama-test (d 16) f32, paged", test, 4, 128, f32,
                    test_rows, paged=True),
    ]


def phase_decode_attention(torch, card: str) -> list:
    """The decode-attention kernels against their plain version at the
    shapes of the decode paths and of the presets' widths: llama-1b's
    engine (8 rows over its 2,048 span, every row at the full span, then
    the engine traffic's mixed limits, dense and paged), the solo lane (4
    rows at span 1,088 with one int prompt_slots), moe-1b's d 64,
    llama-7b's 32 query heads over 32 KV heads (8 rows at the full 2,048),
    llama-70b's 64 over 8 (8 rows at the full 4,096, paged): bf16 at d 64
    and 128, the tensor-core route; llama-test's d 16 in bf16 and f32, the
    CUDA-core route. Each: the error against plain within decode_tol, the
    paged output bitwise the dense one, the kernel's time, the plain
    version's, the bound (the K/V bytes of the admitted positions, q, o
    and the table over the card's rate) and one
    scaled_dot_product_attention call, each timed as a CUDA graph of
    back-to-back calls over DECODE_COPIES caches (past the L2); at the
    tensor-core shapes also the CUDA-core kernel on the same inputs
    (``route="simt"``: the kernel before its redesign), its error and its
    time. → the two routes' kernel line entries."""
    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    t0 = time.perf_counter()
    cases = decode_cases(torch)
    results = {"tc": {}, "simt": {}}
    for case in cases:
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))
        pos = torch.arange(case["S"], device=q.device)
        psv = ps if isinstance(ps, int) else ps[:, None]
        case["mask"] = ((pos < lim) & ((pos < pl[:, None]) | (pos >= psv))
                        )[:, None, None, :]
        route = tda._route(q.dtype, q.shape[3],
                           q.shape[1] // case["dense"][0][0].shape[1])

        def kernel(i, case=case, route=None):
            k, v = case["calls"][i % DECODE_COPIES]
            return tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                             table=table, route=route)

        def plain(i, case=case):
            k, v = case["calls"][i % DECODE_COPIES]
            return tda.decode_attention_reference(q, k, v, lim, pl, ps,
                                                  table=table)

        before = dict(tda.decode_attention_cuda.route_launches)
        got, ref = kernel(0), plain(0)
        torch.cuda.synchronize()
        check(tda.decode_attention_cuda.route_launches[route]
              == before[route] + 1,
              f"decode attention {case['label']}: not on the {route} route")
        err = (got.float() - ref.float()).abs().max().item()
        tol = decode_tol(torch, ref)
        lib = sdpa_decode(torch, case, 0)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        check(err <= tol, f"decode attention {case['label']}: max abs err "
                          f"{err} > {tol}")
        if table is not None:
            dense = tda.decode_attention_cuda(q, *case["dense"][0], lim, pl,
                                              ps)
            check(torch.equal(dense, got), f"decode attention "
                                           f"{case['label']}: paged != dense")
        counter = iter(range(10 ** 9))
        ms = graph_ms(torch, lambda: kernel(next(counter)), 40)
        out = {"ms": ms}
        if route == "tc":
            # the CUDA-core kernel on the same inputs: the one before
            out["simt_err"] = (kernel(0, route="simt").float()
                               - ref.float()).abs().max().item()
            check(out["simt_err"] <= tol, f"decode attention "
                                          f"{case['label']}: simt max abs "
                                          f"err {out['simt_err']} > {tol}")
            out["simt_ms"] = graph_ms(torch, lambda: kernel(
                next(counter), route="simt"), 40)
        plain_ms = graph_ms(torch, lambda: plain(next(counter)), 8)
        lib_ms = graph_ms(torch, lambda: sdpa_decode(
            torch, case, next(counter) % DECODE_COPIES), 20)
        torch.cuda.empty_cache()
        b_ms, b_by = bound(0, case["nbytes"], str(case["dtype"])[6:])
        results[route][case["label"]] = {
            **out, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "max_abs_err": err}
        earlier = (f"; the simt kernel {out['simt_ms']:.4f} ms (max abs err "
                   f"{out['simt_err']:.3e})" if route == "tc" else "")
        say(f"decode attention {case['label']}: q {tuple(q.shape)} "
            f"{str(case['dtype'])[6:]}, {case['admitted']} admitted "
            f"positions of {q.shape[0] * case['S']}; route {route}; max abs "
            f"err {err:.3e} (tol {tol:.3e}; SDPA {lib_err:.3e}); kernel "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{case['nbytes'] / 1e6:.3f} MB), {b_ms / ms:.3f} of it"
            f"{earlier}; plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms "
            f"[{card}]")
    del cases
    torch.cuda.empty_cache()
    tiny = torch.zeros(4, device="cuda")
    say(f"decode attention: a launch's own cost, one kernel zeroing 16 "
        f"bytes timed the same way: "
        f"{graph_ms(torch, lambda: tiny.zero_(), 40):.4f} ms [{card}]")
    say(f"decode attention phase seconds: {time.perf_counter() - t0:.1f}")

    def entry(name, route, source, main):
        return {"name": name, "route": "cuda", "source": source,
                # no Pallas kernel: the f32 casts and einsums (and the
                # paged gather) XLA fuses in the decode step
                "replaces": "tpu_kubernetes/models/decode.py:152",
                "launches": None,        # filled from its main path's run
                **{k: v for k, v in results[route][main].items()
                   if not k.startswith("simt")},
                "at_shapes": results[route]}

    return [entry("decode_attention_tc", "tc",
                  "tpu_kubernetes_torch/csrc/decode_attention_tc.cu",
                  "llama-1b engine, traffic limits, paged"),
            entry("decode_attention", "simt",
                  "tpu_kubernetes_torch/csrc/decode_attention.cu",
                  "llama-test (d 16) bf16")]


# ---------------------------------------------------------------------------
# speculation: the chunk route of decode attention, the verify rounds
# ---------------------------------------------------------------------------

SPEC_K = 8                  # SERVE_DRAFT_K's default: verify windows of 9
SPEC_CHUNKS = (2, 5, 9, 16)  # the chunk route's c, held to plain
SPEC_TURNS = 2              # counted turns of each engine variant
SPEC_BUDGET = 64            # the solo lookup request's tokens


def shuffled_table(torch, b: int, S: int, seed: int):
    """A (b, S / DECODE_PAGE) int32 page table on the card: the pool's
    pages 1.. shuffled from a seed (page 0 is the sink)."""
    mp = S // DECODE_PAGE
    perm = torch.randperm(b * mp, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    return perm.reshape(b, mp).to(torch.int32).to("cuda")


def to_pool(torch, t, table):
    """A dense cache (b, kv, S, d) moved into a pool of DECODE_PAGE pages
    through ``table`` (b, S / DECODE_PAGE), page 0 the sink."""
    b, kv, S, d = t.shape
    mp = S // DECODE_PAGE
    pool = torch.zeros((b * mp + 1, kv, DECODE_PAGE, d), dtype=t.dtype,
                       device=t.device)
    pool[table.long().reshape(-1)] = t.reshape(
        b, kv, mp, DECODE_PAGE, d).transpose(1, 2).reshape(
        -1, kv, DECODE_PAGE, d)
    return pool


def chunk_case(torch, label, cfg, b, S, c, dtype, rows, paged=False,
               uniform=False, copies=1, seed=0):
    """A verify window of c positions a row at a model's widths: q (b, h,
    c, d) and ``copies`` dense caches (b, kv, S, d) from a seed; ``rows``
    gives each row's (pos, prompt length, prompt width), chunk row j
    admitting the slots below pos + 1 + j less the pad gap; ``uniform``:
    (c,) limits from row 0's pos and no gap (a uniform cache's chunk);
    ``paged``: every copy through one shuffled table of DECODE_PAGE
    pages. Besides, copy 0 with NaN in every slot no column admits (an
    earlier round's rejected window, the gap, the span past the window).
    → a dict of the calls' arguments, the bytes once and the column
    groups of the tc route."""
    dev = torch.device("cuda")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, c, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor([r[0] for r in rows], device=dev)
    off = torch.arange(c, device=dev)
    slot = torch.arange(S, device=dev)
    if uniform:
        limits, pl, ps = pos[0] + 1 + off, None, None
        admitted = (slot < limits[-1]).expand(b, S)
        mask = slot < limits[:, None]                       # (c, S)
        mask = mask[None, None].expand(b, 1, c, S)
    else:
        limits = pos[:, None] + 1 + off
        pl = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        ps = torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev)
        real = (slot < pl[:, None]) | (slot >= ps[:, None])
        admitted = (slot < limits[:, -1:]) & real
        mask = ((slot < limits[..., None]) & real[:, None])[:, None]
    dense = [tuple(torch.randn((b, kv, S, d), generator=g, device=dev)
                   .to(dtype) for _ in range(2)) for _ in range(copies)]
    nan = ~admitted[:, None, :, None]
    poisoned = tuple(t.masked_fill(nan, float("nan")) for t in dense[0])
    table = None
    calls = list(dense)
    if paged:
        table = shuffled_table(torch, b, S, seed)
        calls = [tuple(to_pool(torch, t, table) for t in kv_) for kv_ in
                 dense]
        poisoned = tuple(to_pool(torch, t, table) for t in poisoned)
    item = torch.empty((), dtype=dtype).element_size()
    n_adm = int(admitted.sum())
    cols = h // kv * c
    groups = 1 if cols <= 8 else -(-cols // 16)
    nbytes = (2 * b * h * c * d) * item + (b * S // DECODE_PAGE * 4
                                           if paged else 0)
    return {"label": label, "q": q, "limits": limits, "pl": pl, "ps": ps,
            "table": table, "calls": calls, "dense": dense,
            "poisoned": poisoned, "mask": mask, "dtype": dtype, "S": S,
            "c": c, "admitted": n_adm, "groups": groups,
            "nbytes": nbytes + 2 * n_adm * kv * d * item,
            "nbytes_groups": nbytes + 2 * n_adm * kv * d * item * groups}


def chunk_check(torch, tda, case, route) -> tuple:
    """The case's kernel call on ``route`` against the plain version on
    the clean caches, the NaN-poisoned copy giving the same output, and
    paged bitwise dense → (err, tol)."""
    q, lim, pl, ps = (case[k] for k in ("q", "limits", "pl", "ps"))
    k, v = case["calls"][0]
    before = dict(tda.decode_attention_cuda.chunk_launches)
    got = tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                    table=case["table"], route=route)
    ref = tda.decode_attention_reference(q, k, v, lim, pl, ps,
                                         table=case["table"])
    nan = tda.decode_attention_cuda(q, *case["poisoned"], lim, pl, ps,
                                    table=case["table"], route=route)
    torch.cuda.synchronize()
    label = f"chunk route {case['label']} c={case['c']} {route}"
    check(tda.decode_attention_cuda.chunk_launches[route]
          == before[route] + 2, f"{label}: not counted on its route")
    err = (got.float() - ref.float()).abs().max().item()
    tol = decode_tol(torch, ref)
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    check(torch.equal(nan, got), f"{label}: NaN in slots no column admits "
                                 f"changed the output")
    if case["table"] is not None:
        dense = tda.decode_attention_cuda(q, *case["dense"][0], lim, pl, ps,
                                          route=route)
        check(torch.equal(dense, got), f"{label}: paged != dense")
    return err, tol


def spec_kernel(torch, card) -> list:
    """(a) The chunk route against its plain version: llama-1b's engine
    verify (8 rows at the engine traffic's positions) at c in SPEC_CHUNKS
    on both routes, dense and paged, and uniform (one row at 1,033 of
    1,088: a solo lookup chunk); llama-70b's widths (rep 8, 72 columns),
    8 × 4,096 paged at c 9; llama-test f32 (simt's main path) at each c.
    NaN in every slot no column admits; dense == paged bitwise. At c 9:
    kernel ms, the plain version's, the bound (admitted K/V once, and
    once a column group, q, o, table over the card's rate) and one SDPA
    call with a boolean mask over the repeat_kv'd cache, each a CUDA
    graph of calls over DECODE_COPIES caches. → the two chunk entries of
    the kernel line."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.llama import repeat_kv
    from tpu_kubernetes_torch.serve.server import _bucket

    import torch.nn.functional as F

    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    t0 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    llama, test = CONFIGS["llama-1b"], CONFIGS["llama-test"]
    reqs = engine_requests(torch, llama, ENGINE_SLOTS, seed=1)
    # the engine traffic's rows mid-decode: each at width + half its budget
    engine_rows = [(_bucket(len(ids)) + budget // 2, len(ids),
                    _bucket(len(ids))) for ids, budget in reqs]
    test_rows = [(100, 40, 64), (20, 5, 16), (9 - 1, 3, 8),
                 (128 - 16, 30, 32)]
    worst = {"tc": 0.0, "simt": 0.0}
    for c in SPEC_CHUNKS:
        for paged in (False, True):
            for case in (chunk_case(torch, "llama-1b engine verify", llama, 8,
                                    2048, c, bf16, engine_rows, paged=paged,
                                    seed=c),
                         chunk_case(torch, "llama-1b uniform chunk", llama, 1,
                                    1088, c, bf16, [(1033 - c, 0, 0)],
                                    paged=paged, uniform=True, seed=c)):
                for route in ("tc", "simt"):
                    err, tol = chunk_check(torch, tda, case, route)
                    worst[route] = max(worst[route], err / tol)
            case = chunk_case(torch, "llama-test f32", test, 4, 128, c, f32,
                              test_rows, paged=paged, seed=c)
            err, tol = chunk_check(torch, tda, case, "simt")
            worst["simt"] = max(worst["simt"], err / tol)
    say(f"chunk route: c in {SPEC_CHUNKS}, tc and simt, dense and paged, "
        f"ragged and uniform, NaN in the slots no column admits: within "
        f"tolerance (worst err / tol: tc {worst['tc']:.3f}, simt "
        f"{worst['simt']:.3f}), paged == dense bitwise [{card}]")
    timed = [
        ("llama-1b engine verify 8 × 9, traffic limits", "tc", dict(
            cfg=llama, b=8, S=2048, dtype=bf16, rows=engine_rows)),
        ("llama-1b engine verify 8 × 9, traffic limits, paged", "tc", dict(
            cfg=llama, b=8, S=2048, dtype=bf16, rows=engine_rows,
            paged=True)),
        ("llama-70b widths (64/8) verify 8 × 9 at 4,096, paged", "tc", dict(
            cfg=CONFIGS["llama-70b"], b=8, S=4096, dtype=bf16,
            rows=[(4096 - 9, 512, 512)] * ENGINE_SLOTS, paged=True)),
        ("llama-test (d 16) f32 verify 4 × 9", "simt", dict(
            cfg=test, b=4, S=128, dtype=f32, rows=test_rows)),
        ("llama-test (d 16) f32 verify 4 × 9, paged", "simt", dict(
            cfg=test, b=4, S=128, dtype=f32, rows=test_rows, paged=True)),
    ]
    results = {"tc": {}, "simt": {}}
    for label, route, kw in timed:
        case = chunk_case(torch, label, c=SPEC_K + 1, copies=DECODE_COPIES,
                          seed=7, **kw)
        err, tol = chunk_check(torch, tda, case, route)
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))
        counter = iter(range(10 ** 9))

        def kernel(r=route):
            k, v = case["calls"][next(counter) % DECODE_COPIES]
            return tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                             table=table, route=r)

        def plain():
            k, v = case["calls"][next(counter) % DECODE_COPIES]
            return tda.decode_attention_reference(q, k, v, lim, pl, ps,
                                                  table=table)

        ms = graph_ms(torch, kernel, 40)
        out = {"ms": ms}
        if route == "tc":
            out["simt_ms"] = graph_ms(torch, lambda: kernel("simt"), 40)
        plain_ms = graph_ms(torch, plain, 8)
        rep = q.shape[1] // case["dense"][0][0].shape[1]
        wide = [tuple(repeat_kv(t, rep).contiguous() for t in kv_)
                for kv_ in case["dense"]]

        def sdpa():
            k, v = wide[next(counter) % DECODE_COPIES]
            return F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=case["mask"])

        lib_ms = graph_ms(torch, sdpa, 20)
        lib = F.scaled_dot_product_attention(q, *wide[0],
                                             attn_mask=case["mask"])
        lib_err = (lib.float() - tda.decode_attention_reference(
            q, *case["dense"][0], lim, pl, ps).float()).abs().max().item()
        del wide, lib
        torch.cuda.empty_cache()
        b_ms, b_by = bound(0, case["nbytes"], str(case["dtype"])[6:])
        g_ms, _ = bound(0, case["nbytes_groups"], str(case["dtype"])[6:])
        results[route][label] = {
            **out, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_groups_ms": g_ms, "library_ms": lib_ms,
            "max_abs_err": err}
        also = (f"; the simt kernel {out['simt_ms']:.4f} ms"
                if route == "tc" else "")
        tc_groups = (f", {case['groups']} column group(s)" if route == "tc"
                     else "")
        say(f"chunk route {label}: q {tuple(q.shape)} "
            f"{str(case['dtype'])[6:]}, {case['admitted']} admitted "
            f"positions{tc_groups}; route {route}; max abs err {err:.3e} (tol {tol:.3e}; SDPA "
            f"{lib_err:.3e}); kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {b_ms / ms:.3f} of it; once a column group "
            f"{g_ms:.4f}){also}; plain {plain_ms:.4f} ms; SDPA (masked, "
            f"repeat_kv'd cache) {lib_ms:.4f} ms [{card}]")
        del case
        torch.cuda.empty_cache()
    say(f"chunk route kernel seconds: {time.perf_counter() - t0:.1f}")

    def entry(name, route, source, main):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "tpu_kubernetes/models/decode.py:152",
                "launches": None,
                **{k: v for k, v in results[route][main].items()
                   if k not in ("simt_ms", "bound_groups_ms")},
                "at_shapes": results[route]}

    return [entry("decode_attention_tc_chunk", "tc",
                  "tpu_kubernetes_torch/csrc/decode_attention_tc.cu",
                  "llama-1b engine verify 8 × 9, traffic limits, paged"),
            entry("decode_attention_chunk", "simt",
                  "tpu_kubernetes_torch/csrc/decode_attention.cu",
                  "llama-test (d 16) f32 verify 4 × 9")]


def spec_engine_class():
    """ContinuousEngine timing each segment's or round's launch with CUDA
    events, and with ``oracle`` (ids → the plain engine's tokens) the
    perfect proposer: a row's proposals are its next plain-engine tokens,
    and each round's emission a live row is recorded against k + 1."""
    import torch

    from tpu_kubernetes_torch.serve.server import ContinuousEngine

    class SpecEngine(ContinuousEngine):
        def __init__(self, *a, oracle=None, **kw):
            super().__init__(*a, **kw)
            self.oracle, self.events, self.row_rounds = oracle, [], []
            self._last = {}

        def launch_segment(self):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().launch_segment()
            end.record()
            self.events.append((start, end))
            return out

        def device_ms(self) -> list:
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in self.events]
            self.events = []
            return ms

        def _refill_proposal(self, slot):
            if self.oracle is None:
                return super()._refill_proposal(slot)
            entry, done = self._entries[slot], self._collected[slot]
            last = self._last.get(slot)
            if last is not None and last[0] is entry:
                # (emitted, what a perfect draft emits: k + 1 but the budget)
                self.row_rounds.append((len(done) - last[1],
                                        min(self.draft_k + 1, last[2])))
            self._last[slot] = (entry, len(done), int(self._rem[slot]))
            ref = self.oracle[tuple(entry["ids"])]
            cont = ref[len(done):len(done) + self.draft_k]
            self._proposals[slot] = cont + [ref[-1]] * (self.draft_k
                                                        - len(cont))

    return SpecEngine


SPEC_SETTLE = 4    # uncounted turns a perfect draft may take to settle


def settle_perfect_draft(eng, requests, label: str) -> None:
    """Turn the perfect draft's proposals into the engine's own tokens: in
    bf16 a round's rounding follows its window, so the engine's tokens
    part from the plain engine's at near-ties, and a request whose
    proposals part from its tokens runs short rounds from there on, on
    windows the next turn (with full rounds) does not share. Uncounted
    turns, each proposing the last one's tokens, until a turn's tokens
    are its proposals: then every round is full, and each later turn runs
    the same windows and gives the same tokens."""
    for turn in range(1, SPEC_SETTLE + 1):
        got, _ = engine_turn(eng, requests)
        mine = {tuple(ids): toks for (ids, _), toks in zip(requests, got)}
        parted = sum(mine[k] != eng.oracle[k] for k in mine)
        eng.oracle.update(mine)
        eng.device_ms()
        if not parted:
            eng.settle_turns = turn
            return
    raise SmokeError(f"{label}: the perfect draft's tokens did not settle "
                     f"in {SPEC_SETTLE} turns ({parted} requests parted)")


def spec_engine(torch, fa, card) -> dict:
    """(b) The llama-1b slot engine (full width and depth, bf16, 8 slots,
    segments of 8 rounds) on the engine phases' traffic, the plain engine
    against speculation with SPEC_K = 8: n-gram lookup, a random
    llama-125m draft (seed 1) and the perfect draft (each request's
    plain-engine tokens as proposals, settled into its own tokens first:
    settle_perfect_draft), dense, then paged (a pool as large as the dense
    cache): tokens equal to the plain engine's up to the near-tie rule;
    every round of a live row of the perfect draft's counted turns emits
    k + 1 tokens (or the rest of its budget); ms a round (CUDA events
    around each replay) against ms a plain step; tokens a round; tokens/s
    against the plain engine in the same turns (the random draft, host
    bound, runs one counted turn, which takes its draft's captures); one
    capture a key. → {"counts": the paged n-gram
    engine's counted turn, the main path of the tc chunk route, "dense":
    the dense n-gram engine's}."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve.server import GreedyLane

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    dcfg = CONFIGS["llama-125m"]
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(1),
                          dev)
    requests = engine_requests(torch, cfg, 16, seed=1)
    pool_mb = (ENGINE_SLOTS * (cfg.max_seq // DECODE_PAGE)
               * page_bytes(cfg, DECODE_PAGE) / 2 ** 20)
    SpecEngine = spec_engine_class()

    def engine(spec=None, mb=0.0, **kw):
        draft = GreedyLane(dparams, dcfg) if spec == "draft" else None
        return SpecEngine(GreedyLane(params, cfg), slots=ENGINE_SLOTS,
                          seg_steps=ENGINE_STEPS, pool_mb=mb,
                          page_size=DECODE_PAGE, spec=spec, draft_k=SPEC_K,
                          draft=draft, **kw)

    plain = engine()
    plain.warm()
    ref, _ = engine_turn(plain, requests)
    oracle = {tuple(ids): toks for (ids, _), toks in zip(requests, ref)}
    variants = {"plain": plain}
    for mb, tag in ((0.0, ""), (pool_mb, " paged")):
        variants[f"ngram{tag}"] = engine("ngram", mb)
        variants[f"draft{tag}"] = engine("draft", mb)
        variants[f"perfect{tag}"] = engine("ngram", mb, oracle=dict(oracle))
    walls = {v: [] for v in variants}
    stats = {v: {"ms": [], "rounds": 0, "tokens": 0} for v in variants}
    diverged = {v: 0 for v in variants}
    memo, counts = {}, {}
    total = sum(len(t) for t in ref)
    for turn in range(SPEC_TURNS + 1):       # turn 0 captures, uncounted
        for v, eng in variants.items():
            if "draft" in v and turn > 1:
                continue                     # host-bound: one counted turn
            if turn == 0:
                if v != "plain":
                    eng.warm()
                eng.device_ms()
                if eng.oracle is not None:
                    settle_perfect_draft(eng, requests, v)
                if eng.oracle is not None or "draft" in v:
                    # the random draft's counted turn takes the captures
                    # of the draft's widths that warm() leaves
                    continue
            before = dict(eng.spec_totals)
            segs = eng.segments
            eng.row_rounds = []
            if turn == 1 and v in ("ngram", "ngram paged"):
                reset_counts(fa)
            got, wall = engine_turn(eng, requests)
            if turn == 1 and v in ("ngram", "ngram paged"):
                counts[v] = read_counts(fa)
            ms = eng.device_ms()
            if v != "plain":
                label = f"llama-1b engine, {v} speculation"
                diverged[v] = near_tie_divergences(
                    torch, params, cfg, label, requests, got, ref, memo)
            if eng.oracle is not None and turn > 0:
                # proposals that are the engine's own settled tokens: every
                # round of a live row emits k + 1 (or the rest of its budget)
                parted = sum(toks != eng.oracle[tuple(ids)]
                             for (ids, _), toks in zip(requests, got))
                full = sum(n == want for n, want in eng.row_rounds)
                check(parted == 0 and full == len(eng.row_rounds),
                      f"{v} turn {turn}: {full} of {len(eng.row_rounds)} "
                      f"rounds a live row emitted k + 1 (or the rest of the "
                      f"budget), {parted} requests parted from their "
                      f"proposals")
                eng.full = (full, len(eng.row_rounds))
            if turn == 0:
                continue
            walls[v].append(wall)
            st = stats[v]
            st["ms"] += ms
            st["rounds"] += (eng.spec_totals["rounds"] - before["rounds"]
                             if v != "plain" else
                             (eng.segments - segs) * ENGINE_STEPS)
            st["tokens"] += sum(len(t) for t in got)
    base = sum(walls["plain"]) / len(walls["plain"])
    plain_step = statistics.median(stats["plain"]["ms"]) / ENGINE_STEPS
    for v, st in stats.items():
        eng = variants[v]
        caps = eng.lane.programs.captures
        check(set(caps.values()) == {1}, f"{v}: captures {caps}")
        wall = sum(walls[v]) / len(walls[v])
        if v == "plain":
            say(f"llama-1b engine, plain: {total} tokens a turn, "
                f"{total / wall:.1f} tokens/s (walls {spread(walls[v])} s), "
                f"ms a step {plain_step:.3f} (device, a segment's median / "
                f"{ENGINE_STEPS}) [{card}]")
            continue
        key = ("verify_paged" if eng.paged else "verify", ENGINE_SLOTS,
               SPEC_K)
        round_ms = statistics.median(st["ms"]) if st["ms"] else 0.0
        tps = st["tokens"] / sum(walls[v])
        per_round = st["tokens"] / max(1, st["rounds"])
        extra = ""
        if eng.oracle is not None:
            extra = (f"; every counted turn's rounds a live row emitted k + "
                     f"1 (or the rest of the budget): {eng.full[0]} of "
                     f"{eng.full[1]} in the last, settled in "
                     f"{eng.settle_turns} uncounted turns")
        say(f"llama-1b engine, {v} speculation (k={SPEC_K}): tokens "
            f"{'equal to' if not diverged[v] else 'near-tie divergences from'}"
            f" the plain engine's ({diverged[v]} requests); ms a round "
            f"{round_ms:.3f} (device, median of {len(st['ms'])}; "
            f"{round_ms / plain_step:.2f} plain steps), tokens a round "
            f"{per_round:.2f} (all 8 slots), tokens/s {tps:.1f} against the "
            f"plain engine's {total / base:.1f} in the same turns "
            f"({tps * base / total:.2f}×); totals {eng.spec_totals}; "
            f"captures {len(caps)} keys × 1, {key} replays "
            f"{eng.lane.programs.replays.get(key)}{extra} [{card}]")
        if eng._draft is not None:
            dcaps = eng._draft.programs.captures
            check(set(dcaps.values()) == {1}, f"{v}: draft captures {dcaps}")
            say(f"{v}: draft programs {sorted(dcaps)} captured once each")
    for v, c in counts.items():
        chunk = c["decode_attention.tc.chunk"]
        check(chunk > 0 and chunk == c["decode_attention.tc"]
              and chunk % L == 0,
              f"{v} engine: every decode-attention launch of a round must "
              f"be the chunk route's, one a layer: {c}")
        check(c["flash_fwd.tc"] > 0 and c["flash_fwd.simt"] == 0
              and c["decode_attention.simt"] == 0,
              f"{v} engine launches {c}")
        say(f"llama-1b engine, {v}: a counted turn launched "
            f"decode_attention_tc's chunk route {chunk} times "
            f"({chunk // L} rounds × {L} layers); launches {c}")
    for eng in variants.values():
        eng.close()
    del variants, params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    say(f"speculation engine seconds: {time.perf_counter() - t0:.1f}")
    return {"counts": counts["ngram paged"], "dense": counts["ngram"]}


def spec_solo(torch, fa, card) -> dict:
    """(c) The solo lookup lane at llama-1b, batch 1: a prompt of 1,000
    real tokens (a 50-token block 20 times, width 1,024), SPEC_BUDGET
    tokens: the lookup rounds (one graphed verify chunk of 9 a round over
    the ragged cache, its end at an arbitrary slot past 1,024) against the
    non-speculative greedy lane, tokens equal up to the near-tie rule,
    walls in turns. → the counted lookup request's launches."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.serve.server import GreedyLane, _pad_rows

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    L = cfg.n_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(1, cfg.vocab_size, (50,), generator=g).tolist() * 20
    width, run = solo_shape(ids, SPEC_BUDGET)
    lane = GreedyLane(params, cfg)
    rows = _pad_rows([ids], width)
    lengths = torch.tensor([len(ids)], dtype=torch.int32)
    walls = {"plain": [], "lookup": []}
    counts, finish = None, {}
    for turn in range(SPEC_TURNS + 1):
        t0 = time.perf_counter()
        st = lane.prefill(rows, lengths, width + run)
        plain, _ = lane.decode_greedy(st, [SPEC_BUDGET], ENGINE_STEPS)
        plain = plain[0][:SPEC_BUDGET]
        walls["plain"].append(time.perf_counter() - t0)
        if turn == 1:
            reset_counts(fa)
        t0 = time.perf_counter()
        finish = {}
        spec = [t for new in lane.lookup_rounds(
            ids, width, width + run + SPEC_K, SPEC_BUDGET, SPEC_K, 2, finish)
            for t in new]
        walls["lookup"].append(time.perf_counter() - t0)
        if turn == 1:
            counts = read_counts(fa)
    near_tie_divergences(torch, params, cfg, "llama-1b solo lookup",
                         [(ids, SPEC_BUDGET)], [spec], [plain])
    rounds = finish["spec"]["rounds"] - 1
    chunk = counts["decode_attention.tc.chunk"]
    check(chunk == rounds * L, f"solo lookup: {chunk} chunk launches for "
                               f"{rounds} rounds of {L} layers")
    caps = lane.programs.captures
    check(set(caps.values()) == {1}, f"solo lookup captures {caps}")
    say(f"llama-1b solo lookup lane (1,000-token prompt, {SPEC_BUDGET} "
        f"tokens, k={SPEC_K}): tokens {'equal to' if spec == plain else 'DIFFER from'} "
        f"the plain lane's; {finish['spec']}; chunk launches {chunk}; "
        f"walls lookup {spread(walls['lookup'][1:])} s, plain "
        f"{spread(walls['plain'][1:])} s (turn 0 captures) [{card}]")
    del lane, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


SPEC_HTTP = [{"prompt": "the cat sat on the mat. the cat sat on the mat. "
                        "the cat", "max_tokens": 24},
             {"prompt": "hello from the card", "max_tokens": 8}]


def spec_http(torch, fa) -> dict:
    """(d) HTTP at llama-test f32: SERVE_PROMPT_LOOKUP=1 solo, with
    SERVE_CONTINUOUS_BATCHING=1, and SERVE_DRAFT_MODEL=llama-test with the
    engine: each completion's and each stream's token ids equal the plain
    solo server's; /healthz carries the speculation totals. → the solo
    lookup server's launches (the simt chunk route)."""
    env = {**HTTP_ENV, "SERVE_DTYPE": "float32"}

    def run(extra):
        with serving({**env, **extra}) as (state, port):
            seen = record_ids(state)
            ids = []
            for body in SPEC_HTTP:
                code, out = _request(port, "POST", "/v1/completions", body)
                check(code == 200, f"/v1/completions {extra} {code}: {out}")
                ids.append(seen[-1])
                sse_text(port, "/v1/completions", body)
                ids.append(seen[-1])
            code, health = _request(port, "GET", "/healthz")
        return ids, health.get("prompt_lookup")

    want, _ = run({})
    out = {}
    for name, extra in (("lookup", {"SERVE_PROMPT_LOOKUP": "1"}),
                        ("lookup engine", {"SERVE_PROMPT_LOOKUP": "1",
                                           "SERVE_CONTINUOUS_BATCHING": "1"}),
                        ("draft engine", {"SERVE_DRAFT_MODEL": "llama-test",
                                          "SERVE_CONTINUOUS_BATCHING": "1"})):
        if name == "lookup":
            reset_counts(fa)
        got, spec = run(extra)
        if name == "lookup":
            out = read_counts(fa)
        say(f"http llama-test f32 {name}: completion and stream ids "
            f"{'equal to' if got == want else 'DIFFER from'} the plain solo "
            f"server's; /healthz prompt_lookup {spec}")
        check(got == want, f"http {name}: ids {got} != plain {want}")
        check(spec is not None and spec["rounds"] > 0,
              f"http {name}: /healthz prompt_lookup {spec}")
    check(out["decode_attention.simt.chunk"] > 0
          and out["decode_attention.tc"] == 0,
          f"http lookup launches {out}")
    return out


def spec_job(torch, fa, card) -> dict:
    """(e) run_serving at llama-test f32 on the 11 prompts of the job
    phase: the lookup (k 8) and draft (llama-test, k 4) modes equal the
    plain greedy job's at the speculative span, one capture a key. → the
    lookup run's launches."""
    import tempfile

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.speculative import spec_width
    from tpu_kubernetes_torch.serve import job

    room = CONFIGS[SERVE_JOB_ENV["SERVE_MODEL"]].max_seq
    width = max(len(p.encode()) for p in SERVE_JOB_PROMPTS)
    new = int(SERVE_JOB_ENV["SERVE_MAX_NEW"])
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        prompts = Path(tmp) / "prompts.txt"
        prompts.write_text("\n".join(SERVE_JOB_PROMPTS) + "\n")
        env = {**SERVE_JOB_ENV, "SERVE_PROMPTS": str(prompts),
               "SERVE_OUT": str(Path(tmp) / "o.txt")}
        for mode, k, extra in (("lookup", 8, {"SERVE_PROMPT_LOOKUP": "1"}),
                               ("draft", 4,
                                {"SERVE_DRAFT_MODEL": "llama-test"})):
            plain, _, _ = run_serving_logged(job, {
                **env, "SERVE_CACHE_SPAN": str(width + new + k)})
            if mode == "lookup":
                reset_counts(fa)
            spec, caps, reps = run_serving_logged(job, {**env, **extra})
            if mode == "lookup":
                counts = read_counts(fa)
            same = sum(a == b for a, b in zip(spec, plain))
            say(f"run_serving llama-test f32 {mode} (k={k}): "
                f"{same} of {len(plain)} completions equal to the plain "
                f"greedy job's at span {width + new + k}; captures "
                f"{len(caps)} keys × {set(caps.values())}, replays "
                f"{sum(reps.values())} [{card}]")
            check(same == len(plain), f"run_serving {mode} differs")
            check(set(caps.values()) == {1}, f"run_serving {mode} captures "
                                             f"{caps}")
            # one prefill and one round program a width bucket, whatever
            # the number of prompt lengths
            buckets = {spec_width(len(p.encode()), room - new - k)
                       for p in SERVE_JOB_PROMPTS}
            check(len(caps) == 2 * len(buckets),
                  f"run_serving {mode}: {len(caps)} program keys for "
                  f"{len(buckets)} width buckets")
    check(counts["decode_attention.simt.chunk"] > 0,
          f"run_serving lookup launches {counts}")
    return counts


def phase_speculation(torch, fa, card: str) -> tuple[list, dict]:
    """Speculative decoding on the card: (a) the chunk route of decode
    attention (spec_kernel), (b) the llama-1b engine's verify rounds
    (spec_engine), (c) the solo lookup lane at llama-1b (spec_solo), (d)
    HTTP (spec_http) and (e) run_serving (spec_job) at llama-test f32.
    → (the chunk entries of the kernel line, each path's launch counts)."""
    t0 = time.perf_counter()
    entries = spec_kernel(torch, card)
    engine = spec_engine(torch, fa, card)
    paths = {"llama_spec_paged_engine_16_requests": engine["counts"],
             "llama_spec_engine_16_requests": engine["dense"],
             "llama_spec_solo_lookup": spec_solo(torch, fa, card),
             "http_speculation": spec_http(torch, fa),
             "serve_job_speculation": spec_job(torch, fa, card)}
    say(f"speculation phase seconds: {time.perf_counter() - t0:.1f}")
    return entries, paths



# ---------------------------------------------------------------------------
# int8 serving: the weight-only int8 matmul, decode attention's q8 route,
# llama-1b on int8 weights and an int8 KV cache, moe-1b on int8 weights,
# and the int8 knobs over HTTP
# ---------------------------------------------------------------------------

# llama-1b's weight products (K, N) and llama-test's, in f32
W8_LLAMA = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048),
            (2048, 32000))
W8_TEST = ((64, 64), (64, 32), (64, 128), (128, 64), (64, 256))
W8_ROWS = (4, 8, 72)       # a decode step of 4 or 8 rows, a verify window
W8_MAIN = "llama-1b 2048x5632, 8 rows"
W8_FORCED = (2048, 5632)   # the bf16 shape the CUDA-core kernel is timed at
W8_TEST_MAIN = "llama-test 64x64, 8 rows"   # the CUDA-core kernel's f32
INT8_POOL_PAGES = 1024     # the engine's pool, as the bf16 paged engine's


def w8_tol(torch, ref):
    """The w8 kernel's elementwise tolerance against the plain version:
    bf16, one bf16 ulp of the output (2^-7 of it), of at least 1% of its
    row's largest output: the two f32 sum orders differ by about K * 2^-24
    of the summands, which is below an ulp of the row's scale but not of
    a cancelled near-zero output; f32, 1e-5 of the row's largest."""
    r = ref.float().abs()
    rowmax = r.amax(dim=1, keepdim=True)
    if ref.dtype == torch.bfloat16:
        return 2.0 ** -7 * torch.maximum(r, 1e-2 * rowmax)
    return 1e-5 * rowmax


def int8pack_ms(torch, x, q, s, weights) -> float | None:
    """The yardstick torch._weight_int8pack_mm (x @ (int8 weight * scale),
    the weight (N, K)), timed like the kernel over the same weights, where
    the card's torch has a CUDA kernel for it; else None."""
    packed = [(lf["q"].t().contiguous(), lf["s"].reshape(-1).to(x.dtype))
              for lf in weights]
    try:
        torch._weight_int8pack_mm(x, *packed[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    counter = iter(range(10 ** 9))
    return graph_ms(torch, lambda: torch._weight_int8pack_mm(
        x, *packed[next(counter) % DECODE_COPIES]), 40)


def w8_kernel(torch, card) -> list:
    """The weight-only int8 matmul at each of llama-1b's weight shapes in
    bf16 (its own route, the tensor cores) and llama-test's in f32 (its
    own, the CUDA cores), and the CUDA-core kernel forced at W8_FORCED, at
    4, 8 and 72 rows: each against the plain version (the weight
    dequantized in the rows' dtype, then x @ W) within w8_tol, and a 72-row
    call equal to the 8-row call row for row, bit for bit (and 8 to 4). At
    8 rows: each route's time over DECODE_COPIES weights (past the L2), the
    plain version's, the bound (the int8 weight and its scales, x and y
    over the card's rate), the yardstick, a torch.matmul by a weight of the
    rows' dtype and shape, and torch._weight_int8pack_mm where the card's
    torch has it (library_ms). → the kernel line entries of the tensor-core
    kernel (w8_matmul_tc) and the CUDA-core kernel (w8_matmul)."""
    from tpu_kubernetes_torch.models.quant import _quantize_leaf

    tw8 = importlib.import_module("tpu_kubernetes_torch.ops.w8_matmul")
    dev = torch.device("cuda")
    results = {"tc": {}, "gemv": {}}
    for dtype, name, shapes in ((torch.bfloat16, "llama-1b", W8_LLAMA),
                                (torch.float32, "llama-test", W8_TEST)):
        for K, N in shapes:
            g = torch.Generator(device=dev).manual_seed(K + N)
            ws = [torch.randn((K, N), generator=g, device=dev) * 0.02
                  for _ in range(DECODE_COPIES)]
            leaves = [_quantize_leaf(w) for w in ws]
            wide = [w.to(dtype) for w in ws]
            del ws
            x = torch.randn((max(W8_ROWS), K), generator=g,
                            device=dev).to(dtype)
            q, s = leaves[0]["q"], leaves[0]["s"]
            ref = tw8.w8_matmul_reference(x, q, s)
            m = 8
            xm = x[:m].contiguous()
            counter = iter(range(10 ** 9))

            def plain():
                leaf = leaves[next(counter) % DECODE_COPIES]
                return tw8.w8_matmul_reference(xm, leaf["q"], leaf["s"])

            def yard():
                return xm @ wide[next(counter) % DECODE_COPIES]

            plain_ms = graph_ms(torch, plain, 10)
            yard_ms = graph_ms(torch, yard, 40)
            lib_ms = int8pack_ms(torch, xm, q, s, leaves)
            item = x.element_size()
            nbytes = K * N + 4 * N + m * (K + N) * item
            b_ms, b_by = bound(2 * m * K * N, nbytes, str(dtype)[6:])
            own = tw8._route(dtype, m, K, N)
            routes = [own] + (["gemv"] if (dtype, (K, N)) == (
                torch.bfloat16, W8_FORCED) else [])
            for route in routes:
                forced = None if route == own else route
                before = tw8.w8_matmul_cuda.route_launches[route]
                ys = {r: tw8.w8_matmul_cuda(x[:r].contiguous(), q, s,
                                            route=forced) for r in W8_ROWS}
                torch.cuda.synchronize()
                label = f"{name} {K}x{N}, {m} rows"
                check(tw8.w8_matmul_cuda.route_launches[route]
                      == before + len(W8_ROWS),
                      f"w8_matmul {label}: not on the {route} route")
                check(torch.equal(ys[72][:8], ys[8]) and torch.equal(
                    ys[8][:4], ys[4]), f"w8_matmul {route} {label}: a row's "
                                       f"output depends on the row count")
                diff = (ys[72].float() - ref.float()).abs()
                err = diff.max().item()
                check(bool((diff <= w8_tol(torch, ref)).all()),
                      f"w8_matmul {route} {label}: max abs err {err} beyond "
                      f"one ulp of the output")

                def kernel(forced=forced):
                    leaf = leaves[next(counter) % DECODE_COPIES]
                    return tw8.w8_matmul_cuda(xm, leaf["q"], leaf["s"],
                                              route=forced)

                ms = graph_ms(torch, kernel, 40)
                results[route][label] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms,
                    "max_abs_err": err, "matmul_ms": yard_ms,
                    "forced": forced is not None}
                lib = (f"; torch._weight_int8pack_mm {lib_ms:.4f} ms"
                       if lib_ms is not None else
                       "; torch._weight_int8pack_mm: no CUDA kernel")
                say(f"w8_matmul {route}{' (forced)' if forced else ''} "
                    f"{label} {str(dtype)[6:]}: max abs err {err:.3e} at 72 "
                    f"rows (72 = 8 = 4 rows bitwise); kernel {ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.3f} MB), "
                    f"{b_ms / ms:.3f} of it; plain (dequantize + matmul) "
                    f"{plain_ms:.4f} ms; the {str(dtype)[6:]} torch.matmul "
                    f"by a weight of that dtype {yard_ms:.4f} ms{lib} "
                    f"[{card}]")
                del ys
            del leaves, wide, x, ref
            torch.cuda.empty_cache()
    # no Pallas kernel: weight() dequantizes, XLA fuses it into the dot
    return [{"name": "w8_matmul_tc", "route": "cuda",
             "source": "tpu_kubernetes_torch/csrc/w8_matmul_tc.cu",
             "replaces": "tpu_kubernetes/models/quant.py:58",
             "launches": None, **results["tc"][W8_MAIN],
             "at_shapes": results["tc"]},
            {"name": "w8_matmul", "route": "cuda",
             "source": "tpu_kubernetes_torch/csrc/w8_matmul.cu",
             "replaces": "tpu_kubernetes/models/quant.py:58",
             "launches": None, **results["gemv"][W8_TEST_MAIN],
             "at_shapes": results["gemv"]}]


def q8_case(torch, label, cfg, b, S, c, dtype, rows, paged, seed=0):
    """One call of decode attention's int8 route at a model's widths: q
    (b, h, c, d) and DECODE_COPIES int8 caches (b, kv, S, d) with their
    scales, quantized from seeded normal K/V as the cache stores them;
    ``rows`` gives each row's (limit of its last chunk position, prompt
    length, prompt width); ``paged`` moves every cache and its scales into
    a pool of DECODE_PAGE pages through one shuffled table. Besides, the
    bf16 caches dequantized from them, in the same layout (the yardstick
    decode_attention_tc's input). → the call's arguments and the bytes it
    needs."""
    from tpu_kubernetes_torch.models.decode import _quantize_kv

    dev = torch.device("cuda")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, c, d), generator=g, device=dev).to(dtype)
    last = torch.tensor([r[0] for r in rows], device=dev)
    limits = last[:, None] - c + 1 + torch.arange(c, device=dev)[None, :]
    pl = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    ps = torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev)
    dense = []
    for _ in range(DECODE_COPIES):
        k8, ks = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                          device=dev))
        v8, vs = _quantize_kv(torch.randn((b, kv, S, d), generator=g,
                                          device=dev))
        dense.append((k8, v8, ks, vs))
    wide = [tuple((a.float() * sc[..., None]).to(torch.bfloat16)
                  for a, sc in ((k8, ks), (v8, vs)))
            for k8, v8, ks, vs in dense]
    table, calls = None, dense
    if paged:
        table = shuffled_table(torch, b, S, seed)
        calls = [tuple(to_pool(torch, t, table) if t.dim() == 4 else
                       to_pool(torch, t[..., None], table)[..., 0]
                       for t in copy) for copy in dense]
        wide = [tuple(to_pool(torch, t, table) for t in copy)
                for copy in wide]
    gap = [max(0, min(r[0], r[2]) - r[1]) for r in rows]
    admitted = sum(min(r[0], S) - gp for r, gp in zip(rows, gap))
    item = q.element_size()
    nbytes = (2 * admitted * kv * (d + 4) + 2 * b * h * c * d * item
              + (b * (S // DECODE_PAGE) * 4 if paged else 0))
    return {"label": label, "q": q, "limits": limits, "pl": pl, "ps": ps,
            "table": table, "calls": calls, "dense": dense, "wide": wide,
            "nbytes": nbytes, "admitted": admitted, "S": S}


def q8_cases(torch) -> list:
    """decode_attention_q8's shapes: llama-1b's engine traffic limits,
    dense and paged, one position a row and a verify window of 9; every
    row at the full 2,048; moe-1b's d 64; llama-test's d 16 in f32."""
    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.serve.server import _bucket

    bf16 = torch.bfloat16
    llama, moe = CONFIGS["llama-1b"], CONFIGS["moe-1b"]
    test = CONFIGS["llama-test"]
    reqs = engine_requests(torch, llama, ENGINE_SLOTS, seed=1)
    engine_rows = [(_bucket(len(ids)) + budget // 2 + 9, len(ids),
                    _bucket(len(ids))) for ids, budget in reqs]
    full_rows = [(2048, 512, 512)] * ENGINE_SLOTS
    test_rows = [(100, 40, 64), (20, 5, 16), (12, 0, 0), (128, 30, 32)]
    return [q8_case(torch, *a) for a in (
        ("llama-1b engine, traffic limits", llama, 8, 2048, 1, bf16,
         engine_rows, False),
        ("llama-1b engine, traffic limits, paged", llama, 8, 2048, 1, bf16,
         engine_rows, True),
        ("llama-1b verify window of 9, traffic limits", llama, 8, 2048, 9,
         bf16, engine_rows, False),
        ("llama-1b verify window of 9, traffic limits, paged", llama, 8,
         2048, 9, bf16, engine_rows, True),
        ("llama-1b engine, every row at the full span", llama, 8, 2048, 1,
         bf16, full_rows, False),
        ("moe-1b engine (d 64), traffic limits", moe, 8, 2048, 1, bf16,
         engine_rows, False),
        ("llama-test (d 16) f32", test, 4, 128, 1, torch.float32, test_rows,
         False))]


Q8_MAIN = "llama-1b engine, traffic limits, paged"
Q8_TEST = "llama-test (d 16) f32"      # the CUDA-core kernel's own call


def q8_kernel(torch, card) -> list:
    """Decode attention over an int8 cache at q8_cases' shapes, on each
    call's own route (bf16 at d 64/128 the tensor cores, tc8; llama-test's
    f32 d 16 the CUDA cores, q8) and the CUDA-core kernel forced at Q8_MAIN:
    each against its plain version (the reference's dequantize on read)
    within decode_tol, paged bitwise the dense; its time over
    DECODE_COPIES caches, the plain version's, the bound (the admitted
    positions' int8 K/V and scales, q, o and the table) and the
    yardstick: decode_attention_tc on the same caches dequantized to bf16
    in the same layout (bf16 at d 64/128). → the kernel line entries of the
    tensor-core route (decode_attention_tc_q8) and the CUDA-core route
    (decode_attention_q8)."""
    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    results = {"tc8": {}, "q8": {}}
    for case in q8_cases(torch):
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))
        rep = q.shape[1] // case["dense"][0][0].shape[1]
        own = tda._route(q.dtype, q.shape[3], rep, torch.int8)
        counter = iter(range(10 ** 9))

        def plain(i, case=case):
            k8, v8, ks, vs = case["calls"][i % DECODE_COPIES]
            return tda.decode_attention_reference(q, k8, v8, lim, pl, ps,
                                                  table, ks, vs)

        ref = plain(0)
        tol = decode_tol(torch, ref)
        plain_ms = graph_ms(torch, lambda: plain(next(counter)), 8)
        tc_ms = None
        if tda._route(q.dtype, q.shape[3], rep) == "tc":
            def tc(i, case=case):
                k, v = case["wide"][i % DECODE_COPIES]
                return tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                                 table=table)
            tc_ms = graph_ms(torch, lambda: tc(next(counter)), 40)
        b_ms, b_by = bound(0, case["nbytes"], str(q.dtype)[6:])
        for route in [own] + (["q8"] if case["label"] == Q8_MAIN else []):
            forced = None if route == own else route

            def kernel(i, case=case, forced=forced):
                k8, v8, ks, vs = case["calls"][i % DECODE_COPIES]
                return tda.decode_attention_cuda(q, k8, v8, lim, pl, ps,
                                                 table=table, route=forced,
                                                 k_scale=ks, v_scale=vs)

            before = tda.decode_attention_cuda.route_launches[route]
            got = kernel(0)
            torch.cuda.synchronize()
            label = f"decode attention {route} {case['label']}"
            check(tda.decode_attention_cuda.route_launches[route]
                  == before + 1, f"{label}: not on the {route} route")
            err = (got.float() - ref.float()).abs().max().item()
            check(err <= tol, f"{label}: max abs err {err} > {tol}")
            if table is not None:
                k8, v8, ks, vs = case["dense"][0]
                dense = tda.decode_attention_cuda(q, k8, v8, lim, pl, ps,
                                                  route=forced, k_scale=ks,
                                                  v_scale=vs)
                check(torch.equal(dense, got), f"{label}: paged != dense")
            ms = graph_ms(torch, lambda: kernel(next(counter)), 40)
            results[route][case["label"]] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "max_abs_err": err,
                "tc_bf16_ms": tc_ms, "forced": forced is not None}
            yard = (f"; decode_attention_tc on the cache in bf16 "
                    f"{tc_ms:.4f} ms" if tc_ms is not None else "")
            say(f"{label}{' (forced)' if forced else ''}: q "
                f"{tuple(q.shape)} {str(q.dtype)[6:]}, {case['admitted']} "
                f"admitted positions of {q.shape[0] * case['S']}; max abs err "
                f"{err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {case['nbytes'] / 1e6:.3f} MB), "
                f"{b_ms / ms:.3f} of it; plain {plain_ms:.4f} ms{yard} "
                f"[{card}]")
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    # no Pallas kernel: the dequantize and einsums XLA fuses
    return [{"name": "decode_attention_tc_q8", "route": "cuda",
             "source": "tpu_kubernetes_torch/csrc/decode_attention_tc.cu",
             "replaces": "tpu_kubernetes/models/decode.py:152",
             "launches": None, **results["tc8"][Q8_MAIN],
             "at_shapes": results["tc8"]},
            {"name": "decode_attention_q8", "route": "cuda",
             "source": "tpu_kubernetes_torch/csrc/decode_attention.cu",
             "replaces": "tpu_kubernetes/models/decode.py:152",
             "launches": None, **results["q8"][Q8_TEST],
             "at_shapes": results["q8"]}]


def int8_llama(torch, fa, card) -> dict:
    """llama-1b with int8 weights (quantize_for_decode) and the int8 KV
    cache, on the graphed serving programs: the solo lane's 4 ragged rows
    x 1,024 and 63 greedy steps beside the bf16 lane's in turns (prefill
    ms, decode ms/step); then the engine traffic (16 requests) through the
    int8 dense and paged engines and the bf16 paged engine in turns (ms a
    segment, tokens/s), int8 dense and paged tokens identical, each int8
    request against the int8 solo lane (equal, or diverging at a printed
    near-tie); the bytes of the weights, the cache and the pool against
    the reckoning; the int8 kernels in replay-only profiles of the int8
    engines. → (counts of the int8 solo lane's turns, of the int8 dense
    engine's turn, of the int8 paged engine's turn, kernel names)."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import init_cache, page_bytes
    from tpu_kubernetes_torch.models.quant import (
        matmul_weight_bytes,
        quantize_for_decode,
    )
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    qparams = quantize_for_decode(params, cfg)
    wb, wq = matmul_weight_bytes(params), matmul_weight_bytes(qparams)
    say(f"int8 llama-1b: matmul weights {wb:,} bytes in bf16, {wq:,} in "
        f"int8 with their f32 scales; a decode step's weight-read bound "
        f"{wb / HBM_BYTES_S * 1e3:.3f} ms -> {wq / HBM_BYTES_S * 1e3:.3f} "
        f"ms at {HBM_BYTES_S / 1e12:.2f} TB/s")
    check(wb == 1_641_021_440 and wq == 821_883_904,
          f"llama-1b matmul weight bytes {wb}, {wq}")
    cache = init_cache(cfg, ENGINE_SLOTS, cfg.max_seq, kv_quant=True,
                       device=dev)
    cache_bytes = sum(t.numel() * t.element_size() for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale))
    del cache
    pb, pb16 = page_bytes(cfg, DECODE_PAGE, True), page_bytes(cfg,
                                                              DECODE_PAGE)
    say(f"int8 llama-1b: KV cache of {ENGINE_SLOTS} slots x {cfg.max_seq} "
        f"positions {cache_bytes:,} bytes (bf16 "
        f"{2 * L * ENGINE_SLOTS * cfg.n_kv_heads * cfg.max_seq * cfg.head_dim * 2:,}"
        f"); a page of {DECODE_PAGE} positions {pb:,} bytes (bf16 {pb16:,});"
        f" 1 GiB holds {2 ** 30 // pb} int8 pages, {2 ** 30 // pb16} bf16")
    check(cache_bytes == 553_648_128 and pb == 540_672
          and 2 ** 30 // pb == 1985, "int8 cache or page bytes off the "
                                     "reckoning")

    # -- the solo lane: bf16 and int8 in turns -----------------------------
    b, width, new = 4, 1024, 64
    rows = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                         device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    lanes = {"bf16": GreedyLane(params, cfg),
             "int8": GreedyLane(qparams, cfg, kv_quant=True)}
    want = {v: serve_run(torch, lane, rows, lengths, new)[0]
            for v, lane in lanes.items()}
    same = sum(a == b_ for a, b_ in zip(want["int8"], want["bf16"]))
    say(f"int8 llama-1b solo lane: {same} of {b} rows token-identical to "
        f"the bf16 lane (int8 is a serving-accuracy design point, not a "
        f"lossless one)")
    times = {v: [] for v in lanes}
    counts = {}
    for rep in range(REPEATS):
        for v in (list(lanes) if rep % 2 == 0 else list(reversed(lanes))):
            if v == "int8":
                reset_counts(fa)
            out, pf, dec = serve_run(torch, lanes[v], rows, lengths, new)
            if v == "int8":
                for k, c in read_counts(fa).items():
                    counts[k] = counts.get(k, 0) + c
            check(out == want[v], f"int8 llama-1b: {v} tokens moved")
            times[v].append((pf, dec))
    # a request: two prefills of 4 x 1,024 rows (the dequant route; their
    # heads, 4 rows, the tensor-core kernel), the 63 steps' 7 products a
    # layer and the head on the tensor-core kernel, decode attention on tc8
    wanted = want_counts(
        fwd_tc=2 * REPEATS * L, dattn_tc8=REPEATS * (new - 1) * L,
        w8_tc=REPEATS * (2 + (new - 1) * (7 * L + 1)),
        w8_dequant=REPEATS * 2 * 7 * L)
    check(counts == wanted, f"int8 llama-1b solo launches {counts} != "
                            f"{wanted}")
    for v in lanes:
        say(f"int8 llama-1b solo lane {v}: prefill ms "
            f"{spread([t[0] for t in times[v]])}; decode ms/step "
            f"{spread([t[1] for t in times[v]])} [{card}]")
    prof = profile_window(torch, "int8 llama-1b int8 greedy request 4x1024 "
                                 f"+ {new - 1} steps",
                          lambda: lanes["int8"].run(rows, lengths, [new] * b,
                                                    new, 8), card)
    for name, ms, n in prof["rows"]:
        if "w8_matmul" in name or "q8" in name:
            say(f"int8 llama-1b request: {name[:80]} {ms:.3f} ms x{n}")
    del lanes
    torch.cuda.empty_cache()

    # -- the engines: int8 dense, int8 paged, bf16 paged in turns ------------
    requests = engine_requests(torch, cfg, 16, seed=1)

    def engine(p, kvq, mb):
        return ContinuousEngine(GreedyLane(p, cfg, kv_quant=kvq),
                                slots=ENGINE_SLOTS, seg_steps=ENGINE_STEPS,
                                pool_mb=mb, page_size=DECODE_PAGE)

    engines = {"int8 dense": engine(qparams, True, 0.0),
               "int8 paged": engine(qparams, True,
                                    INT8_POOL_PAGES * pb / 2 ** 20),
               "bf16 paged": engine(params, False,
                                    INT8_POOL_PAGES * pb16 / 2 ** 20)}
    seg_ms = {v: [] for v in engines}
    for v, eng in engines.items():
        eng.warm()
        inner = eng._run_segment

        def run(eng=eng, v=v, inner=inner):
            before = eng.segments
            t0 = time.perf_counter()
            inner()
            if eng.segments > before:
                seg_ms[v].append((time.perf_counter() - t0) * 1e3)
        eng._run_segment = run
    first = {}
    for v, eng in engines.items():
        first[v], _ = engine_turn(eng, requests)
        wait_idle(eng)
        seg_ms[v].clear()
    check(first["int8 paged"] == first["int8 dense"],
          "int8 llama-1b: paged engine tokens differ from the dense one's")
    engine_counts, walls = {}, {}
    for v in (*engines, *reversed(engines)):
        reset_counts(fa)
        got, wall = engine_turn(engines[v], requests)
        wait_idle(engines[v])
        c = read_counts(fa)
        if v.startswith("int8"):
            # the tensor-core routes alone: no CUDA-core int8 launch, no bf16
            check(c["w8_matmul.tc"] > 0 and c["decode_attention.tc8"] > 0
                  and c["w8_matmul.gemv"] == 0
                  and c["decode_attention.q8"] == 0
                  and c["decode_attention.tc"] == 0,
                  f"int8 llama-1b {v} engine launches {c}")
            engine_counts[v] = c
        check(got == first[v], f"int8 llama-1b {v} engine: tokens moved")
        walls.setdefault(v, []).append(wall)
    out_tokens = sum(len(t) for t in first["int8 dense"])
    for v in engines:
        med = sorted(seg_ms[v])[len(seg_ms[v]) // 2]
        say(f"int8 llama-1b engine {v}, 16 requests ({out_tokens} tokens): "
            f"wall s {spread(walls[v])}, {out_tokens / min(walls[v]):.1f} "
            f"tokens/s (best turn); ms a segment, median of both turns "
            f"{med:.3f} [{card}]")
    pages = engines["int8 paged"].stats()["pages"]
    check(pages["free"] == pages["total"], f"int8 pool pages {pages}")
    # each int8 engine idle: a segment replay with every sync an error,
    # then a segment's and a prefill's replays, each in its own profile
    # (a segment of the int8 step is some 7,000 kernels), against the
    # counts, the three kernels among the names
    names = set()
    ids = requests[0][0]
    rows = torch.tensor([ids], dtype=torch.int32)
    lens = torch.tensor([len(ids)], dtype=torch.int32)
    for v in ("int8 dense", "int8 paged"):
        eng = engines[v]
        wait_idle(eng)
        with eng._lock:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.launch_segment()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            names |= check_replay_launches(
                torch, fa, f"int8 llama-1b {v} engine segment replay",
                eng.launch_segment, card)
            names |= check_replay_launches(
                torch, fa, f"int8 llama-1b {v} engine prefill replay",
                lambda eng=eng: eng.lane.prefill(rows, lens, len(ids)), card)
    for k in ("flash_fwd_tc_kernel", "decode_attention_tc_q8_kernel",
              "w8_matmul_tc_kernel"):
        check(any(re.search(rf"\b{k}\b", n) for n in names),
              f"int8 llama-1b: {k} not seen in a replay-only profile")
    say("int8 llama-1b engines: a segment replay under "
        "set_sync_debug_mode('error'); flash_fwd_tc_kernel, "
        "decode_attention_tc_q8_kernel and w8_matmul_tc_kernel seen in "
        "replay-only profiles of a segment and a prefill")
    for e in engines.values():
        e.close()
    del engines

    # each int8 engine request against the int8 solo lane
    lane = GreedyLane(qparams, cfg, kv_quant=True)
    solo = []
    for ids, budget in requests:
        w, run = solo_shape(ids, budget)
        r = torch.zeros((1, w), dtype=torch.int32)
        r[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        toks, _ = lane.run(r, torch.tensor([len(ids)], dtype=torch.int32),
                           [budget], run, ENGINE_STEPS)
        solo.append(toks[0][:budget])
    del lane
    diverged = near_tie_divergences(torch, qparams, cfg,
                                    "int8 llama-1b engine", requests,
                                    first["int8 dense"], solo, kv_quant=True)
    say(f"int8 llama-1b engine against the int8 solo lane: "
        f"{len(requests) - diverged} of {len(requests)} requests identical, "
        f"{diverged} diverging at a near-tie")
    del params, qparams
    torch.cuda.empty_cache()
    return counts, engine_counts["int8 dense"], engine_counts["int8 paged"], \
        names


def int8_moe(torch, fa, card) -> dict:
    """moe-1b (grouped dispatch) with int8 weights: one solo greedy request
    of 4 ragged rows x 256 and 16 tokens, the expert stacks dequantized to
    bf16 before the grouped kernels; finite logits, tokens in range, the
    grouped, w8 and decode-attention kernels launched. → its counts."""
    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.models.quant import quantize_for_decode
    from tpu_kubernetes_torch.serve.server import GreedyLane

    dev = torch.device("cuda")
    cfg = moe_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = quantize_for_decode(init_params(cfg, gen, dev), cfg)
    rows = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                         device=dev, dtype=torch.int32)
    lengths = torch.tensor([256, 200, 100, 33], dtype=torch.int32)
    lane = GreedyLane(qparams, cfg, kv_quant=True)
    serve_run(torch, lane, rows, lengths, 16)      # captures
    reset_counts(fa)
    out, pf, dec = serve_run(torch, lane, rows, lengths, 16)
    counts = read_counts(fa)
    check(all(0 <= t < cfg.vocab_size for r in out for t in r),
          "int8 moe-1b: a token out of range")
    check(counts["gmm.tc"] > 0 and counts["w8_matmul.tc"] > 0
          and counts["decode_attention.tc8"] > 0,
          f"int8 moe-1b launches {counts}")
    say(f"int8 moe-1b grouped, 4x256 ragged, 16 tokens: prefill "
        f"{pf:.3f} ms, decode {dec:.3f} ms/step; launches {counts} [{card}]")
    del lane, qparams
    torch.cuda.empty_cache()
    return counts


def int8_http(torch, fa, card) -> tuple[dict, set]:
    """llama-test over HTTP in f32 with SERVE_QUANT=int8 SERVE_KV_QUANT=1
    and the continuous engine (the CUDA-core int8 kernels' main path: f32
    rows, head_dim 16): /healthz says kv_quant, two completions, then, the
    engine idle, a segment's and a prefill's replays in a replay-only
    profile that shows both CUDA-core kernels; then one verify-round turn
    of the bf16 engine with a draft model on an int8 draft cache
    (SERVE_DRAFT_KV_QUANT=1), whose tokens equal the plain int8 weights
    server's. → (the counts of the first server's completions, the kernel
    names of its profile)."""
    env = dict(HTTP_ENV, SERVE_QUANT="int8", SERVE_KV_QUANT="1",
               SERVE_DTYPE="float32", SERVE_CONTINUOUS_BATCHING="1")
    with serving(env) as (state, port):
        status, health = _request(port, "GET", "/healthz")
        check(status == 200 and health["kv_quant"] is True,
              f"int8 http /healthz {status} {health}")
        reset_counts(fa)
        outs = [_request(port, "POST", "/v1/completions", body)
                for body in GREEDY]
        counts = read_counts(fa)
        check(all(s == 200 for s, _ in outs), f"int8 http: {outs}")
        check(counts["w8_matmul.gemv"] > 0
              and counts["decode_attention.q8"] > 0
              and counts["w8_matmul.tc"] == 0
              and counts["decode_attention.tc8"] == 0,
              f"int8 http launches {counts}: f32 rows and head_dim 16 take "
              f"the CUDA-core int8 kernels")
        plain = [o["text"] for _, o in outs]
        wait_idle(state._engine)
        names = engine_replays(
            torch, fa, "int8 http engine", state._engine,
            (state.encode(GREEDY[1]["prompt"]) or [0]) + [0] * 15, card,
            {"w8_matmul_kernel", "decode_attention_q8_kernel"})
    spec_env = dict(HTTP_ENV, SERVE_QUANT="int8",
                    SERVE_CONTINUOUS_BATCHING="1",
                    SERVE_DRAFT_MODEL="llama-test", SERVE_DRAFT_K="4",
                    SERVE_DRAFT_KV_QUANT="1")
    with serving(spec_env) as (state, port):
        check(state.draft.kv_quant and not state.greedy.kv_quant,
              "int8 http: the draft cache alone should be int8")
        mark = read_counts(fa)
        outs = [_request(port, "POST", "/v1/completions", body)
                for body in GREEDY]
        after = read_counts(fa)
        check(after["decode_attention.simt.chunk"]
              > mark["decode_attention.simt.chunk"]
              and after["decode_attention.q8"] > mark["decode_attention.q8"],
              "int8 http: the verify rounds or the int8 draft cache did not "
              "run their kernels")
        spec = state.spec_totals
    with serving(dict(HTTP_ENV, SERVE_QUANT="int8",
                      SERVE_CONTINUOUS_BATCHING="1")) as (_, port):
        ref = [_request(port, "POST", "/v1/completions", body)[1]["text"]
               for body in GREEDY]
    check([o["text"] for _, o in outs] == ref,
          "int8 http: the draft-verified tokens differ from the plain int8 "
          "weights engine's")
    say(f"int8 http (llama-test f32, SERVE_QUANT=int8 SERVE_KV_QUANT=1, the "
        f"engine): /healthz kv_quant true, {len(plain)} completions; a "
        f"verify-round turn on an int8 draft cache (SERVE_DRAFT_KV_QUANT=1, "
        f"rounds {spec['rounds']}, accepted {spec['accepted']} of "
        f"{spec['drafted']}) equal to the plain int8 engine's tokens")
    return counts, names


INT8_CHILD = "--int8-phase"


def phase_int8_child(torch) -> tuple[list, dict, set]:
    """phase_int8 in a child process of this script (``INT8_CHILD``), with
    a CUDA context and a profiler of its own, after every other phase: run
    last in this process the phase's replay-only profiles came up short
    of three kernel records in every window, and run before the graph
    phases (in this process or in a child) the f32 train step's came up
    short of one, while the phase alone in a fresh process saw every
    launch. Its output is this run's; its result comes back as JSON. →
    phase_int8's."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "int8.json"
        sys.stdout.flush()
        sys.stderr.flush()
        proc = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"),
                               INT8_CHILD, str(out)], timeout=900)
        check(proc.returncode == 0, f"the int8 phase's process exited "
                                    f"{proc.returncode}")
        res = json.loads(out.read_text())
    return res["entries"], res["paths"], set(res["names"])


def phase_int8(torch, fa, card: str) -> tuple[list, dict, set]:
    """int8 serving (see the section's helpers). → (the four kernel line
    entries, the paths' counts, the kernel names of the replay-only
    profiles)."""
    t0 = time.perf_counter()
    entries = [*w8_kernel(torch, card), *q8_kernel(torch, card)]
    t1 = time.perf_counter()
    solo, dense, paged, names = int8_llama(torch, fa, card)
    t2 = time.perf_counter()
    paths = {"llama_int8_solo_lane": solo, "llama_int8_engine_16_requests":
             dense, "llama_int8_paged_engine_16_requests": paged,
             "moe_int8_serve": int8_moe(torch, fa, card)}
    t3 = time.perf_counter()
    paths["http_int8"], http_names = int8_http(torch, fa, card)
    names |= http_names
    say(f"int8 phase seconds: kernels {t1 - t0:.1f}, llama-1b {t2 - t1:.1f}, "
        f"moe-1b {t3 - t2:.1f}, http {time.perf_counter() - t3:.1f}")
    return entries, paths, names


# -- sharded training (parallel/, over gloo on one card) ---------------------
PARALLEL_CHILD = "--parallel-phase"
# the meshes: (model, dtype, mesh); llama-1b's three and moe-1b grouped's
# two in bf16; in f32 at the same widths llama-1b over fsdp x tensor and
# data x fsdp, moe-1b over expert x tensor
PAR_CASES = (
    ("llama-1b", "bfloat16", {"fsdp": 2}),
    ("llama-1b", "bfloat16", {"tensor": 2}),
    ("llama-1b", "bfloat16", {"data": 2, "tensor": 2}),
    ("moe-1b", "bfloat16", {"expert": 2}),
    ("moe-1b", "bfloat16", {"expert": 2, "tensor": 2}),
    ("llama-1b", "float32", {"fsdp": 2, "tensor": 2}),
    ("llama-1b", "float32", {"data": 2, "fsdp": 2}),
    ("moe-1b", "float32", {"expert": 2, "tensor": 2}),
)
PAR_WORLD = 4              # gloo ranks, all on cuda:0
PAR_DEPTH = 2              # layers: the phase's time
PAR_STEPS = 3
PAR_ROWS, PAR_SEQ = 4, 2048                 # the global batch
# f32 meshes take a shorter sequence at the same widths: their CUDA-core
# attention is quadratic in it, and every check reads the gradients'
# reductions, which the sequence does not change
PAR_SEQ_F32 = 512
# the pipelined step (make_pipeline_train_step): llama-1b at depth 4 (2
# layers a stage), PIPE_M microbatches, against the one-process step at
# the same depth
PIPE_CASES = (
    ("bfloat16", {"stage": 2}),
    ("bfloat16", {"data": 2, "stage": 2}),
    ("float32", {"stage": 2, "tensor": 2}),
)
PIPE_DEPTH, PIPE_M = 4, 2
# the sharded LoRA step (make_sharded_lora_step): llama-1b at depth 2,
# rank 8 on the attention projections, against make_lora_step
LORA_CASE = ("bfloat16", {"fsdp": 2, "tensor": 2})
LORA_RANK, LORA_TARGETS, LORA_LR = 8, ("wq", "wk", "wv", "wo"), 1e-3
# ring attention (parallel/ring_attention.py) at llama-1b's attention
# layout (b 1, 16 heads, d 128, bf16 inputs, causal) over a sequence ring
# of PAR_WORLD ranks, forward and backward, against flash_fwd_tc and the
# flash backward kernels on the whole sequence; the limits in bf16 ulps of
# each tensor's largest value
RING_SEQ, RING_HEADS, RING_D = 16384, 16, 128
RING_ULPS = {"out": 4, "dq": 8, "dk": 8, "dv": 8}
# The mesh's run against the one-process make_train_step from the same
# state and batches, worst over the steps or the leaves:
#   loss:   |loss_mesh − loss_one| / loss_one, each step;
#   update: ‖p_mesh − p_one‖ / ‖p_one − p_start‖ after the last step, the
#           parameters' change against the one-process change;
#   mu, nu: ‖m_mesh − m_one‖ / ‖m_one‖, the AdamW moments after the last
#           step (they carry each step's gradient at its scale: a skipped
#           or doubled reduction moves them by a whole gradient).
# A step that changes nothing reads 1 for update and mu (by definition).
# The limits sit between the sound runs' largest reading and the smallest
# reading of a planted fault where it applies (mutation_check.py
# parallel: a skipped gradient all-reduce over a data-like axis, an
# unsummed gather backward, an unreduced copy_to backward, the optimizer
# never applied; both readings in PERF.md §6). On an H100: bf16 sound
# loss ≤ 2.2e-5, update ≤ 0.146, mu ≤ 0.072, nu ≤ 0.060 against the
# faults' ≥ 1.8e-4 (the optimizer's fault; the others hide in the loss at
# random init), 0.86, 0.71, 0.72; f32 sound loss ≤ 8.8e-8 (one ulp),
# update ≤ 4.2e-5, mu and nu ≤ 4.1e-6 against the same faults.
PAR_TOL = {"bfloat16": {"loss": 6e-5, "update": 0.4, "mu": 0.25, "nu": 0.25},
           "float32": {"loss": 1e-6, "update": 1e-3, "mu": 1e-4, "nu": 1e-4}}
PAR_TIMEOUT_S = 600


def _par_worker(rank: int, world: int, rendezvous: str, inbox,
                outbox) -> None:
    """A gloo rank on cuda:0 of the parallel phase's pool: runs each task
    ``(fn, args)`` it is given and sends back ``(rank, ok, result)``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=rendezvous, rank=rank,
                            world_size=world)
    while (task := inbox.get()) is not None:
        fn, args = task
        try:
            outbox.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 — reported to the parent
            outbox.put((rank, False, traceback.format_exc()))
    dist.barrier()             # no rank tears down under a peer
    dist.destroy_process_group()


class ParPool:
    """PAR_WORLD gloo ranks sharing cuda:0, spawned once for every mesh of
    the phase (a process takes seconds to reach the card)."""

    def __init__(self, tmp: Path):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(PAR_WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_par_worker, daemon=True, args=(
            r, PAR_WORLD, f"file://{tmp}/rendezvous", self.inboxes[r],
            self.outbox)) for r in range(PAR_WORLD)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        import queue

        for box in self.inboxes:
            box.put((fn, args))
        results, errors = [None] * PAR_WORLD, []
        deadline = time.perf_counter() + PAR_TIMEOUT_S
        for _ in range(PAR_WORLD):
            while True:
                try:
                    rank, ok, value = self.outbox.get(timeout=5)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if not p.is_alive()]
                    check(not dead, f"parallel ranks {dead} died "
                                    f"(exit {self.procs[dead[0]].exitcode})"
                          if dead else "")
                    check(time.perf_counter() < deadline,
                          f"a parallel case took over {PAR_TIMEOUT_S} s")
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        check(not errors, "a parallel rank failed:\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


def par_cfg(torch, model: str, dtype_name: str, depth: int = PAR_DEPTH):
    from tpu_kubernetes_torch.models import CONFIGS

    cfg = moe_cfg() if model == "moe-1b" else CONFIGS[model]
    return replace(cfg, n_layers=depth, dtype=getattr(torch, dtype_name))


def par_seq(dtype_name: str) -> int:
    return PAR_SEQ if dtype_name == "bfloat16" else PAR_SEQ_F32


def par_mesh_label(mesh: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in mesh.items())


def par_rel(got: dict, want: dict, base: dict | None = None
            ) -> tuple[float, str]:
    """The worst leaf's ‖got − want‖ / ‖want − base‖ (base None: ‖want‖),
    in f32, over the leaves of two like trees → (value, leaf path)."""
    from tpu_kubernetes_torch.train.trainer import tree_leaves

    def paths(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from paths(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}"

    base_leaves = tree_leaves(base) if base is not None else None
    worst, where = 0.0, ""
    for i, (path, g, w) in enumerate(zip(paths(want), tree_leaves(got),
                                         tree_leaves(want))):
        w = w.float()
        num = (g.float() - w).norm().item()
        den = (w - base_leaves[i].float() if base_leaves else w).norm().item()
        rel = num / den if den else num
        if rel >= worst:
            worst, where = rel, path
    return worst, where


def par_case(model: str, dtype_name: str, mesh_shape: dict,
             pipeline: bool = False) -> dict | None:
    """One mesh on this rank: the whole state from the seed on cuda:0, on
    rank 0 first the one-process ``make_train_step`` over the same
    batches (the reference), then with every count at 0 the
    ``make_sharded_train_step`` steps (``pipeline``: the
    ``make_pipeline_train_step`` steps at ``PIPE_DEPTH``) over gloo
    (eager), the counts read after them, the params and AdamW moments
    gathered whole and, on rank 0, held to the reference's (``par_rel``).
    → this rank's losses, counts, seconds, a fingerprint of the whole
    state it gathered (a replica that drifted reads another), and on rank
    0 the reference's losses and the worst leaf's update, mu and nu
    readings (``PAR_TOL``)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import create_mesh
    from tpu_kubernetes_torch.parallel import collectives
    from tpu_kubernetes_torch.train.trainer import (
        Shards,
        TrainConfig,
        gather_state,
        init_state,
        make_pipeline_train_step,
        make_sharded_train_step,
        make_train_step,
        shard_batch,
        tree_leaves,
        tree_map,
    )

    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    n = math.prod(mesh_shape.values())
    mesh = create_mesh(mesh_shape, devices=list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    dev = torch.device("cuda", 0)
    cfg = par_cfg(torch, model, dtype_name,
                  PIPE_DEPTH if pipeline else PAR_DEPTH)
    seq = par_seq(dtype_name)
    tc = TrainConfig(warmup_steps=2)   # the later steps move the params
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, tc,
                       dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randint(0, cfg.vocab_size, (PAR_ROWS, seq + 1),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(PAR_STEPS)]
    out = {"rank": rank}
    ref = start = None
    if rank == 0:
        start = tree_map(torch.clone, state["params"])
        ref = {"params": tree_map(torch.clone, state["params"]),
               "opt_state": tree_map(torch.clone, state["opt_state"]),
               "step": 0}
        one = make_train_step(cfg, tc, ref, (PAR_ROWS, seq + 1),
                              graphs=False)
        out["one_losses"] = [float(one(b)) for b in batches]
        del one
    torch.cuda.synchronize()
    reset_counts(fa)
    # every rank of the mesh starts the clock together (rank 0 has just
    # run the reference)
    collectives.all_reduce_raw(torch.zeros(1, device=dev),
                               mesh.group(mesh.axis_names))
    t0 = time.perf_counter()
    if pipeline:
        step, sh, b_sh = make_pipeline_train_step(
            cfg, tc, mesh, state, PIPE_M, (PAR_ROWS, seq + 1))
    else:
        step, sh, b_sh = make_sharded_train_step(
            cfg, tc, mesh, state, (PAR_ROWS, seq + 1))
    out["losses"] = [float(step(shard_batch(b, b_sh, step.row_blocks)))
                     for b in batches]
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = read_counts(fa)
    out["norm_groups"] = len({tuple(sorted(s.split_axes())) for s in Shards(
        mesh, sh["params"], state["params"]).leaves})
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    whole = gather_state(state, sh)
    out["fingerprint"] = fingerprint(torch, {k: whole[k] for k in (
        "params", "opt_state")}, tree_leaves)
    if rank == 0:
        out["update"] = par_rel(whole["params"], ref["params"], start)
        for m in ("mu", "nu"):
            out[m] = par_rel(whole["opt_state"][m], ref["opt_state"][m])
    return out


def fingerprint(torch, tree: dict, tree_leaves) -> list:
    """Each leaf's f64 sum and sum of squares: equal on every rank when
    the replicas of every leaf agree bit for bit."""
    return [float(x) for leaf in tree_leaves(tree) for x in (
        leaf.double().sum(), leaf.double().square().sum())]


def lora_par_case(dtype_name: str, mesh_shape: dict) -> dict | None:
    """The sharded LoRA step on this rank: the whole base and adapters
    from the seeds on cuda:0, on rank 0 first the one-process
    ``make_lora_step`` over the same batches, then with every count at 0
    the ``make_sharded_lora_step`` steps over gloo, the counts read after
    them, the base's blocks compared bit for bit with themselves before
    the steps, the adapters and their moments gathered whole and, on rank
    0, held to the reference's (``par_rel``)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import init_params
    from tpu_kubernetes_torch.parallel import collectives, create_mesh
    from tpu_kubernetes_torch.train.lora import (
        LoraConfig,
        init_lora_state,
        make_lora_step,
        make_sharded_lora_step,
    )
    from tpu_kubernetes_torch.train.trainer import (
        gather_state,
        shard_batch,
        tree_leaves,
        tree_map,
    )

    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    n = math.prod(mesh_shape.values())
    mesh = create_mesh(mesh_shape, devices=list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    dev = torch.device("cuda", 0)
    cfg = par_cfg(torch, "llama-1b", dtype_name)
    seq = par_seq(dtype_name)
    lc = LoraConfig(rank=LORA_RANK, targets=LORA_TARGETS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    state = init_lora_state(torch.Generator(device=dev).manual_seed(1),
                            params, cfg, lc, learning_rate=LORA_LR)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [torch.randint(0, cfg.vocab_size, (PAR_ROWS, seq + 1),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(PAR_STEPS)]
    out = {"rank": rank}
    ref = start = None
    if rank == 0:
        start = tree_map(torch.clone, state["adapters"])
        ref = tree_map(torch.clone, {k: state[k] for k in (
            "adapters", "opt_state")})
        ref["step"] = 0
        one = make_lora_step(cfg, lc, ref, params, (PAR_ROWS, seq + 1),
                             learning_rate=LORA_LR, graphs=False)
        out["one_losses"] = [float(one(b)) for b in batches]
        del one
    torch.cuda.synchronize()
    reset_counts(fa)
    collectives.all_reduce_raw(torch.zeros(1, device=dev),
                               mesh.group(mesh.axis_names))
    t0 = time.perf_counter()
    step, s_sh, _, b_sh = make_sharded_lora_step(
        cfg, lc, mesh, state, params, (PAR_ROWS, seq + 1),
        learning_rate=LORA_LR)
    base = [t.clone() for t in tree_leaves(params)]
    out["losses"] = [float(step(shard_batch(b, b_sh))) for b in batches]
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = read_counts(fa)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["base_same"] = all(torch.equal(a, b) for a, b in zip(
        base, tree_leaves(params)))
    whole = gather_state({k: state[k] for k in ("adapters", "opt_state")},
                         {k: s_sh[k] for k in ("adapters", "opt_state")})
    out["fingerprint"] = fingerprint(torch, whole, tree_leaves)
    if rank == 0:
        out["update"] = par_rel(whole["adapters"], ref["adapters"], start)
        for m in ("mu", "nu"):
            out[m] = par_rel(whole["opt_state"][m], ref["opt_state"][m])
    return out


def ring_par_case(seq: int) -> dict | None:
    """Ring attention on this rank of a ``sequence`` ring over every rank
    of the pool: q, k, v and the output's cotangent drawn whole from the
    seed (bf16), this rank's blocks through ``ring_attention_sharded`` and
    its backward with every count at 0 (read after: the ring launches no
    hand-written kernel), then the output and gradients gathered and, on
    rank 0, held to ``flash_attention`` on the whole sequence (the
    tensor-core forward and backward kernels): each reading the largest
    difference in bf16 ulps of the kernels' largest value (``RING_ULPS``).
    → seconds, the device memory peak, counts and the readings."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import (
        collectives,
        create_mesh,
        ring_attention_sharded,
    )
    from tpu_kubernetes_torch.parallel.mesh import gather_tensor, shard_tensor
    from tpu_kubernetes_torch.parallel.ring_attention import seq_sharding

    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    mesh = create_mesh({"sequence": PAR_WORLD})
    rank = dist.get_rank()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (1, RING_HEADS, seq, RING_D)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    sh = seq_sharding(mesh)
    qb, kb, vb = (shard_tensor(x, sh, rank).requires_grad_(True)
                  for x in (q, k, v))
    dob = shard_tensor(do, sh, rank)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(fa)
    collectives.all_reduce_raw(torch.zeros(1, device=dev),
                               mesh.group("sequence"))
    t0 = time.perf_counter()
    ob = ring_attention_sharded(qb, kb, vb, mesh, causal=True)
    ob.backward(dob)
    torch.cuda.synchronize()
    out = {"rank": rank, "seconds": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "counts": read_counts(fa)}
    got = {name: gather_tensor(x.detach(), sh) for name, x in (
        ("out", ob), ("dq", qb.grad), ("dk", kb.grad), ("dv", vb.grad))}
    del ob, qb, kb, vb
    if rank == 0:
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = fa.flash_attention(q, k, v, causal=True)
        o.backward(do)
        want = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        for name, w in want.items():
            w = w.float()
            err = (got[name].float() - w).abs().max().item()
            out[name] = err / bf16_ulp(w.abs().max().item())
    return out


def par_nccl_capture(torch, tmp: Path) -> None:
    """A 1-rank NCCL world on the card: the collectives layer's ops
    (``parallel/collectives.py``: all-reduce, all-gather along a
    dimension, reduce-scatter, all-to-all, the shift) captured into one
    CUDA graph
    and replayed on new inputs; each must give its 1-rank answer (its
    input). A failed init or capture raises."""
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import collectives as C

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        g = dist.group.WORLD
        x = torch.arange(16, dtype=torch.bfloat16, device="cuda") \
            .reshape(4, 4)

        def ops():
            return (C.all_reduce_raw(x, g), C.all_gather_raw(x, 1, g),
                    C.reduce_scatter_raw(x, 1, g), C.all_to_all_raw(x, g),
                    C.ppermute_raw((x,), [(0, 0)], g)[0])

        ops()                               # the communicator, eagerly
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = ops()
        for k in range(3):
            x.copy_(torch.randn(4, 4, device="cuda").to(x.dtype))
            graph.replay()
            torch.cuda.synchronize()
            for name, y in zip(("all_reduce", "all_gather", "reduce_scatter",
                                "all_to_all", "ppermute"), outs):
                check(torch.equal(y, x), f"NCCL {name} replay {k}: the "
                                         f"1-rank answer is its input")
        say(f"parallel: NCCL 1-rank world, the collectives captured into one "
            f"CUDA graph and replayed 3 times: equal to their inputs "
            f"(torch {torch.__version__}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))})")
    finally:
        dist.destroy_process_group()


def par_want(model: str, dtype_name: str, groups: int) -> dict:
    """The launches one rank makes in PAR_STEPS sharded steps, from layers
    × steps: the flash forward twice a layer (the forward and remat's
    recompute), dQ and dK/dV once; moe-1b grouped's forward kernel 8
    times a layer (w_gate, w_up, w_down; the recompute's w_gate and w_up,
    w_down saved by the "moe" policy; three dlhs) and drhs 3; one
    ``adamw_sumsq`` for each set of mesh axes its leaves are split over
    and one ``adamw_update`` a step."""
    L, s = PAR_DEPTH, PAR_STEPS
    route = "tc" if dtype_name == "bfloat16" else "simt"
    gmm = 8 * L * s if model == "moe-1b" else 0
    drhs = 3 * L * s if model == "moe-1b" else 0
    kw = {f"fwd_{route}": 2 * L * s, f"dq_{route}": L * s,
          f"dkv_{route}": L * s, f"gmm_{route}": gmm,
          f"drhs_{route}": drhs}
    want = want_counts(**kw, adamw=s)
    want["adamw_sumsq"] = groups * s
    return want


def pipe_want(dtype_name: str, groups: int) -> dict:
    """The launches one rank makes in PAR_STEPS pipelined steps: a stage
    runs its PIPE_DEPTH / S layers on each of the PIPE_M microbatches and
    skips its bubble ticks, so a step makes 2·M·L/S flash forwards (the
    forward and remat's recompute) and M·L/S of dQ and dK/dV; the AdamW
    pair as ``par_want``'s."""
    route = "tc" if dtype_name == "bfloat16" else "simt"
    per = PIPE_M * PIPE_DEPTH // 2 * PAR_STEPS       # S = 2 on every mesh
    want = want_counts(**{f"fwd_{route}": 2 * per, f"dq_{route}": per,
                          f"dkv_{route}": per}, adamw=PAR_STEPS)
    want["adamw_sumsq"] = groups * PAR_STEPS
    return want


def lora_want() -> dict:
    """The launches one rank makes in PAR_STEPS sharded LoRA steps: the
    train step's attention kernels at PAR_DEPTH, the adapters' update
    without a clip (no norm kernel)."""
    L, s = PAR_DEPTH, PAR_STEPS
    return {**want_counts(fwd_tc=2 * L * s, dq_tc=L * s, dkv_tc=L * s),
            "adamw_update": s}


def par_got(r0: dict) -> dict:
    """Rank 0's result of ``par_case`` → its readings against the
    one-process step, by the names of ``PAR_TOL``."""
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(
                r0["losses"], r0["one_losses"])),
            **{k: r0[k][0] for k in ("update", "mu", "nu")}}


def par_report(label: str, res: list, want: dict, depth: int, seq: int,
               tol: dict, paths: dict, key: str, card: str) -> dict:
    """Hold one mesh's results (``par_case`` or ``lora_par_case``) to the
    one-process step and the launch prediction, print them, put each
    rank's counts in ``paths`` → the summary's entry."""
    r0 = res[0]
    got = par_got(r0)
    say(f"parallel {label}: {len(res)} gloo ranks on one card, depth "
        f"{depth}, {PAR_ROWS} x {seq} rows, {PAR_STEPS} steps: losses "
        f"{r0['losses']} against one process {r0['one_losses']}; against "
        f"the one-process step (worst step or leaf, limit): loss "
        f"{got['loss']!r} ({tol['loss']}), "
        + ", ".join(f"{k} {r0[k][0]!r} at {r0[k][1]} ({tol[k]})"
                    for k in ("update", "mu", "nu"))
        + f"; step seconds per rank {[r['seconds'] / PAR_STEPS for r in res]}"
        f" (gloo through the host on one card, not a multi-card rate; "
        f"{card}); device memory peak "
        f"{max(r['peak_gib'] for r in res):.2f} GiB a rank")
    check(all(r["losses"] == r0["losses"] for r in res),
          f"{label}: the ranks report different losses")
    if "fingerprint" in r0:
        check(all(r["fingerprint"] == r0["fingerprint"] for r in res),
              f"{label}: the ranks gathered different states (a replica "
              f"drifted)")
    for k, v in got.items():
        check(v <= tol[k], f"{label}: {k} off the one-process step by "
                           f"{v!r} > {tol[k]}")
    for r in res:
        have = {k: r["counts"][k] for k in want}
        check(have == want, f"{label} rank {r['rank']}: launches {have}, "
                            f"predicted {want}")
        paths[f"{key}_rank{r['rank']}"] = r["counts"]
    say(f"parallel {label}: launches a rank equal the prediction: "
        + json.dumps({k: v for k, v in want.items()
                      if v and "." in k or k.startswith("adamw")}))
    return {"label": label, "losses": r0["losses"],
            "one_losses": r0["one_losses"], **got,
            "step_s": [r["seconds"] / PAR_STEPS for r in res]}


def phase_parallel(torch, card: str) -> tuple[dict, dict]:
    """The sharded train step (``make_sharded_train_step``), the
    pipelined step, the sharded LoRA step and ring attention over gloo
    ranks sharing the card, and the NCCL capture. → (paths' counts by
    rank, the phase's summary)."""
    import tempfile

    from tpu_kubernetes_torch.models import CONFIGS

    t_phase = time.perf_counter()
    paths, summary = {}, {"cases": []}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-par-") as tmp:
        tmp = Path(tmp)
        par_nccl_capture(torch, tmp)
        pool = ParPool(tmp)
        try:
            for model, dtype_name, mesh in PAR_CASES:
                label = (f"{model} {dtype_name} {par_mesh_label(mesh)}"
                         f" (of the preset's {CONFIGS[model].n_layers} "
                         "layers)")
                res = [r for r in pool.run(par_case, model, dtype_name, mesh)
                       if r is not None]
                summary["cases"].append(par_report(
                    label, res, par_want(model, dtype_name,
                                         res[0]["norm_groups"]),
                    PAR_DEPTH, par_seq(dtype_name), PAR_TOL[dtype_name],
                    paths, f"parallel_{model}_{dtype_name}_"
                    f"{par_mesh_label(mesh)}", card))
            for dtype_name, mesh in PIPE_CASES:
                label = (f"pipelined llama-1b {dtype_name} "
                         f"{par_mesh_label(mesh)}, {PIPE_M} microbatches")
                res = [r for r in pool.run(par_case, "llama-1b", dtype_name,
                                           mesh, True) if r is not None]
                summary["cases"].append(par_report(
                    label, res, pipe_want(dtype_name, res[0]["norm_groups"]),
                    PIPE_DEPTH, par_seq(dtype_name), PAR_TOL[dtype_name],
                    paths, f"pipeline_llama-1b_{dtype_name}_"
                    f"{par_mesh_label(mesh)}", card))
            dtype_name, mesh = LORA_CASE
            label = (f"sharded LoRA llama-1b {dtype_name} "
                     f"{par_mesh_label(mesh)}, rank {LORA_RANK} on "
                     f"{','.join(LORA_TARGETS)}")
            res = [r for r in pool.run(lora_par_case, dtype_name, mesh)
                   if r is not None]
            check(all(r["base_same"] for r in res),
                  f"{label}: the base changed")
            summary["cases"].append(par_report(
                label, res, lora_want(), PAR_DEPTH, par_seq(dtype_name),
                PAR_TOL[dtype_name], paths,
                f"lora_llama-1b_{dtype_name}_{par_mesh_label(mesh)}", card))
            say(f"parallel {label}: the base bit for bit as it was on every "
                f"rank")
            summary["ring"] = phase_ring(pool, paths, card)
        finally:
            pool.close()
    summary["seconds"] = time.perf_counter() - t_phase
    say(f"parallel phase seconds: {summary['seconds']:.1f} ({card})")
    return paths, summary


def phase_ring(pool, paths: dict, card: str) -> dict:
    """Ring attention over the pool's ranks (``ring_par_case``): no
    hand-written kernel launched, every reading within ``RING_ULPS``."""
    res = pool.run(ring_par_case, RING_SEQ)
    r0 = res[0]
    readings = {k: r0[k] for k in RING_ULPS}
    say(f"parallel ring attention: b 1, {RING_HEADS} heads, d {RING_D}, "
        f"sequence {RING_SEQ} over {PAR_WORLD} gloo ranks on one card "
        f"({RING_SEQ // PAR_WORLD} a rank), bf16 inputs, causal, forward "
        f"and backward: seconds a rank {[r['seconds'] for r in res]}, "
        f"device memory peak a rank {[round(r['peak_gib'], 2) for r in res]}"
        f" GiB ({card}); against flash_attention on the whole sequence, "
        f"bf16 ulps of the kernels' largest value (limit): "
        + ", ".join(f"{k} {v!r} ({RING_ULPS[k]})" for k, v in readings.items()))
    for k, v in readings.items():
        check(v <= RING_ULPS[k], f"ring attention {k}: {v!r} ulps > "
                                 f"{RING_ULPS[k]}")
    for r in res:
        check(not any(r["counts"].values()), f"ring attention rank "
              f"{r['rank']} launched a kernel: {r['counts']}")
        paths[f"ring_attention_{RING_SEQ}_rank{r['rank']}"] = r["counts"]
    return {**readings, "seconds": [r["seconds"] for r in res],
            "peak_gib": [r["peak_gib"] for r in res]}


def phase_parallel_child(torch) -> dict:
    """phase_parallel in a child process of this script
    (``PARALLEL_CHILD``): its gloo ranks, NCCL world and CUDA contexts
    live and die there. → the paths' counts."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "parallel.json"
        sys.stdout.flush()
        sys.stderr.flush()
        proc = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"),
                               PARALLEL_CHILD, str(out)], timeout=900)
        check(proc.returncode == 0, f"the parallel phase's process exited "
                                    f"{proc.returncode}")
        return json.loads(out.read_text())["paths"]


# kernel line name → (its count in read_counts, its main path)
MAIN_PATHS = {
    "flash_fwd_tc": ("flash_fwd.tc", "llama_train_job_10_steps"),
    "flash_fwd": ("flash_fwd.simt", "http_3_completions"),
    "flash_bwd_dq_tc": ("flash_bwd_dq.tc", "llama_train_job_10_steps"),
    "flash_bwd_dq": ("flash_bwd_dq.simt", "moe_f32_grad_2_layers"),
    "flash_bwd_dkv_tc": ("flash_bwd_dkv.tc", "llama_train_job_10_steps"),
    "flash_bwd_dkv": ("flash_bwd_dkv.simt", "moe_f32_grad_2_layers"),
    "gmm_tc": ("gmm.tc", "moe_grouped_train_10_steps"),
    "gmm": ("gmm.simt", "moe_f32_serve_prefill_generate"),
    "gmm_drhs_tc": ("gmm_drhs.tc", "moe_grouped_train_10_steps"),
    "gmm_drhs": ("gmm_drhs.simt", "moe_f32_grad_2_layers"),
    "adamw_sumsq": ("adamw_sumsq", "llama_train_job_10_steps"),
    "adamw_update": ("adamw_update", "llama_train_job_10_steps"),
    "decode_attention_tc": ("decode_attention.tc",
                            "llama_paged_engine_16_requests"),
    "decode_attention": ("decode_attention.simt", "http_3_completions"),
    "decode_attention_tc_chunk": ("decode_attention.tc.chunk",
                                  "llama_spec_paged_engine_16_requests"),
    "decode_attention_chunk": ("decode_attention.simt.chunk",
                               "serve_job_speculation"),
    "decode_attention_tc_q8": ("decode_attention.tc8",
                               "llama_int8_paged_engine_16_requests"),
    "decode_attention_q8": ("decode_attention.q8", "http_int8"),
    "w8_matmul_tc": ("w8_matmul.tc", "llama_int8_paged_engine_16_requests"),
    "w8_matmul": ("w8_matmul.gemv", "http_int8"),
}
# the chunk route's entries: a route of their kernel, as the profiler names it
CHUNK_OF = {"decode_attention_tc_chunk": "decode_attention_tc",
            "decode_attention_chunk": "decode_attention"}


# -- the serving operations layer ------------------------------------------
# the chaos turn's fault arming (TPU_K8S_FAULTS syntax: site:prob:seed)
OPS_FAULTS = "serve.segment:0.05:7,serve.page_alloc:0.02:11"
OPS_TURNS = 2           # counted clean turns of the engine, before chaos
# the black box's knobs beside its temporary directories: the reference's
# tick (1 s) and pending hold (TPU_K8S_ALERT_FOR_S, 5 s: an engine turn's
# tokens are legitimately unsettled while it runs), a resolve hold and an
# incident close of 1 s so both settle inside the phase
OPS_BLACK_BOX_ENV = {"TPU_K8S_ALERT_RESOLVE_FOR_S": "1",
                     "TPU_K8S_INCIDENTS_CLOSE_S": "1"}
# the quiet gap after each engine turn, on every side alike: the idle
# scheduler's alert tick (at most 1 s apart, idle wakes every 0.5 s) sees
# the turn's tokens settled, as it would between requests on a server
OPS_QUIET_S = 1.6


def ops_settle(results) -> None:
    """Settle each row handed back as useful, as ``complete()`` does, then
    leave the engine quiet for OPS_QUIET_S."""
    from tpu_kubernetes_torch.obs.ledger import LEDGER

    for r in results:
        if isinstance(r, list):
            LEDGER.settle_request("useful", delivered=len(r), decoded=len(r))
    time.sleep(OPS_QUIET_S)


def ops_engine_turns(torch, card: str, turns: int = OPS_TURNS,
                     before_counted=None) -> tuple:
    """llama-1b (full width and depth, bf16, weights from seed 0) on
    phase_engine's paged engine (8 slots, segments of 8, a pool as large
    as the dense cache, pages of DECODE_PAGE) and phase_engine's 16
    requests: warm, a first turn (its captures), then ``turns`` counted
    turns with identical tokens (``before_counted()``, when given, runs
    just before them), each turn's rows settled as useful after it and a
    quiet gap (OPS_QUIET_S) before the next turn. Where
    the checkout's server has the engine's black box
    (``build_black_box``), it is wired as the server wires it: the flight
    recorder, the incident correlator and the tripwires' manager, over
    temporary directories. Runs on any checkout whose port has the
    operations layer (``ops_ab.py`` drives it on both) → (the engine, its params, the
    requests, {"tokens": the turn's tokens, "walls": [s], "seg_ms": [each
    turn's median segment ms], "tokens_s": [...], "black_box": None or
    {"flightrec", "incidents", "alerts", "dir"}})."""
    import tempfile

    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.serve import server as tserver

    cfg = CONFIGS["llama-1b"]
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    requests = engine_requests(torch, cfg, 16, seed=1)
    max_pages = cfg.max_seq // DECODE_PAGE
    pool_mb = ENGINE_SLOTS * max_pages * page_bytes(cfg, DECODE_PAGE) / 2 ** 20
    box, wiring, holder = None, {}, []
    if hasattr(tserver, "build_black_box"):
        bb_dir = tempfile.mkdtemp(prefix="chip_smoke_black_box_")
        env = dict(OPS_BLACK_BOX_ENV,
                   TPU_K8S_FLIGHTREC_DIR=f"{bb_dir}/flightrec",
                   TPU_K8S_INCIDENTS_DIR=f"{bb_dir}/incidents")
        rec, corr, mgr = tserver.build_black_box(
            env, lambda: holder[0].stats() if holder else None)
        box = {"flightrec": rec, "incidents": corr, "alerts": mgr,
               "dir": bb_dir}
        wiring = {"flightrec": rec, "alerts": mgr}
    eng = tserver.ContinuousEngine(
        tserver.GreedyLane(params, cfg), slots=ENGINE_SLOTS,
        seg_steps=ENGINE_STEPS, pool_mb=pool_mb, page_size=DECODE_PAGE,
        **wiring)
    holder.append(eng)
    seg_ms: list = []
    inner = eng._run_segment

    def timed():
        before = eng.segments
        t0 = time.perf_counter()
        inner()
        if eng.segments > before:
            seg_ms.append((time.perf_counter() - t0) * 1e3)
    eng._run_segment = timed         # the scheduler calls it by attribute
    eng.warm()
    want, _ = engine_turn(eng, requests)
    wait_idle(eng)
    ops_settle(want)
    out = {"tokens": want, "walls": [], "seg_ms": [], "tokens_s": [],
           "black_box": box}
    n_tokens = sum(len(t) for t in want)
    if before_counted is not None:
        before_counted()
    for rep in range(turns):
        seg_ms.clear()
        got, wall = engine_turn(eng, requests)
        wait_idle(eng)
        ops_settle(got)
        check(got == want, f"llama-1b ops engine: tokens moved in turn {rep}")
        out["walls"].append(wall)
        out["seg_ms"].append(statistics.median(seg_ms))
        out["tokens_s"].append(n_tokens / wall)
    return eng, params, requests, out


def ops_chaos_turn(eng, requests) -> list:
    """Every request from its own thread (as engine_turn) with faults
    armed → each one's tokens, or its error; none may hang."""
    entries = [None] * len(requests)

    def submit(i):
        time.sleep(i * 0.003)
        entries[i] = eng.enqueue(*requests[i])

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    check(all(e is not None and e["event"].wait(300) for e in entries),
          "a request under chaos never reached a terminal state")
    return [e["tokens"] if e["error"] is None else e["error"]
            for e in entries]


def _raw(port: int, method: str, path: str, body=None, headers=None):
    """→ (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def phase_operations(torch, fa, card: str) -> dict:
    """The serving operations layer on the card. At llama-1b
    (ops_engine_turns' paged engine with the black box wired, its counted
    clean turns: tokens/s and ms a segment with the layer on; the analytic
    roofline's utilization of the segment): one turn with TPU_K8S_FAULTS'
    OPS_FAULTS armed (every request ends in tokens or an error, the pool's
    partition and the goodput ledger conserved), a clean turn after it
    with the tokens of the turn before, and a whole segment with the layer
    on under set_sync_debug_mode("error") but for its own readback. The
    black box over those turns: one flight-recorder record a segment the
    engine ran, every record's page partition conserved, an engine-reset
    dump (reason and error) from the armed turn, the restart tripwire
    fired and an incident opened naming that dump, the page-partition and
    ledger-conservation tripwires never fired. Over HTTP at llama-test:
    /metrics, /debug/ledger, /debug/profile, /debug/trace/<id>,
    /debug/flightrec (segments) and /debug/alerts (the engine tripwires'
    rules) answer, /healthz carries the alert summary, a full queue sheds
    with 429, an expired deadline gives 504, and POST /drain turns
    /healthz to draining, closes the server and leaves a drain dump. →
    the clean turns' launch counts."""
    import os
    import shutil
    import tempfile

    from tpu_kubernetes_torch.obs.faults import ENV_VAR, FAULTS
    from tpu_kubernetes_torch.obs.incidents import list_incidents
    from tpu_kubernetes_torch.obs.ledger import LEDGER
    from tpu_kubernetes_torch.serve.server import (
        PROFILER,
        ContinuousEngine,
        make_server,
    )

    # -- llama-1b: every count at 0 just before the clean turns ----------
    PROFILER.device = torch.device("cuda")
    reset_counts(fa)
    LEDGER.reset()
    # the roofline of the counted turns' segments alone
    eng, params, requests, turns = ops_engine_turns(
        torch, card, before_counted=PROFILER.reset)
    counts = read_counts(fa)
    # -----------------------------------------------------------------------
    want = turns["tokens"]
    box = turns["black_box"]
    check(box is not None, "the checkout's server has no black box")
    rec, corr, mgr = box["flightrec"], box["incidents"], box["alerts"]
    check(rec.snapshot()["recorder"]["segments"] == eng.segments,
          f"the flight recorder holds {rec.snapshot()['recorder']} records "
          f"for {eng.segments} segments")
    segments0 = eng.segments
    roof = PROFILER.roofline()
    decode = roof["programs"]["decode"]
    util = decode["utilization"]
    check(util is not None and 0 < util <= 1.0,
          f"engine segment utilization {util}")
    say(f"ops: llama-1b paged engine, 16 requests, the operations layer on: "
        f"{spread(turns['tokens_s'])} tokens/s, ms a segment (each turn's "
        f"median) {spread(turns['seg_ms'])} [{card}]")
    say(f"ops: analytic roofline of the engine segment: "
        f"{decode['flops_per_token']:.4g} FLOPs and "
        f"{decode['bytes_per_token']:.4g} bytes a token, intensity "
        f"{decode['arithmetic_intensity']}, utilization {util:.4%} of "
        f"{roof['device_kind']}'s {roof['peak_flops']:.4g} FLOP/s [{card}]")

    spec = OPS_FAULTS
    FAULTS.configure(spec)
    try:
        chaos = ops_chaos_turn(eng, requests)
    finally:
        FAULTS.clear()
    wait_idle(eng)
    ok = [r for r in chaos if isinstance(r, list)]
    for r, w in zip(chaos, want):
        check(not isinstance(r, list) or r == w,
              "a request that survived chaos has other tokens")
    ops_settle(chaos)
    t_chaos = time.monotonic()
    pages = eng.stats()["pages"]
    check(pages["free"] + pages["live"] + pages["pinned"] == pages["total"]
          and pages["free"] == pages["total"],
          f"pages not conserved after chaos: {pages}")
    clean, _ = engine_turn(eng, requests)
    wait_idle(eng)
    check(clean == want, "the clean turn after chaos has other tokens")
    ops_settle(clean)
    snap = LEDGER.snapshot(timeline=0)
    check(snap["unsettled"] == 0
          and sum(snap["classes"].values()) == snap["emitted"],
          f"ledger not conserved: {snap['classes']} vs emitted "
          f"{snap['emitted']}, unsettled {snap['unsettled']}")
    say(f"ops: chaos turn ({ENV_VAR}={spec}): {len(ok)} of {len(chaos)} "
        f"requests ended in tokens (identical to the clean turn's), "
        f"{len(chaos) - len(ok)} in an error "
        f"({sorted({type(r).__name__ for r in chaos if r not in ok})}); "
        f"{eng.restarts} cold resets; pages conserved {pages}; the clean "
        f"turn after it identical to the turn before")
    say(f"ops: ledger after the turns: goodput {snap['goodput']}, bubble "
        f"fraction {snap['slot_engine']['bubble_fraction']}, classes "
        f"{snap['classes']}, emitted {snap['emitted']}, unsettled 0")

    # the black box over the chaos and clean turns: the tick evaluates at
    # most once a second, so wait for the restart tripwire and the
    # incident it opens (the idle scheduler still ticks)
    def alerted(rule):
        return [a for a in mgr.active() if a["rule"] == rule]

    deadline = t_chaos + 10
    while time.monotonic() < deadline and not (
            alerted("engine-restarts") and list_incidents(corr.directory)):
        time.sleep(0.05)
    record = rec.snapshot()
    ran_segments = eng.segments - segments0
    check(record["recorder"]["segments"] == eng.segments and ran_segments,
          f"{record['recorder']['segments']} flight-recorder records for "
          f"{eng.segments} segments ({ran_segments} in the chaos and clean "
          f"turns)")
    leaks = [s["pages"] for s in record["segments"]
             if s["pages"]["free"] + s["pages"]["live"] + s["pages"]["pinned"]
             != s["pages"]["total"]]
    check(record["segments"] and not leaks,
          f"records whose page partition is not conserved: {leaks[:3]}")
    fr_dir = rec.directory
    resets = sorted(n for n in os.listdir(fr_dir) if "engine-reset" in n)
    check(resets, f"no engine-reset dump in {os.listdir(fr_dir)}")
    dump = json.loads(Path(fr_dir, resets[-1]).read_text())
    check(dump["reason"] == "engine-reset"
          and "injected fault" in dump["extra"]["error"],
          f"engine-reset dump {dump['reason']} {dump.get('extra')}")
    check(alerted("engine-restarts"), "the restart tripwire never fired: "
          f"{[(a['rule'], a['state']) for a in mgr.active()]}")
    bundles = list_incidents(corr.directory)
    named = [b for b in bundles if any(
        os.path.basename(p) == resets[-1] for p in b["flightrec_dumps"])]
    check(named and "engine-restarts" in named[0]["rules"],
          f"no incident names the reset dump: "
          f"{[(b['incident_id'], b['rules']) for b in bundles]}")
    never = [(a["rule"], a["state"]) for a in mgr.active()
             if a["rule"] in ("page-partition-leak", "ledger-conservation")]
    check(not never, f"an invariant tripwire fired: {never}")
    say(f"ops: black box: {record['recorder']['segments']} flight-recorder "
        f"records for {eng.segments} segments ({ran_segments} in the chaos and "
        f"clean turns), every page partition conserved; {len(resets)} "
        f"engine-reset dump(s) ({dump['extra']['error'][:60]}); tripwires "
        f"{sorted({a['rule'] for a in mgr.active()})} fired, "
        f"page-partition-leak and ledger-conservation never; incident "
        f"{named[0]['incident_id']} names the dump")

    # a whole segment with the layer on under set_sync_debug_mode("error")
    ran = []

    def readback(out):
        # the segment's own sync, in whatever mode the caller ran
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return out.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def once():
        del eng.__dict__["_run_segment"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ContinuousEngine._run_segment(eng)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ran.append(1)

    # the longest budget: its row outlives the segment (no slot clear)
    i = max(range(len(requests)), key=lambda j: requests[j][1])
    eng.__dict__["_readback"] = readback
    FAULTS.configure("serve.segment:0.0,serve.page_alloc:0.0")
    try:
        eng.__dict__["_run_segment"] = once
        tokens, _ = engine_turn(eng, [requests[i]])
    finally:
        FAULTS.clear()
        del eng.__dict__["_readback"]
    check(ran and tokens == [want[i]], "the no-sync segment did not run")
    say("ops: a paged segment with the fault sites armed (at 0), the ledger, "
        "the profiler and the tracer on ran under "
        "set_sync_debug_mode('error') but for its readback")
    eng.close()
    mgr.close()
    shutil.rmtree(box["dir"], ignore_errors=True)
    del eng, params, box, rec, corr, mgr

    # -- HTTP at llama-test -------------------------------------------------
    http_dir = tempfile.mkdtemp(prefix="chip_smoke_http_black_box_")
    env = {**HTTP_ENV, "SERVE_CONTINUOUS_BATCHING": "1", "SERVER_BATCH": "2",
           "SERVE_KV_POOL_MB": "1", "SERVE_DRAIN_TIMEOUT_S": "30",
           "TPU_K8S_FLIGHTREC_DIR": f"{http_dir}/flightrec",
           "TPU_K8S_INCIDENTS_DIR": f"{http_dir}/incidents"}
    LEDGER.reset()
    server = make_server(env)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    state = server.RequestHandlerClass.state
    def scrape():
        code, _, body = _raw(port, "GET", "/metrics")
        check(code == 200, f"/metrics {code}")
        return dict(ln.rsplit(" ", 1) for ln in body.decode().splitlines()
                    if ln and not ln.startswith("#"))

    try:
        before = scrape()
        code, hdrs, body = _raw(port, "POST", "/v1/completions",
                                GREEDY[0], {"X-Request-Id": "smoke-ops-1"})
        check(code == 200 and hdrs.get("X-Request-Id") == "smoke-ops-1"
              and "traceparent" in hdrs, f"completion {code} {hdrs}")
        after = scrape()
        for name, moved in (
                ('tpu_serve_requests_total{endpoint="/v1/completions",'
                 'code="200"}', 1),
                ('tpu_serve_tokens_total{class="useful"}', 8),
                ("tpu_serve_tokens_generated_total", 8)):
            got = float(after[name]) - float(before.get(name, 0))
            check(got == moved, f"/metrics {name} moved {got}, not {moved}")
        code, _, body = _raw(port, "GET", "/debug/ledger")
        led = json.loads(body)
        check(code == 200 and led["unsettled"] == 0 and "roofline" in led
              and "kv_pages" in led and led["classes"]["useful"] == 8,
              f"/debug/ledger {code} {led}")
        code, _, body = _raw(port, "GET", "/debug/profile")
        prof = json.loads(body)
        check(code == 200 and {"prefill", "decode"} <= set(prof["phases"])
              and prof["hbm"]["bytes_limit"] > 0,
              f"/debug/profile {code} {prof}")
        code, _, body = _raw(port, "GET", "/debug/trace/smoke-ops-1")
        check(code == 200 and json.loads(body)["spans"],
              f"/debug/trace {code}")
        code, _, body = _raw(port, "GET", "/debug/flightrec")
        fr = json.loads(body)
        check(code == 200 and fr["segments"]
              and fr["recorder"]["segments"] > 0,
              f"/debug/flightrec {code} {fr.get('recorder')}")
        code, _, body = _raw(port, "GET", "/debug/alerts")
        rules = {r["name"] for r in json.loads(body)["rules"]}
        check(code == 200 and {
            "page-partition-leak", "ledger-conservation", "engine-restarts",
            "error-burst", "fault-injected", "token-counter-stall",
            "queue-runaway"} == rules, f"/debug/alerts {code} {rules}")
        code, _, body = _raw(port, "GET", "/healthz")
        check(code == 200 and set(json.loads(body)["alerts"])
              == {"firing", "pending", "by_severity"},
              f"/healthz alerts {code} {body[:200]}")
        # a full queue sheds: the engine reports a queue at the bound
        state._engine.depth = lambda: state.admission.max_queue
        code, hdrs, body = _raw(port, "POST", "/v1/completions", GREEDY[0])
        del state._engine.depth
        check(code == 429 and int(hdrs["Retry-After"]) >= 1,
              f"a full queue answered {code}")
        code, _, body = _raw(port, "POST", "/v1/completions",
                             {**GREEDY[0], "deadline_ms": 1e-6})
        check(code == 504, f"an expired deadline answered {code}")
        with state._track_busy():        # a request in flight holds it
            code, _, body = _raw(port, "POST", "/drain")
            check(code == 202 and json.loads(body)["accepted"],
                  f"/drain {code}")
            code, _, body = _raw(port, "GET", "/healthz")
            check(code == 503 and json.loads(body)["status"] == "draining",
                  f"/healthz while draining {code} {body}")
        check(state.drain.wait_drained(timeout=30), "the drain never ended")
        thread.join(30)
        check(not thread.is_alive(), "the server outlived its drain")
        drains = [n for n in os.listdir(f"{http_dir}/flightrec")
                  if n.endswith("-drain.json")]
        check(len(drains) == 1, f"drain dumps {drains}")
    finally:
        if thread.is_alive():
            server.shutdown()
        server.server_close()
        state._engine.close()
        state.alerts.close()
        shutil.rmtree(http_dir, ignore_errors=True)
    say(f"ops: http at llama-test: /metrics, /debug/ledger, /debug/profile, "
        f"/debug/trace/<id> 200, /debug/flightrec 200 "
        f"({len(fr['segments'])} segments), /debug/alerts 200 "
        f"({len(rules)} engine tripwires), /healthz alerts, a full queue "
        f"429 with Retry-After, an expired deadline 504, POST /drain 202 "
        f"then /healthz 503 draining, the server closed and one drain dump")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "tpu_kubernetes_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout that holds "
              "tpu_kubernetes_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_kubernetes_torch.ops import _build

    # the modules, not the dispatchers that ops/__init__ re-exports by name
    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    gm = importlib.import_module("tpu_kubernetes_torch.ops.grouped_matmul")
    # f32 means f32: no plain version, and no yardstick, runs on TF32
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matmuls would run on TF32")

    check(Path(fa.__file__).resolve().is_relative_to(HERE),
          f"imported the port from {fa.__file__}, not from this checkout")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # every kernel source, one nvcc each, started together
    cached = {n: _build.library_path(n).exists() for n in _build.SOURCES}
    for lib, sec in _build.build().items():
        say(f"build: {lib} {sec:.2f} s"
            f"{' (library already built)' if cached[lib] else ''}")
    for route in ("tc", "simt"):
        fa.load_kernel(route)
        fa.load_bwd_kernels(route)
        gm.load_kernels(route)
    for route in ("tc", "simt", "q8", "tc8"):
        importlib.import_module("tpu_kubernetes_torch.ops.decode_attention") \
            .load_kernel(route)
    for route in ("tc", "gemv"):
        importlib.import_module("tpu_kubernetes_torch.ops.w8_matmul") \
            .load_kernel(route)
    if PARALLEL_CHILD in sys.argv:
        begin("sharded training (its own process)")
        paths, summary = phase_parallel(torch, card)
        Path(sys.argv[sys.argv.index(PARALLEL_CHILD) + 1]).write_text(
            json.dumps({"paths": paths, "summary": summary}))
        return 0
    if INT8_CHILD in sys.argv:
        begin("int8 serving (its own process)")
        entries, paths, names = phase_int8(torch, fa, card)
        Path(sys.argv[sys.argv.index(INT8_CHILD) + 1]).write_text(json.dumps(
            {"entries": entries, "paths": paths, "names": sorted(names)}))
        return 0

    begin("kernel phases")
    entries = [*phase_kernel(torch, fa), *phase_backward(torch, fa),
               *phase_grouped(torch, gm), *phase_adamw(torch, card),
               *phase_decode_attention(torch, card)]
    phase_grouped_autograd(torch, gm)
    begin("llama-1b serving")
    paths = {"llama_serve_prefill_generate": phase_llama_1b(torch, fa, card)}
    begin("moe-1b serving")
    (paths["moe_serve_prefill_generate"],
     paths["moe_f32_serve_prefill_generate"]) = phase_moe_serve(torch, fa,
                                                                card)
    begin("llama-1b train job")
    paths["llama_train_job_10_steps"] = phase_train(torch, fa, card)
    begin("moe-1b training")
    (paths["moe_grouped_train_10_steps"],
     paths["moe_f32_grad_2_layers"]) = phase_moe_train(torch, fa, card)
    begin("moe-1b train job")
    paths["moe_train_job_10_steps"] = phase_moe_job(torch, fa, card)
    begin("llama-1b adafactor, checkpoints, LoRA, HF round trip")
    (paths["llama_adafactor_job_10_steps"],
     paths["llama_lora_finetune_10_steps"]) = phase_tooling(torch, fa, card)
    begin("http")
    paths["http_3_completions"] = phase_http(torch, fa)
    begin("run_serving")
    paths["serve_job_11_prompts"] = phase_serve_job(torch, fa, card)
    replayed = set()
    # the compiled programs, eager against graphed; every kernel's name
    # must show in a profile of replays alone
    from tpu_kubernetes_torch.models import CONFIGS

    for path, label, cfg, plain in (("llama_graph_serve", "llama-1b",
                                     CONFIGS["llama-1b"], True),
                                    ("moe_graph_serve", "moe-1b grouped",
                                     moe_cfg(), False)):
        begin(f"{label} graphed serving")
        paths[path], names = phase_graph_serve(torch, fa, card, label, cfg,
                                               plain)
        replayed |= names
    # the sampled lane: sampled generate and (at llama-1b) the streamed
    # loop as compiled programs, then the eval step
    for path, label, cfg, new, stream in (
            ("llama_sampled_serve", "llama-1b", CONFIGS["llama-1b"], 64, True),
            ("moe_sampled_serve", "moe-1b grouped", moe_cfg(), 16, False)):
        begin(f"{label} sampled serving")
        paths[path], names = phase_sampled_serve(torch, fa, card, label, cfg,
                                                 new, stream)
        replayed |= names
    begin("llama-1b eval step")
    paths["llama_eval_step"] = phase_eval(torch, fa, card)
    # the continuous slot engine and the batching servers
    for model, label, cfg, n, extra in (
            ("llama", "llama-1b", CONFIGS["llama-1b"], 16, True),
            ("moe", "moe-1b grouped", moe_cfg(), 8, False)):
        begin(f"{label} engine")
        (paths[f"{model}_engine_{n}_requests"],
         paths[f"{model}_paged_engine_{n}_requests"], names) = phase_engine(
            torch, fa, card, label, cfg, n, extra)
        replayed |= names
    begin("long context")
    long_model = long_context_model(torch)
    paths["llama_long_context_engine"] = phase_long_context(
        torch, fa, card, model=long_model)["counts"]
    begin("prefix cache")
    prefix = phase_prefix_cache(torch, fa, card, long_model)
    del long_model
    torch.cuda.empty_cache()
    paths["llama_prefix_cache_solo"] = prefix["solo"]
    paths["llama_prefix_cache_paged_engine"] = prefix["paged"]
    paths["http_prefix_cache"] = prefix["http"]
    for entry in entries:
        # the warm prefill's shape beside the kernel's training-shape line
        if entry["name"] in prefix["at_warm_shape"]:
            entry["at_warm_shape"] = prefix["at_warm_shape"][entry["name"]]
    begin("http engine and batcher")
    paths["http_engine_and_batcher"], names = phase_http_batching(torch, fa,
                                                                  card)
    replayed |= names
    for path, label, cfg, shape, tol in (
            ("llama_graph_train", "llama-1b", CONFIGS["llama-1b"],
             (4, 2048), TRAIN_LOSS_REL_TOL),
            ("moe_graph_train", "moe-1b grouped", moe_cfg(), (4, 2048),
             TRAIN_LOSS_REL_TOL),
            ("moe_f32_graph_train_2_layers", "moe-1b grouped f32 2 layers",
             replace(moe_cfg(), n_layers=2, dtype=torch.float32), (1, 2048),
             MOE_LOSS_REL_TOL)):
        begin(f"{label} graphed training")
        paths[path], names = phase_graph_train(torch, fa, card, label, cfg,
                                               *shape, 5, tol)
        replayed |= names
    begin("operations")
    paths["llama_ops_engine"] = phase_operations(torch, fa, card)
    # last: its many graphs and engines come after every profiled phase
    begin("speculation")
    spec_entries, spec_paths = phase_speculation(torch, fa, card)
    entries += spec_entries
    paths.update(spec_paths)
    # last, and in a process of its own (phase_int8_child)
    begin("int8 serving")
    int8_entries, int8_paths, names = phase_int8_child(torch)
    entries += int8_entries
    paths.update(int8_paths)
    replayed |= names
    # the sharded train step over gloo ranks sharing the card, in a
    # process of its own (phase_parallel_child)
    begin("sharded training")
    paths.update(phase_parallel_child(torch))
    begin("kernel counts")
    unseen = [e["name"] for e in entries
              if not any(re.search(
                  rf"\b{KERNEL_FUNCTIONS[CHUNK_OF.get(e['name'], e['name'])]}"
                  rf"\b", n) for n in replayed)]
    say(f"kernels seen in the replay-only profiles: "
        f"{len(entries) - len(unseen)} of {len(entries)}")
    check(not unseen, f"never seen in a replay: {unseen}")
    for entry in entries:
        # each kernel's count and main path: the tensor-core kernels on the
        # bf16 training paths, the CUDA-core kernels where their dtype or
        # head_dim takes them (llama-test's d 16 over HTTP, moe-1b in f32:
        # serving for the forwards, the gradient check for dQ, dK/dV and
        # drhs); every path's counts ride along
        key, main_path = MAIN_PATHS[entry["name"]]
        entry["main_path"] = main_path
        entry["launches"] = paths[main_path][key]
        entry["launches_by_path"] = {p: c[key] for p, c in paths.items()}
        check(entry["launches"] > 0, f"{entry['name']} never launched on its "
                                     f"main path {main_path}")

    begin("result")
    say(json.dumps({"kernels": entries}))
    say(card)                        # name, power limit as nvidia-smi says
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    # a crash inside a native library still names the Python frames of
    # every thread on stderr
    faulthandler.enable(all_threads=True)
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
