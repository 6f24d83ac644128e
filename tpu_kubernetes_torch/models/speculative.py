"""Speculative decoding: assisted greedy generation, token-exact (port of
``tpu_kubernetes/models/speculative.py``).

Two drafting strategies over one verification loop:

* :func:`speculative_generate`: a small DRAFT MODEL proposes ``draft_k``
  tokens sequentially.
* :func:`prompt_lookup_generate`: NO draft model: the most recent n-gram
  match in the already-seen context (prompt + generated) proposes its
  historical continuation.

Either way the target scores all proposals in ONE verify forward, the
slot engine's :func:`~tpu_kubernetes_torch.models.decode.
decode_verify_slots` on a batch of one, and keeps the longest prefix it
agrees with, plus its own correction token (``_verify_accept``, the one
acceptance rule of the port), so each target pass emits between 1 and
draft_k + 1 tokens, and the output is the target's own greedy decode (up
to the reduction order of the cache's layout, which can flip near-tied
argmaxes between programs).

The reference runs one ``lax.while_loop`` per prompt shape; here a host
loop runs rounds. The prompt is right-padded to a width bucket (the next
power of two from 16) and prefilled ragged, as the server's lanes do, so
one set of buffers and programs, keyed by (width, span, draft_k), serves
every prompt length of its bucket. Each round is ONE compiled program
(``util/graphs.py``: a CUDA graph on the card, the same body eagerly on
the CPU): the proposals (the draft model's ``draft_k + 1`` decode steps,
or the n-gram search over a device buffer of the context), the target's
verify window, the acceptance, the accepted tokens written into the
context and the round's state advanced, all on the device. The host reads
one small tensor a round, the emitted count, the accepted drafts and the
window's tokens. Cache rollback is the position arithmetic itself: the
next round's window starts right after the last accepted token, and the
stale slots above it are masked and then overwritten.

On the card the verify window attends through the decode-attention
kernel's chunk route, so ``draft_k + 1`` is at most ``MAX_CHUNK`` there.
Batch 1 only, and a dense target, as in the reference.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Iterator, NamedTuple

import torch

from tpu_kubernetes_torch.models.decode import (
    KVCache,
    decode_step,
    decode_verify_slots,
    init_cache,
    init_slot_state,
    prefill,
)
from tpu_kubernetes_torch.models.llama import ModelConfig
from tpu_kubernetes_torch.models.moe import MoEConfig
from tpu_kubernetes_torch.ops.decode_attention import MAX_CHUNK
from tpu_kubernetes_torch.util.graphs import Programs


class SpecStats(NamedTuple):
    """rounds: target chunk passes run; drafted: draft tokens proposed;
    accepted: draft tokens the target agreed with AND that fit the
    remaining budget, i.e. draft tokens actually emitted (the speedup
    signal: tokens a target pass = emitted / rounds)."""

    rounds: int
    drafted: int
    accepted: int


def _check_target(cfg: ModelConfig, prompt: torch.Tensor) -> None:
    if prompt.shape[0] != 1:
        raise ValueError(f"speculative decoding is batch-1 only, got batch "
                         f"{prompt.shape[0]}")
    if isinstance(cfg, MoEConfig):
        # expert capacity is computed per forward chunk, so a (k+1)-token
        # verify pass can drop tokens sequential decode keeps (a MoE
        # *draft* is fine: drafts only propose)
        raise ValueError(
            "speculative verification requires a dense target model "
            "(MoE capacity semantics are chunk-size-dependent)")


def check_draft_k(draft_k: int) -> None:
    """The verify window ``draft_k + 1`` is one chunk of the
    decode-attention kernel's chunk route: at most MAX_CHUNK positions."""
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    if draft_k + 1 > MAX_CHUNK:
        raise ValueError(
            f"draft_k {draft_k} makes a verify window of {draft_k + 1} "
            f"positions; the decode-attention kernel's chunk route takes at "
            f"most MAX_CHUNK = {MAX_CHUNK} (draft_k <= {MAX_CHUNK - 1})")


def spec_width(plen: int, room: int) -> int:
    """The width a prompt of ``plen`` tokens is padded to: the next power
    of two from 16, but at most ``room`` (what the span leaves a prompt;
    at least ``plen``)."""
    width = 16
    while width < plen:
        width *= 2
    return max(plen, min(width, room))


def _ragged_cache(cfg, span: int, lengths: torch.Tensor, width: int,
                  device, kv_quant: bool = False) -> KVCache:
    cache = init_cache(cfg, 1, span, kv_quant=kv_quant, device=device)
    return replace(cache, length=width, prompt_lengths=lengths,
                   prompt_slots=width)


class _Run:
    """The buffers of one (width, span, draft_k) shape, which its prefill
    and round programs close over: the right-padded prompt (copied in per
    call), the target's (and the draft's) ragged cache of ``span``, the
    row's :class:`~tpu_kubernetes_torch.models.decode.SlotState` (the last
    token, its slot, the tokens it may still emit, its prompt length), the
    budget, the context ``[prompt | out | zeros | k + 1 trash]`` (a round's
    accepted tokens land after the prompt's real end; its unaccepted ones
    in the trash tail, at ``span``) and the one result the host reads a
    round: (emitted, accepted, the window's k + 1 tokens). ``draft_kv_quant``
    makes the draft's cache int8."""

    def __init__(self, cfg, draft_cfg, width: int, span: int, k: int,
                 device, draft_kv_quant: bool = False):
        self.width, self.span, self.k = width, span, k
        i32 = torch.int32
        self.tokens = torch.zeros((1, width), dtype=i32, device=device)
        self.st = init_slot_state(1, device)
        self.st.prompt_slots.fill_(width)
        lengths = self.st.prompt_lengths
        self.cache_t = _ragged_cache(cfg, span, lengths, width, device)
        self.cache_d = (_ragged_cache(draft_cfg, span, lengths, width, device,
                                      draft_kv_quant)
                        if draft_cfg is not None else None)
        self.ctx = torch.zeros((span + k + 1,), dtype=i32, device=device)
        self.budget = torch.zeros((1,), dtype=i32, device=device)
        self.result = torch.zeros((k + 3,), dtype=i32, device=device)


def _prefill_body(params, cfg, draft_params, draft_cfg, run: _Run):
    """The prompt into the target's (and the draft's) cache, its greedy
    first token into the context after the prompt, the row's state to
    that token at slot ``width`` with ``budget - 1`` to go."""
    width, span, st = run.width, run.span, run.st

    def body():
        logits, _ = prefill(params, run.tokens, cfg, max_seq=span,
                            lengths=st.prompt_lengths, cache=run.cache_t)
        if draft_cfg is not None:
            prefill(draft_params, run.tokens, draft_cfg, max_seq=span,
                    lengths=st.prompt_lengths, cache=run.cache_d)
        first = torch.argmax(logits, dim=-1).to(torch.int32)     # (1,)
        run.ctx.zero_()
        run.ctx[:width].copy_(run.tokens[0])      # zeros past the prompt
        run.ctx.index_copy_(0, st.prompt_lengths.long(), first)
        st.tok.copy_(first)
        st.pos.fill_(width)                       # the last token's slot
        st.remaining.copy_(run.budget - 1)
    return body


def _round_body(params, cfg, propose, run: _Run):
    """One verify round (the reference's ``_spec_loop`` body): drafts from
    ``propose(run)`` ((k,) int32), the target's window ``[last, drafts]``
    at the last token's slot through :func:`decode_verify_slots` (which
    accepts the matched prefix plus one correction token, clipped to the
    budget, and advances the row's state), the emitted tokens written
    into the context after the last one. Invariant at every round
    boundary: the caches hold every position before the last token, which
    sits at slot ``st.pos``, emitted token t at slot ``width + t``."""
    k, width, span, st = run.k, run.width, run.span, run.st
    off = torch.arange(k + 1, dtype=torch.int32, device=run.ctx.device)

    def body():
        drafts = propose(run)                                    # (k,)
        pos = st.pos.clone()
        emitted = decode_verify_slots(params, run.cache_t, st, drafts[None],
                                      cfg)[0][0]                 # (k + 1,)
        n_emit = st.pos - pos                                    # (1,)
        # the context index of the first new token: right after the last
        at = torch.where(off < n_emit, st.prompt_lengths + (pos - width) + 1
                         + off, span + off)
        run.ctx.index_put_((at.long(),), emitted)
        # the drafts emitted: the matched prefix, as far as the budget
        hit = (drafts == emitted[:k]) & (off[:k] < n_emit)
        accepted = torch.cumprod(hit.to(torch.int32), dim=0).sum()
        run.result.copy_(torch.cat((n_emit, accepted.reshape(1).to(
            torch.int32), emitted)))
    return body


def spec_rounds(params, cfg, ids: list, max_new: int, k: int, kind: str,
                propose: Callable[[_Run], torch.Tensor], *, width: int,
                span: int, programs: Programs, draft_params=None,
                draft_cfg=None, draft_kv_quant: bool = False
                ) -> Iterator[tuple[list, int]]:
    """The shared prefill / verify / accept loop of one prompt (a list of
    ``len(ids) <= width`` token ids): the ``kind`` ("draft", "draft_kvq"
    over an int8 draft cache, or "lookup<n>") programs of key (width,
    span, k) from ``programs`` (one
    cache serves one set of weights, which its programs keep; ``span``
    must hold ``width + max_new + k``). Yields (tokens, drafts accepted):
    first the prefill's greedy token, then each round's emitted tokens,
    until ``max_new`` are out; the caller may stop early (an EOS)."""
    key = (kind, width, span, k)
    device = programs.device

    def build():
        # the shape's buffers, which both programs close over
        run = _Run(cfg, draft_cfg, width, span, k, device, draft_kv_quant)
        body = _prefill_body(params, cfg, draft_params, draft_cfg, run)
        body.run = run
        return body

    pf = programs.get(("spec_prefill",) + key, build)
    run = pf.body.run
    rnd = programs.get(("spec_round",) + key, lambda: _round_body(
        params, cfg, propose, run))
    row = torch.zeros((1, width), dtype=torch.int32)
    row[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    run.tokens.copy_(row, non_blocking=True)
    run.st.prompt_lengths.fill_(len(ids))
    run.budget.fill_(max_new)
    pf()
    yield [int(run.st.tok[0])], 0
    emitted = 1
    while emitted < max_new:
        rnd()
        result = run.result.tolist()             # the round's one host read
        n_emit = result[0]
        emitted += n_emit
        yield result[2:2 + n_emit], result[1]


def _spec_loop(params, prompt, cfg, max_new_tokens: int, k: int, kind: str,
               propose, draft_params=None, draft_cfg=None,
               programs: Programs | None = None, room: int | None = None,
               draft_kv_quant: bool = False
               ) -> tuple[torch.Tensor, SpecStats]:
    """:func:`spec_rounds` run to the end over ``prompt`` (1, plen) at
    its width bucket (at most ``room``), in ``programs`` (a fresh
    :class:`Programs` on the prompt's device by default) → ((1,
    max_new_tokens) int32, stats)."""
    plen = prompt.shape[1]
    if programs is None:
        programs = Programs(prompt.device)
    width = spec_width(plen, room if room is not None else plen)
    out, rounds, accepted = [], -1, 0
    for new, acc in spec_rounds(
            params, cfg, prompt[0].tolist(), max_new_tokens, k, kind,
            propose, width=width, span=width + max_new_tokens + k,
            programs=programs, draft_params=draft_params,
            draft_cfg=draft_cfg, draft_kv_quant=draft_kv_quant):
        out += new
        rounds += 1
        accepted += acc
    return (torch.tensor([out], dtype=torch.int32, device=prompt.device),
            SpecStats(rounds=rounds, drafted=rounds * k, accepted=accepted))


def speculative_generate(
    params: dict, draft_params: dict, prompt: torch.Tensor, cfg: ModelConfig,
    draft_cfg: ModelConfig, max_new_tokens: int, *, draft_k: int = 4,
    draft_kv_quant: bool = False, programs: Programs | None = None,
) -> tuple[torch.Tensor, SpecStats]:
    """prompt (1, prompt_len) int → ((1, max_new_tokens) int32, stats).

    Draft-model speculative decoding; the emitted tokens are the target's
    greedy decode (``generate(params, prompt, cfg, max_new_tokens)``, up
    to near-tied argmaxes). A round's proposals are ``draft_k``
    greedy decode steps of the draft from the last token, plus one more
    step on its last proposal, so a fully accepted round finds that
    proposal's K/V in the draft's cache next round. ``programs`` keeps the
    compiled programs across calls (a server's or a job's; by default the
    call makes its own). ``draft_kv_quant`` runs the DRAFT on an int8 KV
    cache (proposals only: the target's cache stays full precision, so
    the output is unchanged)."""
    _check_target(cfg, prompt)
    check_draft_k(draft_k)
    plen = prompt.shape[1]
    # chunk writes can reach plen + max_new - 1 + draft_k
    span = plen + max_new_tokens + draft_k
    for name, c in (("target", cfg), ("draft", draft_cfg)):
        if span > c.max_seq:
            raise ValueError(
                f"prompt {plen} + new {max_new_tokens} + draft_k {draft_k} "
                f"exceeds {name} max_seq {c.max_seq}")
    k = draft_k

    def propose(run: _Run) -> torch.Tensor:
        st = run.st
        start = st.pos[0].long()                # the last token's slot
        tok, drafts = st.tok, []
        for i in range(k + 1):
            # the k-th step only writes the last proposal's K/V
            logits, _ = decode_step(draft_params, run.cache_d, tok,
                                    draft_cfg, start=start + i)
            if i < k:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                drafts.append(tok)
        return torch.cat(drafts)

    room = min(cfg.max_seq, draft_cfg.max_seq) - max_new_tokens - k
    return _spec_loop(params, prompt, cfg, max_new_tokens, k,
                      "draft_kvq" if draft_kv_quant else "draft", propose,
                      draft_params, draft_cfg, programs, room,
                      draft_kv_quant=draft_kv_quant)


def prompt_lookup_generate(
    params: dict, prompt: torch.Tensor, cfg: ModelConfig, max_new_tokens: int,
    *, draft_k: int = 8, ngram: int = 2, programs: Programs | None = None,
) -> tuple[torch.Tensor, SpecStats]:
    """Draft-model-FREE speculative decoding (prompt lookup): propose the
    continuation of the most recent earlier occurrence of the last
    ``ngram`` tokens in the seen context (prompt + generated so far),
    searched on the device (:func:`_ngram_propose`). Output is the
    target's greedy decode, as for :func:`speculative_generate`; when no
    n-gram repeats, each round still emits the target's one correction
    token."""
    _check_target(cfg, prompt)
    if draft_k < 1 or ngram < 1:
        raise ValueError(f"draft_k ({draft_k}) and ngram ({ngram}) must be "
                         f">= 1")
    check_draft_k(draft_k)
    plen = prompt.shape[1]
    # the reference's span: the prompt, the budget, a window's drafts
    span = plen + max_new_tokens + draft_k
    if span > cfg.max_seq:
        raise ValueError(
            f"prompt {plen} + new {max_new_tokens} + draft_k {draft_k} "
            f"exceeds max_seq {cfg.max_seq}")
    if ngram > span - 1:
        raise ValueError(f"ngram ({ngram}) exceeds the context length "
                         f"({span})")

    return _spec_loop(params, prompt, cfg, max_new_tokens, draft_k,
                      f"lookup{ngram}", _lookup_propose(ngram, draft_k),
                      programs=programs,
                      room=cfg.max_seq - max_new_tokens - draft_k)


def _lookup_propose(ngram: int, k: int):
    """The n-gram proposer of a round: :func:`_ngram_propose` over the
    context seen so far (the prompt, then every token up to the last)."""
    def propose(run: _Run) -> torch.Tensor:
        st = run.st
        seen = st.prompt_lengths[0].long() + (st.pos[0].long()
                                              - run.width) + 1
        return _ngram_propose(run.ctx[:run.span], seen, ngram, k, st.tok[0])
    return propose


def prompt_lookup_rounds(params: dict, cfg: ModelConfig, ids: list,
                         max_new: int, *, draft_k: int, ngram: int,
                         width: int, span: int, programs: Programs
                         ) -> Iterator[tuple[list, int]]:
    """:func:`prompt_lookup_generate`'s rounds as :func:`spec_rounds`
    yields them, for a caller that streams them and stops at its EOS (the
    server's solo lane), at its own width and span."""
    return spec_rounds(params, cfg, ids, max_new, draft_k, f"lookup{ngram}",
                       _lookup_propose(ngram, draft_k), width=width,
                       span=span, programs=programs)


def ngram_propose_host(ctx: list, n: int, k: int, last: int) -> list:
    """:func:`_ngram_propose` as plain host Python over a real-token list:
    the proposer the server's solo lookup lane and the slot engine run
    per row between verify rounds. Find the LATEST earlier occurrence of
    the last ``n`` tokens of ``ctx`` and return the k tokens after it,
    padded with ``last`` where the continuation runs out; no match (or a
    context too short to hold an n-gram and its recurrence) → ``last``
    repeated k times. Proposals set the speed of the verify loop, never
    its tokens."""
    if n < 1 or k < 1:
        raise ValueError(f"ngram ({n}) and draft_k ({k}) must be >= 1")
    if len(ctx) > n:
        tail = list(ctx[-n:])
        for start in range(len(ctx) - n - 1, -1, -1):
            if list(ctx[start:start + n]) == tail:
                cont = list(ctx[start + n:start + n + k])
                return cont + [last] * (k - len(cont))
    return [last] * k


def _ngram_propose(ctx: torch.Tensor, valid, n: int, k: int, last
                   ) -> torch.Tensor:
    """The prompt-lookup matcher on the device, static in shape: find the
    LATEST occurrence of ``ctx[valid - n : valid]`` (the tail n-gram)
    strictly before the tail itself within ``ctx[:valid]``, and return the
    k tokens after it. No match → ``last`` repeated k times. ``ctx`` is a
    1-d int tensor that holds at least k positions past ``valid``;
    ``valid`` and ``last`` are ints or 0-d tensors on its device."""
    device = ctx.device
    valid = torch.as_tensor(valid, device=device).long()
    last = torch.as_tensor(last, device=device).to(ctx.dtype)
    n_windows = ctx.shape[0] - n + 1
    # a context shorter than n has no match (below); its tail is clamped
    tail = ctx[(valid - n).clamp(min=0) + torch.arange(n, device=device)]
    # windows[i] = ctx[i : i + n], as n shifted slices
    windows = torch.stack([ctx[j:j + n_windows] for j in range(n)], dim=1)
    pos = torch.arange(n_windows, device=device)
    # a match strictly BEFORE the tail itself, wholly inside the seen ctx
    match = (windows == tail[None, :]).all(dim=1) & (pos < valid - n)
    latest = torch.where(match, pos, torch.full_like(pos, -1)).max()
    start = (latest + n).clamp(min=0)
    at = (start + torch.arange(k, device=device)).clamp(max=ctx.shape[0] - 1)
    return torch.where(match.any(), ctx[at], last.expand(k))
