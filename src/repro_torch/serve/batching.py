"""Continuous batching: a fixed-slot decode batch where every slot runs at
its own position; finished sequences are evicted between steps and queued
prompts are admitted into the freed slots.

Port of :mod:`repro.serve.batching`.  Two admission paths: whole-prompt
(default) and chunked prefill (``prefill_chunk > 0``), which streams the
prompt through the tick loop.  The paged KV cache (auto-on for
attention-only models) replaces the per-slot ring buffer with page pools
plus a ``[slots, max_pages]`` table from :class:`PageAllocator`, with
prefix reuse through copy-on-write forks; a paged whole-prompt admission
runs the prompt (or, on a prefix-cache hit, its uncached remainder) as one
decode-mode continuation chunk, so a hit and a miss give a request the same
bits.  The dense cache admits through a batch-1 prefill whose K/V scatter
into the slot.  A model with recurrent state
(Mamba-2) runs dense, whole-prompt only: admission overwrites the slot's
whole state column, and every slot, live or dead, advances its state each
tick, as the reference's do.  Every cache update here is an in-place index
write into the batcher's tensors.

Sampled decoding (``sample=True``) keys each emitted token with
``fold(fold(PRNGKey(sample_seed), rid), output index)`` (DESIGN.md §11,
:mod:`repro_torch.prng`), so the draw is a pure function of the request and
the position.  Speculative decoding (``spec_k > 0``, paged only) drafts up
to ``spec_k`` tokens a slot with the cheap draft config
(:func:`repro_torch.models.moe.draft_config`), then scores all of them with
the full model in one verify pass; the longest agreeing prefix plus the
verifier's next token is emitted, which is what serial decoding emits, bit
for bit, greedy or sampled.  Rejected tails are truncated off the slot's
pages.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.obs import trace
from repro_torch.serve.paged import PageAllocator
from repro_torch.train.train_step import (
    make_draft_loop_step,
    make_prefill_chunk_step,
    make_prefill_step,
    make_serve_step,
    make_verify_step,
)

__all__ = ["ContinuousBatcher", "Request", "TickStats"]


@torch.no_grad()
def _scatter_slot_caches(caches, one, slot: int) -> None:
    """Write ONE slot's column of every dense cache leaf, in place."""
    for name, c in caches.items():
        for key, full in c.items():
            full[:, slot].copy_(one[name][key][:, 0])


@torch.no_grad()
def _copy_pages(caches, src: list, dst: list) -> None:
    """Copy-on-write fork: duplicate pages ``src -> dst`` in every pool, in
    place."""
    for c in caches.values():
        for pool in c.values():
            s = torch.as_tensor(src, device=pool.device)
            d = torch.as_tensor(dst, device=pool.device)
            pool[:, d] = pool[:, s]


def _fold_span_keys(base, rids, starts, c: int) -> torch.Tensor:
    """``[B, c, 2]`` keys for a c-token span: slot s's key j is
    ``fold(fold(base, rids[s]), starts[s] + j)``.  The key stream is a pure
    function of (request, output position), so speculative and serial decode
    consume the same keys however many drafts were burned on the way."""
    k1 = prng.fold_in(base, rids)  # [B, 2]
    counts = starts[:, None] + torch.arange(c, dtype=starts.dtype, device=starts.device)
    return prng.fold_in(k1[:, None, :], counts)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S_prompt] int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    # Traffic-region tag (workload regions; None = untagged).
    region: int | None = None
    out: list = dataclasses.field(default_factory=list)
    error: str | None = None
    submit_tick: int = -1  # tick the request entered the queue
    first_token_tick: int = -1  # tick its first output token was emitted
    finish_tick: int = -1


@dataclasses.dataclass
class _Prefill:
    """Chunked-prefill progress of one admitted-but-not-yet-live request."""

    req: Request
    slot: int
    pos: int = 0


@dataclasses.dataclass
class TickStats:
    """What one tick did — the serving engine's observation surface."""

    live: int  # decode slots served
    prefill_tokens: int  # chunked-prefill tokens advanced this tick
    admitted: int
    finished: int
    gate_load: np.ndarray | None  # [repeats, E] live-slot expert loads
    # Speculative round telemetry (DESIGN.md §11); zero on plain ticks.
    spec_drafted: int = 0  # draft tokens proposed (live slots x span k)
    spec_accepted: int = 0  # draft tokens accepted AND emitted
    spec_verified: int = 0  # positions the full model scored (live x (k+1))


class ContinuousBatcher:
    """Slot-based continuous batching over eager decode steps."""

    def __init__(
        self,
        params,
        cfg,
        plan,
        *,
        slots: int = 4,
        max_len: int = 128,
        mesh=None,
        prefill_chunk: int = 0,
        sample: bool = False,
        paged: bool | None = None,
        page_size: int = 16,
        num_pages: int = 0,
        prefix_cache: bool = True,
        spec_k: int = 0,
        spec_draft_mode: str = "auto",
        sample_seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.plan = plan
        self.mesh = mesh
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = int(prefill_chunk)
        self.sample = bool(sample)
        self.sample_seed = int(sample_seed)
        self._base_key = prng.prng_key(self.sample_seed, self.device) if self.sample else None
        self.spec_k = int(spec_k)
        # Measurement plane: the owning engine points ``trace_tid`` at its
        # viewer track so batcher spans land on the same timeline row.
        self._tr = trace.default()
        self.trace_tid: int | None = None
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.t = np.zeros(slots, np.int32)  # next write position per slot
        self.tokens = np.zeros((slots, 1), np.int32)
        self.paged = tfm.paged_supported(cfg) if paged is None else bool(paged)
        self.alloc: PageAllocator | None = None
        if self.paged:
            self.page_size = int(page_size)
            self.max_pages = -(-max_len // self.page_size)
            self.num_pages = int(num_pages) or slots * self.max_pages
            self.caches = tfm.init_paged_caches(
                cfg, self.num_pages, self.page_size, device=self.device,
                plan=plan if mesh is not None else None,
            )
            self.alloc = PageAllocator(
                slots=slots,
                page_size=self.page_size,
                max_pages=self.max_pages,
                num_pages=self.num_pages,
                prefix_cache=prefix_cache,
            )
        else:
            self.caches = tfm.init_caches(cfg, slots, max_len, device=self.device,
                                          plan=plan if mesh is not None else None)
        self._step = make_serve_step(cfg, plan, mesh, sample=self.sample, with_stats=True)
        # The dense cache admits through a prefill; the paged one through
        # the chunk step.
        self._prefill_fn = (None if self.paged
                            else make_prefill_step(cfg, plan, mesh, with_stats=True))
        # Paged mode always has the chunk step: it admits every prompt (from
        # position 0, or mid-way after a prefix-cache hit).
        self._chunk_fn = (
            make_prefill_chunk_step(cfg, plan, mesh, with_stats=True)
            if self.prefill_chunk > 0 or self.paged
            else None
        )
        # Speculative decoding: the draft appends into the same page pool,
        # so a rejection is a length truncation; the dense ring buffer has no
        # such invariant, hence the paged requirement.
        self.draft_mode = "off"
        self._verify_fn = None
        self._draft_cfg = None
        self._draft_fns: dict[int, object] = {}  # span k -> draft loop
        if self.spec_k > 0:
            if not self.paged:
                raise ValueError(
                    "speculative decoding requires the paged KV cache "
                    "(pass paged=True / a paged-capable model)"
                )
            self.draft_mode = moe_mod.resolve_draft_mode(cfg, spec_draft_mode)
            self._draft_cfg = moe_mod.draft_config(cfg, spec_draft_mode)
            self._verify_fn = make_verify_step(cfg, plan, mesh, sample=self.sample,
                                               with_stats=True)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        self.prefilling: deque[_Prefill] = deque()
        self.finished: list[Request] = []
        self.tick = 0
        self.kv_resident_pages_peak = 0
        # Runtime placement state threaded by the serving engine (numpy;
        # identity when no control plane drives this batcher).
        self.expert_perm: np.ndarray | None = None
        self.wire_perm: np.ndarray | None = None

    # -- host -> device -------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submit_tick = self.tick
        self.queue.append(req)

    def _perm_args(self):
        perm = None if self.expert_perm is None else self._dev(self.expert_perm.astype(np.int32))
        wire = None if self.wire_perm is None else self._dev(self.wire_perm.astype(np.int32))
        return perm, wire

    def _finish(self, req: Request) -> None:
        req.finish_tick = self.tick
        self.finished.append(req)

    def _emit_first(self, req: Request, first: int) -> bool:
        """Record the prefill's next-token; True if the request is done."""
        req.out.append(first)
        req.first_token_tick = self.tick
        prompt_full = len(req.prompt) + 1 > self.max_len
        done = (
            len(req.out) >= req.max_new_tokens
            or (req.eos_id is not None and first == req.eos_id)
            or prompt_full  # no cache room to decode further
        )
        if done:
            self._finish(req)
        return done

    def _admit(self) -> tuple[int, np.ndarray | None]:
        admitted = 0
        load = None
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            if any(p.slot == slot for p in self.prefilling):
                continue  # slot reserved by an in-flight chunked prefill
            req = self.queue.popleft()
            if len(req.prompt) > self.max_len:
                req.error = "prompt_too_long"
                self._finish(req)
                continue
            plan_a = None
            if self.paged:
                plan_a = self.alloc.admit(
                    slot, req.prompt, req.max_new_tokens + self.spec_k, self.max_len,
                )
                if plan_a is None:
                    # Pool cannot cover the request yet; keep FIFO order.
                    self.queue.appendleft(req)
                    break
            admitted += 1
            if self.prefill_chunk > 0:
                start = plan_a.start if plan_a is not None else 0
                self.prefilling.append(_Prefill(req, slot, pos=start))
                continue
            if self.paged:
                load = self._admit_paged(req, slot, plan_a, load)
            else:
                load = self._admit_whole(req, slot, load)
        return admitted, load

    def _admit_whole(self, req: Request, slot: int, load):
        """Per-slot prefill: batch-1 prefill of the prompt, its next-token is
        the request's first output, its caches scatter into this slot."""
        perm, wire = self._perm_args()
        batch = {"tokens": self._dev(req.prompt[None, :])}
        next_tok, one, stats = self._prefill_fn(self.params, batch, perm, wire)
        first = int(next_tok[0, 0])
        _scatter_slot_caches(self.caches, tfm.pad_caches(one, self.max_len), slot)
        if stats is not None:
            s = stats.cpu().numpy()
            load = s if load is None else load + s
        if self._emit_first(req, first):
            return load
        self.active[slot] = req
        self.t[slot] = len(req.prompt)
        self.tokens[slot, 0] = first
        return load

    def _admit_paged(self, req: Request, slot: int, plan_a, load):
        """Paged admission: the prompt from ``plan_a.start`` on runs as ONE
        decode-mode continuation chunk over the slot's pages — from position
        0 on a miss, past the reused pages on a prefix-cache hit.  One route
        for both, so a row's bits never depend on whether its prefix was
        cached: every product runs on ``layers.decode_rows`` blocks and, on
        the card, the attention is the paged kernel, whose split follows the
        table's width alone (a whole-prompt prefill would take cuBLAS at
        M = the prompt's length and the flash kernel instead)."""
        prompt = np.asarray(req.prompt)
        n = len(prompt)
        self._apply_forks(self.alloc.ensure(slot, plan_a.start, n))
        next_tok, stats = self._run_chunk(slot, prompt[plan_a.start :], plan_a.start)
        first = int(next_tok[0, 0])
        self.alloc.register_prefix(slot, prompt)
        if stats is not None:
            s = stats.cpu().numpy()
            load = s if load is None else load + s
        if self._emit_first(req, first):
            self.alloc.release(slot)
            return load
        self.active[slot] = req
        self.t[slot] = n
        self.tokens[slot, 0] = first
        return load

    def _apply_forks(self, forks) -> None:
        if forks:
            _copy_pages(self.caches, [f[0] for f in forks], [f[1] for f in forks])

    def _run_chunk(self, slot: int, chunk: np.ndarray, pos: int):
        """Run a decode-mode continuation chunk for one slot.  Paged mode
        runs batch-1 against the shared pools through the slot's table row;
        dense mode runs on the slot's column views, so its writes land in
        the batcher's caches in place."""
        perm, wire = self._perm_args()
        tokens = self._dev(np.asarray(chunk, np.int32)[None, :])
        t = self._dev(np.asarray([pos], np.int32))
        if self.paged:
            next_tok, _, stats = self._chunk_fn(
                self.params, self.caches, tokens, t, perm, wire, None,
                self._dev(self.alloc.table[slot : slot + 1]),
            )
            return next_tok, stats
        view = {n: {k: v[:, slot : slot + 1] for k, v in c.items()} for n, c in self.caches.items()}
        next_tok, _, stats = self._chunk_fn(self.params, view, tokens, t, perm, wire)
        return next_tok, stats

    def _advance_prefill(self) -> tuple[int, np.ndarray | None]:
        """Advance ONE pending prompt by up to ``prefill_chunk`` tokens —
        the chunk rides the same tick the decode step does."""
        if not self.prefilling:
            return 0, None
        pf = self.prefilling[0]
        chunk = pf.req.prompt[pf.pos : pf.pos + self.prefill_chunk]
        with self._tr.span("serve.prefill_chunk", tid=self.trace_tid,
                           rid=pf.req.rid, tokens=len(chunk)):
            if self.paged:
                self._apply_forks(self.alloc.ensure(pf.slot, pf.pos, pf.pos + len(chunk)))
            next_tok, stats = self._run_chunk(pf.slot, np.asarray(chunk), pf.pos)
        pf.pos += len(chunk)
        load = None if stats is None else stats.cpu().numpy()
        if pf.pos >= len(pf.req.prompt):
            self.prefilling.popleft()
            if self.paged:
                self.alloc.register_prefix(pf.slot, np.asarray(pf.req.prompt))
            first = int(next_tok[0, 0])
            if self._emit_first(pf.req, first):
                if self.paged:
                    self.alloc.release(pf.slot)
            else:
                self.active[pf.slot] = pf.req
                self.t[pf.slot] = len(pf.req.prompt)
                self.tokens[pf.slot, 0] = first
        return len(chunk), load

    def _span_keys(self, c: int) -> torch.Tensor:
        """``[slots, c, 2]`` sample keys for a c-token span: slot s's key j
        is ``fold(fold(base, rid), len(out) + j)``, the per-verified-token
        discipline that makes speculative and serial sampling identical."""
        rids = np.zeros(self.slots, np.int64)
        starts = np.zeros(self.slots, np.int64)
        for s in range(self.slots):
            req = self.active[s]
            if req is not None:
                rids[s] = req.rid
                starts[s] = len(req.out)
        return _fold_span_keys(self._base_key, self._dev(rids), self._dev(starts), c)

    # -- one decode tick -------------------------------------------------------
    def step(self) -> TickStats:
        """Admit, advance one prefill chunk, decode one token (or one
        speculative draft/verify round) for every active slot, evict
        finished.  Returns the tick's observations."""
        admitted, pre_load = self._admit()
        prefill_tokens, chunk_load = self._advance_prefill()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        finished = 0
        gate_load = None
        spec_drafted = spec_accepted = spec_verified = 0
        if live and self.spec_k > 0:
            finished, gate_load, spec_drafted, spec_accepted, spec_verified = (
                self._spec_tick(live)
            )
        elif live:
            perm, wire = self._perm_args()
            live_mask = np.zeros((self.slots, 1), np.float32)
            live_mask[live] = 1.0
            page_table = None
            if self.paged:
                # Every live slot writes position t[s] this tick; fork any
                # shared page in range and allocate fresh pages on demand.
                for s in live:
                    self._apply_forks(
                        self.alloc.ensure(s, int(self.t[s]), int(self.t[s]) + 1)
                    )
                page_table = self._dev(self.alloc.table)
            rng = self._span_keys(1)[:, 0] if self.sample else None
            # The live mask weights the exported gate telemetry and keeps
            # dead slots from writing K/V at stale positions.
            with self._tr.span("serve.decode", tid=self.trace_tid, live=len(live)):
                next_tok, _, stats = self._step(
                    self.params,
                    self.caches,
                    self._dev(self.tokens),
                    self._dev(self.t),
                    rng,
                    perm,
                    wire,
                    self._dev(live_mask),
                    page_table,
                )
            if stats is not None:
                gate_load = stats.cpu().numpy()
            next_np = next_tok.cpu().numpy()
            for s in live:
                req = self.active[s]
                tok = int(next_np[s, 0])
                req.out.append(tok)
                self.t[s] += 1
                self.tokens[s, 0] = tok
                done = (
                    len(req.out) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.t[s] >= self.max_len
                )
                if done:
                    finished += 1
                    self._finish(req)
                    self.active[s] = None
                    if self.paged:
                        self.alloc.release(s)
        if self.paged:
            self.kv_resident_pages_peak = max(
                self.kv_resident_pages_peak, self.alloc.resident_pages()
            )
        for extra in (pre_load, chunk_load):
            if extra is not None:
                gate_load = extra if gate_load is None else gate_load + extra
        self.tick += 1
        return TickStats(
            live=len(live),
            prefill_tokens=prefill_tokens,
            admitted=admitted,
            finished=finished,
            gate_load=gate_load,
            spec_drafted=spec_drafted,
            spec_accepted=spec_accepted,
            spec_verified=spec_verified,
        )

    def _spec_tick(self, live):
        """One speculative draft/verify round (DESIGN.md §11).

        Draft the next k tokens a live slot with the draft config, then
        score all k + 1 positions with the full model in one verify pass.
        The accepted prefix (the longest run where draft and verify agree,
        plus verify's token at the first disagreement, or a bonus token when
        all agreed) is what serial decoding would have emitted, greedy or
        sampled (verify draws with the keys serial decoding would use).
        Rejected positions hold orphaned K/V: the slot's length does not
        advance over them, and whole unused pages go back to the allocator.
        """
        perm, wire = self._perm_args()
        # Uniform span: clamp k so every live slot's k + 1 writes stay inside
        # the page table.
        k = self.spec_k
        for s in live:
            k = min(k, self.max_len - 1 - int(self.t[s]))
        k = max(k, 0)
        c = k + 1
        # The draft writes t .. t+k-1 and verify rewrites t .. t+k: make the
        # whole span privately writable first (CoW forks and fresh pages,
        # from the spec_k admission headroom).
        for s in live:
            self._apply_forks(self.alloc.ensure(s, int(self.t[s]), int(self.t[s]) + c))
        page_table = self._dev(self.alloc.table)
        t_vec = self._dev(self.t)
        live_mask = np.zeros((self.slots, c), np.float32)
        live_mask[live] = 1.0
        span_keys = self._span_keys(c) if self.sample else None
        tokens = np.zeros((self.slots, c), np.int32)
        tokens[:, 0] = self.tokens[:, 0]
        draft_np = None
        if k > 0:
            draft_fn = self._draft_fns.get(k)
            if draft_fn is None:
                draft_fn = make_draft_loop_step(self._draft_cfg, self.plan, self.mesh, k=k,
                                                sample=self.sample)
                self._draft_fns[k] = draft_fn
            with self._tr.span("serve.spec_draft", tid=self.trace_tid, k=k, live=len(live)):
                drafts, _ = draft_fn(
                    self.params,
                    self.caches,
                    self._dev(self.tokens),
                    t_vec,
                    None if span_keys is None else span_keys[:, :k],
                    perm,
                    wire,
                    self._dev(live_mask[:, :1]),
                    page_table,
                )
            draft_np = drafts.cpu().numpy()
            tokens[:, 1:] = draft_np
        with self._tr.span("serve.spec_verify", tid=self.trace_tid, span=c, live=len(live)):
            toks, _, stats = self._verify_fn(
                self.params,
                self.caches,
                self._dev(tokens),
                t_vec,
                span_keys,
                perm,
                wire,
                self._dev(live_mask),
                page_table,
            )
        gate_load = None if stats is None else stats.cpu().numpy()
        v = toks.cpu().numpy()
        finished = 0
        drafted = k * len(live)
        accepted = 0
        for s in live:
            req = self.active[s]
            a = 0
            while a < k and draft_np[s, a] == v[s, a]:
                a += 1
            emit = [int(x) for x in v[s, : a + 1]]
            # EOS inside the accepted span: stop AT the EOS; the verified
            # tail past it would never exist in serial decode.
            if req.eos_id is not None and req.eos_id in emit:
                emit = emit[: emit.index(req.eos_id) + 1]
            emit = emit[: req.max_new_tokens - len(req.out)]
            accepted += min(len(emit), a)
            req.out.extend(emit)
            self.t[s] += len(emit)
            self.tokens[s, 0] = emit[-1]
            done = (
                len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and emit[-1] == req.eos_id)
                or self.t[s] >= self.max_len
            )
            if done:
                finished += 1
                self._finish(req)
                self.active[s] = None
                self.alloc.release(s)
            elif len(emit) < c:
                # Rejected or cut tail: whole pages past the accepted length
                # go back to the free list and the reservation is restored.
                self.alloc.truncate(s, int(self.t[s]))
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_rounds += 1
        return finished, gate_load, drafted, accepted, c * len(live)

    @property
    def busy(self) -> bool:
        return bool(
            self.queue or self.prefilling or any(a is not None for a in self.active)
        )

    def run(self, max_ticks: int = 1000) -> list[Request]:
        for _ in range(max_ticks):
            if not self.busy:
                break
            self.step()
        return self.finished
