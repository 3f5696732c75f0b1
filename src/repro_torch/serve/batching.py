"""Continuous batching: a fixed-slot decode batch where every slot runs at
its own position; finished sequences are evicted between steps and queued
prompts are admitted into the freed slots.

Port of :mod:`repro.serve.batching`.  Two admission paths: whole-prompt
prefill (default) — the prompt runs through a batch-1 prefill whose K/V
scatter into the slot — and chunked prefill (``prefill_chunk > 0``), which
streams the prompt through the tick loop.  The paged KV cache (auto-on for
attention-only models) replaces the per-slot ring buffer with page pools
plus a ``[slots, max_pages]`` table from :class:`PageAllocator`, with
prefix reuse through copy-on-write forks.  A model with recurrent state
(Mamba-2) runs dense, whole-prompt only: admission overwrites the slot's
whole state column, and every slot, live or dead, advances its state each
tick, as the reference's do.  Every cache update here is an in-place index
write into the batcher's tensors.  Sampled decoding
(``sample=True``) and speculative decoding (``spec_k > 0``) raise until
their slice.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.obs import trace
from repro_torch.serve.paged import PageAllocator
from repro_torch.train.train_step import (
    make_prefill_chunk_step,
    make_prefill_step,
    make_serve_step,
)

__all__ = ["ContinuousBatcher", "Request", "TickStats"]


@torch.no_grad()
def _scatter_slot_caches(caches, one, slot: int) -> None:
    """Write ONE slot's column of every dense cache leaf, in place."""
    for name, c in caches.items():
        for key, full in c.items():
            full[:, slot].copy_(one[name][key][:, 0])


@torch.no_grad()
def _scatter_prompt_pages(caches, one, page_ids: np.ndarray) -> None:
    """Scatter a batch-1 prefill's K/V into the page pool, in place.

    ``one`` leaves are ``[reps, 1, P*page, Hkv, dh]`` (padded to the table's
    span); ``page_ids [P]`` maps logical page j to its pool slot, and -1
    entries (past the prompt, or reused prefix pages that must not be
    overwritten) are skipped."""
    keep = np.nonzero(page_ids >= 0)[0]
    for name, c in caches.items():
        for key, pool in c.items():
            reps, page = pool.shape[0], pool.shape[2]
            new = one[name][key][:, 0].reshape(reps, len(page_ids), page, *pool.shape[3:])
            dst = torch.as_tensor(page_ids[keep], device=pool.device)
            src = torch.as_tensor(keep, device=pool.device)
            pool[:, dst] = new[:, src].to(pool.dtype)


@torch.no_grad()
def _copy_pages(caches, src: list, dst: list) -> None:
    """Copy-on-write fork: duplicate pages ``src -> dst`` in every pool, in
    place."""
    for c in caches.values():
        for pool in c.values():
            s = torch.as_tensor(src, device=pool.device)
            d = torch.as_tensor(dst, device=pool.device)
            pool[:, d] = pool[:, s]


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
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_verified: int = 0


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
        if sample:
            raise NotImplementedError("sampled decoding comes with its slice")
        if spec_k > 0:
            raise NotImplementedError("speculative decoding comes with its slice")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.plan = plan
        self.mesh = mesh
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = int(prefill_chunk)
        self.sample = False
        self.spec_k = 0
        self.draft_mode = "off"
        self.spec_drafted = 0
        self.spec_accepted = 0
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
                cfg, self.num_pages, self.page_size, device=self.device
            )
            self.alloc = PageAllocator(
                slots=slots,
                page_size=self.page_size,
                max_pages=self.max_pages,
                num_pages=self.num_pages,
                prefix_cache=prefix_cache,
            )
        else:
            self.caches = tfm.init_caches(cfg, slots, max_len, device=self.device)
        self._step = make_serve_step(cfg, plan, with_stats=True)
        self._prefill_fn = make_prefill_step(cfg, plan, with_stats=True)
        # Paged mode always has the chunk step: a prefix-cache hit resumes
        # the prompt mid-way as a decode-mode continuation.
        self._chunk_fn = (
            make_prefill_chunk_step(cfg, plan, with_stats=True)
            if self.prefill_chunk > 0 or self.paged
            else None
        )
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
        """Paged admission: whole-prompt prefill scatters K/V into freshly
        allocated pages; a prefix-cache hit skips the reused pages and runs
        only the remainder as a decode-mode continuation chunk."""
        prompt = np.asarray(req.prompt)
        n = len(prompt)
        perm, wire = self._perm_args()
        if plan_a.start == 0:
            self._apply_forks(self.alloc.ensure(slot, 0, n))
            batch = {"tokens": self._dev(prompt[None, :])}
            next_tok, one, stats = self._prefill_fn(self.params, batch, perm, wire)
            one = tfm.pad_caches(one, self.max_pages * self.page_size)
            _scatter_prompt_pages(self.caches, one, np.asarray(self.alloc.table[slot]))
        else:
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

    # -- one decode tick -------------------------------------------------------
    def step(self) -> TickStats:
        """Admit, advance one prefill chunk, decode one token for every
        active slot, evict finished.  Returns the tick's observations."""
        admitted, pre_load = self._admit()
        prefill_tokens, chunk_load = self._advance_prefill()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        finished = 0
        gate_load = None
        if live:
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
            # The live mask weights the exported gate telemetry and keeps
            # dead slots from writing K/V at stale positions.
            with self._tr.span("serve.decode", tid=self.trace_tid, live=len(live)):
                next_tok, _, stats = self._step(
                    self.params,
                    self.caches,
                    self._dev(self.tokens),
                    self._dev(self.t),
                    None,
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
        )

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
