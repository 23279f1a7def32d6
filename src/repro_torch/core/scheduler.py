"""Token-budget continuous-batching scheduler: one mixed *step plan* of
decode tokens and prefill chunks per engine step.

``plan_step(token_budget)`` replaces one-request-per-step admission: every
step gets a budget of model-forward tokens and the plan fills it with

1. one decode token for EVERY running sequence that has a token pending
   (decode is never starved — inter-token latency stays flat),
2. prefill chunks (up to ``chunk_size`` tokens each) for sequences that
   were admitted earlier but whose prompt is still mid-prefill, oldest
   admission first, and
3. admissions of waiting requests into the remaining budget — ordered by
   *uncached-suffix length* (prefix-cache-aware prioritization: the
   request whose prompt is cheapest to prefill, because most of it is
   already cached, goes first) instead of strict FCFS.

Admission stays in units of *sequences*: a multi-choice request
(``n > 1``) admits all of its choice sequences or none of them, so
siblings always decode together.  The dense backend reserves
``max_context`` per slot up front and prefills monolithically (its chunk
size is "the whole prompt"); the paged backend admits as long as the
page pool can cover the prompt plus per-sibling copy-on-write tail
forks, allocates pages chunk by chunk, and preempts when an append fails
mid-step.  Preemption evicts a whole *group* (every slot admitted under
the same request), so sibling choices stay consistent — the request is
re-queued at the front, WebLLM-style graceful degradation rather than a
crash.

The scheduler never touches runner state: the plan names sequence/request
objects and token counts; the engine executes it.  Scheduled items are
duck-typed — running items may expose ``next_token`` (a decode is
pending) and ``prefill_remaining`` (prompt tokens not yet in KV); the
admission probe callback supplies per-request cost info.

Planning and execution speak the same structure: alongside the per-kind
lists, ``plan_step`` emits a packed :class:`RaggedLayout` — decode
tokens as length-1 rows, each sequence's planned prefill chunks merged
into one multi-token row — which the paged backend's fused
``run_step`` dispatches as ONE ragged attention kernel call per engine
step (admissions join the layout engine-side once their sequences hold
slots).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.paged_cache import OutOfPages, PageManager


@dataclass
class AdmissionInfo:
    """What admitting a waiting request would cost.

    ``need``: longest per-sequence context its prompts require (tokens);
    ``n``: sequences in its unfinished choice set; ``shared``: one prompt
    prefill CoW-forked into the siblings; ``suffix``: total uncached
    tokens to actually compute (the prioritization key).
    """
    need: int
    n: int = 1
    shared: bool = True
    suffix: int = 1


@dataclass
class RaggedRow:
    """One row of the packed ragged step layout: ``n`` consecutive
    tokens of one sequence.  ``kind="decode"`` rows carry 1 token —
    or, with speculative decoding planned (``plan_step(draft_k=...)``),
    ``1 + draft_k`` for draft-eligible sequences: the pending token
    plus a prompt-lookup draft tail verified in the same fused step.

    ``completes`` marks a prefill row whose tokens finish the
    sequence's prompt this step — the row whose final logits the fused
    step SAMPLES from (for the sequence and any fork-pending siblings);
    mid-prompt rows produce no token and their logits never leave the
    device.  Decode rows always sample.  The flag is the planner's
    statement of that contract (exercised by the planner unit tests);
    the engine re-derives it at execution time because admission rows
    join the layout after planning and planned rows can shrink."""
    seq: object
    n: int
    kind: str                             # "decode" | "prefill"
    completes: bool = False               # prefill row finishing the prompt


@dataclass
class RaggedLayout:
    """The packed ragged layout of one engine step — the structure the
    planner emits and the runner's fused ``run_step`` consumes, so
    planning and execution speak the same shape.

    Rows are ordered decode-first (each a length-1 row), then one MERGED
    prefill row per still-prefilling sequence (all of that sequence's
    planned chunk tokens this step).  ``offsets()`` gives each row's
    first query-slot index in the packed buffer; ``pad_counts`` reports
    how much padding a ``(row_bucket, token_bucket)`` jit bucket adds.
    """
    rows: List[RaggedRow] = field(default_factory=list)

    def add(self, seq, n: int, kind: str):
        """Append ``n`` tokens of ``seq``; consecutive prefill tokens of
        the same sequence merge into its existing row (chunks of one
        sequence planned back-to-back are one longer ragged row)."""
        if (kind == "prefill" and self.rows
                and self.rows[-1].kind == "prefill"
                and self.rows[-1].seq is seq):
            self.rows[-1].n += n
        else:
            self.rows.append(RaggedRow(seq, n, kind))

    @property
    def total_tokens(self) -> int:
        return sum(r.n for r in self.rows)

    def offsets(self, stride: Optional[int] = None) -> List[int]:
        """Packed start offset of each row: ragged (cumulative ``n``)
        by default, or strided when every row occupies a fixed
        ``stride`` slots (the padded kernel buffer layout)."""
        if stride is not None:
            return [i * stride for i in range(len(self.rows))]
        out, acc = [], 0
        for r in self.rows:
            out.append(acc)
            acc += r.n
        return out

    def pad_counts(self, row_bucket: int,
                   token_bucket: int) -> Tuple[int, int]:
        """(pad rows, pad token slots) a ``(row_bucket, token_bucket)``
        kernel bucket adds: whole pad rows below ``row_bucket`` plus the
        per-row tail slots up to ``token_bucket``."""
        pad_rows = row_bucket - len(self.rows)
        pad_slots = row_bucket * token_bucket - self.total_tokens
        return pad_rows, pad_slots


@dataclass
class StepPlan:
    """One engine step: decode everything running, spend the rest of the
    token budget on prefill chunks and admissions."""
    decode: List[object] = field(default_factory=list)
    #: (running sequence, n tokens) chunks to prefill, in order
    prefill: List[Tuple[object, int]] = field(default_factory=list)
    #: (waiting request, first-chunk token allotment) to admit, in order
    admit: List[Tuple[object, int]] = field(default_factory=list)
    budget_used: int = 0
    #: packed ragged layout of the decode + prefill work above (the
    #: fused-step execution order); admissions join engine-side once
    #: their sequences are bound to slots
    layout: RaggedLayout = field(default_factory=RaggedLayout)


class Scheduler:
    #: planning passes a request may be outranked before it is AGED —
    #: promoted ahead of the cheapest-suffix ordering (FCFS among aged
    #: requests), so a long cold prompt cannot starve under a steady
    #: stream of cheap cache-hit arrivals
    AGING_PLANS = 64

    # lint (repro.analysis pass 1): the scheduler is lock-free — all
    # mutable planning state is confined to the engine loop thread, and
    # only the declared ``_CROSS_THREAD`` entry points may be called
    # from other threads (len()/counter reads + ``waiting`` appends).
    # ``waiting`` is excluded from confinement on purpose: it is a
    # thread-safe deque shared with submitter threads by design.
    _THREAD_CONFINED = ("running", "free_slots", "_admit_seq",
                        "_admitted_at", "_group_of", "_outranked",
                        "n_plans", "n_admitted", "n_preemptions")
    _CROSS_THREAD = ("enqueue", "stats")

    def __init__(self, *, max_slots: int, max_context: int,
                 page_manager: Optional[PageManager] = None):
        self.max_slots = max_slots
        self.max_context = max_context
        self.pm = page_manager
        self.waiting: Deque = deque()
        self.running: Dict[int, object] = {}       # slot -> sequence state
        self.free_slots: List[int] = list(range(max_slots))
        self._admit_seq = 0
        self._admitted_at: Dict[int, int] = {}     # slot -> admission order
        self._group_of: Dict[int, object] = {}     # slot -> owning request
        self._outranked: Dict[int, int] = {}       # id(request) -> planning
        #                                            passes spent waiting
        # counters (surfaced via stats())
        self.n_plans = 0
        self.n_admitted = 0
        self.n_preemptions = 0

    def enqueue(self, item):
        self.waiting.append(item)

    # -- step planning ---------------------------------------------------
    def plan_step(self, token_budget: int, *,
                  chunk_size: Optional[int] = None,
                  admission_info: Optional[Callable[[object],
                                                    AdmissionInfo]] = None,
                  draft_k: int = 0) -> StepPlan:
        """Plan one engine step under ``token_budget`` model-forward
        tokens.

        Decode tokens for running sequences are planned unconditionally
        (even when they alone exceed the budget — starving decode would
        stall streams).  The remaining budget goes to prefill chunks of
        already-admitted, still-prefilling sequences (oldest first), then
        to admissions of waiting requests ranked cheapest-uncached-suffix
        first.  ``chunk_size`` of None means monolithic prefill (the
        dense backend).  ``admission_info`` probes a waiting request's
        cost; requests it maps to None are skipped this step.

        ``draft_k > 0`` (speculative decoding) widens draft-eligible
        decode rows to ``1 + draft_k`` layout tokens — a verify window:
        the pending token plus up to ``draft_k`` prompt-lookup drafts,
        sampled at every window position in the same fused step.
        Eligible means the sequence is unconstrained (``matcher``
        forces the grammar flush path, which is depth-1/k=0) and is
        not sitting out its own in-flight window; device-fed rows
        draft too, anchoring the lookup one token earlier.  The engine
        may shrink the tail at dispatch (rows shrinking after planning
        is already the layout's contract), so the widened ``n`` is a
        budget ceiling.
        """
        self.n_plans += 1
        plan = StepPlan()
        # a resumed-after-preemption sequence can hold a pending
        # next_token while its prompt is being re-prefilled — it must
        # NOT decode until the chunk cursor catches up, or the token's
        # K/V would land mid-prompt
        # ``inflight_src`` marks a pipelined decode whose input token is
        # still on device (sampled by the in-flight step) — it decodes
        # via a device-to-device gather, no host token needed.  A
        # sequence whose prefill just dispatched its final chunk
        # (prefill_ids still set, remaining 0) sits out one step: its
        # first sampled token only becomes gatherable after the
        # completing step is in flight.
        plan.decode = [
            seq for seq in (self.running[s] for s in self.active_slots)
            if (getattr(seq, "next_token", None) is not None
                or getattr(seq, "inflight_src", None) is not None)
            and not int(getattr(seq, "prefill_remaining", 0) or 0)
            and getattr(seq, "prefill_ids", None) is None]
        used = 0
        for seq in plan.decode:
            n = 1
            # widen: host-fed rows, and device-fed rows (their draft
            # tail anchors one token earlier) — but not sequences whose
            # own verify window is still in flight (inflight_src None,
            # n_inflight > 0): those sit the step out
            if (draft_k > 0
                    and getattr(seq, "matcher", None) is None
                    and (getattr(seq, "inflight_src", None) is not None
                         or not getattr(seq, "n_inflight", 0))):
                n += draft_k
            plan.layout.add(seq, n, "decode")
            used += n
        # continue in-flight chunked prefills, oldest admission first
        for slot in sorted(self.running,
                           key=lambda s: self._admitted_at.get(s, 0)):
            seq = self.running[slot]
            if getattr(seq, "finish_reason", None) is not None:
                # finished but release-deferred (it still has a row in
                # the pipeline's in-flight step): plan nothing for it
                continue
            rem = int(getattr(seq, "prefill_remaining", 0) or 0)
            while rem > 0 and used < token_budget:
                n = min(rem, chunk_size or rem, token_budget - used)
                plan.prefill.append((seq, n))
                # back-to-back chunks of one sequence merge into a
                # single ragged row (the fused kernel runs them as one
                # longer chunk)
                plan.layout.add(seq, n, "prefill")
                used += n
                rem -= n
                if rem == 0:
                    # this row's final token finishes the prompt: the
                    # fused step samples its logits on device
                    plan.layout.rows[-1].completes = True
        # admissions into whatever budget is left, cheapest suffix first
        # probing every waiting request costs a radix walk each — skip
        # the whole pass when no slot or budget could admit anything
        if (admission_info is not None and self.waiting
                and self.free_slots and used < token_budget):
            infos = []
            ages = {}
            # snapshot: callers may enqueue concurrently with planning
            for i, r in enumerate(list(self.waiting)):
                info = admission_info(r)
                if info is None:
                    continue
                waited = self._outranked.get(id(r), 0)
                ages[id(r)] = waited + 1
                # aged requests rank first, FCFS among themselves —
                # cheapest-suffix ordering must not starve them forever
                rank = ((0, i, 0) if waited >= self.AGING_PLANS
                        else (1, info.suffix, i))
                infos.append((rank, r, info))
            self._outranked = ages          # prune departed requests
            infos.sort(key=lambda t: t[0])
            slots_left = len(self.free_slots)
            pages_left = None
            if self.pm is not None:
                # headroom: one decode-growth page per running sequence
                # PLUS the pages still-prefilling sequences will need for
                # their remaining chunks — an admission must not eat the
                # pool out from under an older half-prefilled prompt
                reserved = sum(
                    -(-int(getattr(s, "prefill_remaining", 0) or 0)
                      // self.pm.page_size)
                    for s in self.running.values())
                pages_left = (self.pm.available_pages
                              - len(self.running) - reserved)
            for _, r, info in infos:
                if used >= token_budget:
                    break
                if info.n > slots_left:
                    continue
                if pages_left is not None:
                    req_pages = (self._prompt_pages(info.need, info.n,
                                                    info.shared) + info.n)
                    if req_pages > pages_left:
                        continue
                    pages_left -= req_pages
                slots_left -= info.n
                first = max(1, min(info.suffix, chunk_size or info.suffix,
                                   token_budget - used))
                plan.admit.append((r, first))
                used += first
        plan.budget_used = used
        return plan

    # -- page accounting -------------------------------------------------
    def _prompt_pages(self, prompt_len: int, n: int, shared: bool) -> int:
        """Pages a choice set's prompts occupy.  ``shared``: one prompt
        prefill CoW-forked into the siblings (a tail fork page each);
        otherwise (resumed, diverged choices — or the dense fallback's
        accounting) every sequence holds its own full copy."""
        per_seq = -(-prompt_len // self.pm.page_size)
        if shared:
            return per_seq + (n - 1)
        return per_seq * n

    def can_admit(self, prompt_len: int, n: int = 1,
                  shared: bool = True) -> bool:
        """Room for ``n`` sequences of (at most) ``prompt_len`` tokens —
        all-or-nothing for a request's whole choice set."""
        if len(self.free_slots) < n:
            return False
        if self.pm is not None:
            # prompt pages plus decode-growth headroom: one page for each
            # new sequence and one per already-running sequence.  Prefix-
            # cache-evictable pages count as available; eviction happens
            # lazily on allocation.
            pages_needed = (self._prompt_pages(prompt_len, n, shared)
                            + n + len(self.running))
            return self.pm.available_pages >= pages_needed
        return True

    def fits_ever(self, prompt_len: int, n: int = 1,
                  shared: bool = True) -> bool:
        """False iff the request could not run even with the whole page
        pool to itself (prompt copies + one decode-growth page each) —
        admitting it anyway would preempt/re-prefill forever."""
        if n > self.max_slots:
            return False
        if self.pm is None:
            return True
        return (self._prompt_pages(prompt_len, n, shared) + n
                <= self.pm.num_pages)

    # -- slot binding ----------------------------------------------------
    def admit(self, item, group=None) -> int:
        """Bind one sequence to a slot.  ``group`` ties sibling choices
        of one request together for preemption; it defaults to the item
        itself (single-sequence requests)."""
        slot = self.free_slots.pop()
        self.running[slot] = item
        self._admit_seq += 1
        self.n_admitted += 1
        self._admitted_at[slot] = self._admit_seq
        self._group_of[slot] = group if group is not None else item
        return slot

    def release(self, slot: int):
        self.running.pop(slot, None)
        self._admitted_at.pop(slot, None)
        self._group_of.pop(slot, None)
        self.free_slots.append(slot)

    def release_group(self, group) -> List[Tuple[int, object]]:
        """Release every slot admitted under ``group``; returns the
        ``(slot, item)`` list the caller must free runner-side."""
        released: List[Tuple[int, object]] = []
        for slot in sorted(s for s in list(self.running)
                           if self._group_of.get(s) is group):
            item = self.running.pop(slot)
            self._admitted_at.pop(slot, None)
            self._group_of.pop(slot, None)
            self.free_slots.append(slot)
            released.append((slot, item))
        return released

    def preempt_newest(self) -> Tuple[object, List[Tuple[int, object]]]:
        """Kick the most recently admitted *group* back to the queue.

        Every slot admitted under the same group is released together so
        sibling choices stay consistent.  Returns ``(group, released)``
        where ``released`` is the ``(slot, item)`` list the caller must
        free runner-side."""
        if not self.running:
            raise OutOfPages("nothing to preempt")
        newest = max(self.running, key=lambda s: self._admitted_at[s])
        group = self._group_of[newest]
        released = self.release_group(group)
        self.waiting.appendleft(group)
        self.n_preemptions += 1
        return group, released

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.running)

    def stats(self) -> dict:
        out = {"waiting": len(self.waiting), "running": len(self.running),
               "free_slots": len(self.free_slots),
               "plans": self.n_plans, "admitted": self.n_admitted,
               "preemptions": self.n_preemptions}
        if self.pm is not None:
            out["pages"] = self.pm.stats()
        return out
