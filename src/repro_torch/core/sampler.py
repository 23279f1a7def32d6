"""Per-request sampling params + the host sampling fallback/oracle.

Since the batched device sampler landed (``kernels/sampling.py``), the
paged engine path never materializes logits on the host: the whole
pipeline — logit bias, frequency/presence/repetition penalties, grammar
bitmask, temperature, top-k, top-p, and the draw — runs on the
accelerator inside the fused ragged step, and only sampled token ids
cross back.  :class:`RequestSampler` remains in two roles:

* the **dense-backend fallback** (that path still pulls logits to host
  and samples here, in the same pipeline order), and
* the **property-test oracle** for the device op — greedy results must
  match exactly; stochastic results must match at the distribution
  level (:meth:`RequestSampler.dist` exposes the final filtered
  distribution the draw is taken from).

:class:`SamplingParamsBatch` is the packed struct-of-arrays form of one
step's sampling rows the engine ships to ``run_step``: per-row scalars
(temperature/top-k/top-p/penalties, counter-based PRNG seeds), dense
bias and generated-token-count planes, and packed ``uint32`` grammar
bitmasks.  ``parent[s]`` names the attention row whose logits row ``s``
samples from — several rows may share one parent (``n``-way siblings
sampling a freshly completed prompt prefill).

RNG contract: the device draw is counter-based — row ``s`` uses
``fold_in(PRNGKey(seed), counter)`` where ``seed`` is the request seed
plus the choice index and ``counter`` counts tokens this sequence has
sampled (``n_sampled``).  The host fallback keeps its stateful
generator; both are deterministic under a fixed request seed.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


class RequestSampler:
    def __init__(self, *, temperature: float = 1.0, top_p: float = 1.0,
                 top_k: int = 0, min_p: float = 0.0,
                 typical_p: float = 1.0,
                 frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0,
                 repetition_penalty: float = 1.0,
                 logit_bias: Optional[Dict[int, float]] = None,
                 seed: Optional[int] = None):
        self.temperature = max(0.0, temperature)
        self.top_p = top_p
        self.top_k = top_k
        # min-p filter: drop tokens with p < min_p * max(p).  Clamped to
        # [0, 1] — the top token always survives, so min_p can never
        # empty the distribution (device op clamps identically)
        self.min_p = min(1.0, max(0.0, min_p))
        # locally-typical filter: keep the lowest |surprisal - entropy|
        # tokens until their mass reaches typical_p.  Clamped to [0, 1];
        # the most-typical token always survives, so the support can
        # never go empty (device op clamps identically)
        self.typical_p = min(1.0, max(0.0, typical_p))
        self.frequency_penalty = frequency_penalty
        self.presence_penalty = presence_penalty
        self.repetition_penalty = repetition_penalty
        self.logit_bias = logit_bias or {}
        # an unseeded request still needs a concrete seed for the
        # counter-based device PRNG — draw one, then both paths (host
        # stateful generator, device counter keys) derive from it
        self.seed = (int(seed) if seed is not None
                     else int(np.random.default_rng().integers(2**31 - 1)))
        self.rng = np.random.default_rng(self.seed)
        self.counts: Counter = Counter()       # generated-token counts
        self.n_sampled = 0                     # device PRNG counter

    def observe(self, token: int):
        self.counts[token] += 1
        self.n_sampled += 1

    def penalized(self, logits: np.ndarray,
                  grammar_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Bias + penalties + grammar mask (the pipeline prefix shared
        by the greedy and stochastic arms).  float32 end to end so the
        host oracle and the device op round identically."""
        logits = logits.astype(np.float32).copy()
        for t, b in self.logit_bias.items():
            if 0 <= t < logits.shape[0]:
                logits[t] += b
        if self.counts:
            idx = np.fromiter(self.counts.keys(), dtype=np.int64)
            cnt = np.fromiter(self.counts.values(), dtype=np.float32)
            logits[idx] -= self.frequency_penalty * cnt
            logits[idx] -= self.presence_penalty
            if self.repetition_penalty != 1.0:
                sel = logits[idx]
                logits[idx] = np.where(sel > 0,
                                       sel / self.repetition_penalty,
                                       sel * self.repetition_penalty)
        if grammar_mask is not None:
            if not grammar_mask.any():
                raise RuntimeError("grammar mask excludes every token")
            logits = np.where(grammar_mask, logits, -np.inf)
        return logits

    def dist(self, logits: np.ndarray,
             grammar_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """The final filtered/renormalized distribution a stochastic
        draw is taken from (temperature > 0) — also the oracle the
        device sampler is property-tested against."""
        logits = self.penalized(logits, grammar_mask)
        assert self.temperature > 0.0, "greedy has no distribution"
        logits = logits / self.temperature
        if self.top_k > 0:
            # top_k >= vocab means "disabled" (the device op and ref
            # oracle clamp the same way)
            k = min(self.top_k, logits.shape[0])
            kth = np.partition(logits, -k)[-k]
            logits = np.where(logits >= kth, logits, -np.inf)
        probs = _softmax(logits, fallback_mask=grammar_mask)
        # top-p and min-p both filter on the SAME pre-filter probs, then
        # one renormalization — matching the device op stage order
        keep = None
        if self.top_p < 1.0:
            order = np.argsort(-probs, kind="stable")
            csum = np.cumsum(probs[order])
            cutoff = max(1, int(np.searchsorted(csum, self.top_p) + 1))
            keep = np.zeros_like(probs, dtype=bool)
            keep[order[:cutoff]] = True
        if self.min_p > 0.0:
            mp = probs >= self.min_p * probs.max()
            keep = mp if keep is None else keep & mp
        if self.typical_p < 1.0:
            # locally-typical filter on the SAME pre-filter probs: rank
            # tokens by |surprisal - entropy| ascending and keep until
            # their cumulative mass reaches typical_p (the most-typical
            # token always survives — cutoff is at least 1)
            surp = -np.log(np.where(probs > 0, probs, 1.0))
            ent = np.float32((probs * surp).sum())
            dev = np.where(probs > 0, np.abs(surp - ent), np.inf)
            dorder = np.argsort(dev, kind="stable")
            csum = np.cumsum(probs[dorder])
            cutoff = max(1, int(np.searchsorted(csum, self.typical_p) + 1))
            tk = np.zeros_like(probs, dtype=bool)
            tk[dorder[:cutoff]] = True
            keep = tk if keep is None else keep & tk
        if keep is not None:
            # the max-probability token survives every filter
            # combination: top-p/min-p keep it by construction, but the
            # typical filter may not — forcing it means an intersection
            # of filters can never empty the support (the device op
            # forces the same token)
            keep[int(np.argmax(probs))] = True
            probs = np.where(keep, probs, 0.0)
            probs = probs / probs.sum()
        return probs

    def sample(self, logits: np.ndarray,
               grammar_mask: Optional[np.ndarray] = None) -> int:
        if self.temperature == 0.0:
            return _argmax_allowed(self.penalized(logits, grammar_mask),
                                   grammar_mask)
        probs = self.dist(logits, grammar_mask)
        return int(self.rng.choice(probs.shape[0], p=probs))


def counter_draw(sampler: "RequestSampler", logits: np.ndarray,
                 counter: int,
                 bitmask: Optional[np.ndarray] = None) -> int:
    """One deterministic counter-based draw on the host: the token the
    DEVICE pipeline emits for this row — the sampler's params plus the
    ``fold_in(PRNGKey(seed), counter)`` Gumbel key — via the
    port's batched sampler run on CPU tensors
    (``repro_torch.kernels.sampling.batched_sample``),
    so host and device agree token-for-token, not just in
    distribution.  ``bitmask`` is the packed uint32 grammar mask row
    (``None`` = unconstrained)."""
    from repro_torch.kernels.sampling import batched_sample_np
    logits = np.asarray(logits, np.float32)
    vocab = int(logits.shape[-1])
    batch = SamplingParamsBatch.build([(0, sampler, bitmask)], vocab,
                                      counters=[int(counter)])
    tok, _, _, _ = batched_sample_np(logits[None, :], batch)
    return int(tok[0])


def accept_draft(sampler: "RequestSampler", logits_rows, drafts,
                 bitmasks=None) -> Tuple[List[int], int]:
    """Sequential host acceptance oracle for speculative verification.

    Walk the verify window one position at a time exactly as a
    NON-speculative run would: draw position ``i`` with counter
    ``n_sampled`` (advancing via ``observe``, so in-window penalties see
    earlier emissions), emit the drawn token, and stop after the first
    position whose draw differs from the draft that was fed as the next
    position's input.  ``logits_rows`` has ``k+1`` rows (the window
    input tokens were ``[t0, d1..dk]``); ``drafts`` has ``k`` entries.

    Returns ``(emitted_tokens, n_accepted)`` with ``n_accepted ==
    len(emitted_tokens) - 1``.  This is the ground truth the batched
    device path (``batched_sample`` at counters ``c..c+k`` composed with
    ``kernels.sampling.batched_accept``) must reproduce token-for-token
    — the spec-on ≡ spec-off determinism contract.
    """
    emitted: List[int] = []
    for i, row in enumerate(logits_rows):
        bm = bitmasks[i] if bitmasks is not None else None
        t = counter_draw(sampler, row, sampler.n_sampled, bm)
        sampler.observe(t)
        emitted.append(t)
        if i >= len(drafts) or t != int(drafts[i]):
            break
    return emitted, len(emitted) - 1


def _argmax_allowed(x: np.ndarray,
                    mask: Optional[np.ndarray] = None) -> int:
    """Argmax restricted to grammar-allowed tokens: even when every
    allowed logit is -inf (all-underflow degenerate) the result is an
    allowed token, never a masked one."""
    if mask is None:
        return int(np.argmax(x))
    idx = np.flatnonzero(mask)
    return int(idx[np.argmax(x[idx])])


def _softmax(x: np.ndarray,
             fallback_mask: Optional[np.ndarray] = None) -> np.ndarray:
    m = np.max(x[np.isfinite(x)]) if np.isfinite(x).any() else 0.0
    e = np.exp(np.clip(x - m, -700, 50))
    e[~np.isfinite(x)] = 0.0
    s = e.sum()
    if s <= 0:
        # degenerate (every candidate underflowed): one-hot argmax,
        # restricted to the grammar-allowed set — the unrestricted
        # argmax could land on a masked token when the allowed logits
        # are all -inf
        out = np.zeros_like(e)
        out[_argmax_allowed(x, fallback_mask)] = 1.0
        return out
    return e / s


@dataclass
class SamplingParamsBatch:
    """Struct-of-arrays sampling params for one fused step's ``S``
    sampling rows (built host-side, consumed inside the jitted step).

    ``parent[s]`` indexes the attention row providing row ``s``'s
    logits; ``vocab`` bounds sampling to the tokenizer's vocabulary
    (model vocab may be padded larger).  The dense ``[S, V]``
    bias/count planes are only materialized when some row actually
    carries logit bias or penalties (``use_planes``) — the common case
    ships placeholder ``[S, 1]`` zeros and the device op statically
    skips the stage, so per-step host→device traffic is scalars plus
    mask words, not ``2·S·V`` floats."""
    parent: np.ndarray        # [S] int32 — attention row index
    seeds: np.ndarray         # [S] uint32
    counters: np.ndarray      # [S] int32
    temperature: np.ndarray   # [S] f32
    top_k: np.ndarray         # [S] int32
    top_p: np.ndarray         # [S] f32
    min_p: np.ndarray         # [S] f32 (0 = filter disabled)
    typical_p: np.ndarray     # [S] f32 (1 = filter disabled)
    freq_pen: np.ndarray      # [S] f32
    pres_pen: np.ndarray      # [S] f32
    rep_pen: np.ndarray       # [S] f32
    bias: np.ndarray          # [S, V] f32 ([S, 1] when not use_planes)
    counts: np.ndarray        # [S, V] f32 ([S, 1] when not use_planes/counts)
    mask_bits: np.ndarray     # [S, ceil(V/32)] uint32
    #: [S] int32 — device count-plane row per sampling row (the engine
    #: slot; -1 = no slot, runner maps it to the trash row)
    slot_ids: np.ndarray = None
    vocab: int = 0
    use_planes: bool = True   # static: any bias row in batch
    all_greedy: bool = False  # static: every row temperature == 0
    #: static: some consumer requested logprobs (set by the engine —
    #: the builder only sees samplers); False skips the [S, V]
    #: log-softmax on device
    need_logprobs: bool = True
    #: static: penalties read the DEVICE-RESIDENT count planes (gathered
    #: by ``slot_ids`` and scatter-updated with each sampled token
    #: inside the fused step) instead of a host-uploaded dense plane —
    #: the engine path; the ``counts`` field is then placeholder [S, 1]
    use_counts: bool = False
    #: [S] int32 — slot offset WITHIN the parent attention row this
    #: sampling row draws its logits from.  ``None`` lets the runner
    #: default every row to its parent's last valid slot (the
    #: non-speculative semantics); speculative verify windows set
    #: offsets ``0..k`` across their ``k+1`` rows
    offsets: np.ndarray = None
    #: [S] int32 — the draft token this position proposed as the NEXT
    #: position's input (-1 = nothing to check: ordinary rows and the
    #: window's bonus position).  Consumed by ``batched_accept`` inside
    #: the fused step
    draft_toks: np.ndarray = None
    #: [S] int32 — this row's offset inside its verify window (0 for
    #: the window head and every ordinary width-1 row); window rows are
    #: consecutive
    win_off: np.ndarray = None

    def __len__(self) -> int:
        return int(self.parent.shape[0])

    @classmethod
    def build(cls, specs: List[Tuple[int, object, Optional[np.ndarray]]],
              vocab: int, slot_ids: Optional[List[int]] = None,
              counters: Optional[List[int]] = None
              ) -> "SamplingParamsBatch":
        """Pack ``(parent_row, RequestSampler, packed_bitmask|None)``
        specs into device-ready arrays (all-ones bitmask = row
        unconstrained).

        With ``slot_ids`` (the engine path) rows that carry penalties
        read the device-resident count planes (``use_counts``) and the
        host ``counts`` plane stays placeholder; without it (direct
        callers, tests, the oracle benches) penalties ship the legacy
        dense host plane.  ``counters`` overrides each row's PRNG
        counter — the pipelined engine adds the in-flight token a
        sequence has sampled but not yet observed, keeping seeded runs
        bit-identical to the sequential path."""
        s_count = len(specs)
        words = -(-vocab // 32)
        has_pen = any(
            bool(sampler.frequency_penalty or sampler.presence_penalty
                 or sampler.repetition_penalty != 1.0)
            for _, sampler, _ in specs)
        use_counts = has_pen and slot_ids is not None
        use_planes = any(
            bool(sampler.logit_bias)
            or (not use_counts and bool(sampler.counts)
                and bool(sampler.frequency_penalty
                         or sampler.presence_penalty
                         or sampler.repetition_penalty != 1.0))
            for _, sampler, _ in specs)
        plane_v = vocab if use_planes else 1
        out = cls(
            parent=np.zeros(s_count, np.int32),
            seeds=np.zeros(s_count, np.uint32),
            counters=np.zeros(s_count, np.int32),
            temperature=np.zeros(s_count, np.float32),
            top_k=np.zeros(s_count, np.int32),
            top_p=np.ones(s_count, np.float32),
            min_p=np.zeros(s_count, np.float32),
            typical_p=np.ones(s_count, np.float32),
            freq_pen=np.zeros(s_count, np.float32),
            pres_pen=np.zeros(s_count, np.float32),
            rep_pen=np.ones(s_count, np.float32),
            bias=np.zeros((s_count, plane_v), np.float32),
            counts=np.zeros(
                (s_count, plane_v if not use_counts else 1), np.float32),
            mask_bits=np.full((s_count, words), 0xFFFFFFFF, np.uint32),
            slot_ids=np.full(s_count, -1, np.int32),
            draft_toks=np.full(s_count, -1, np.int32),
            win_off=np.zeros(s_count, np.int32),
            vocab=vocab, use_planes=use_planes, use_counts=use_counts,
            all_greedy=all(sampler.temperature == 0.0
                           for _, sampler, _ in specs))
        if slot_ids is not None:
            out.slot_ids[:] = slot_ids
        for s, (row, sampler, bitmask) in enumerate(specs):
            out.parent[s] = row
            out.seeds[s] = np.uint32(sampler.seed & 0xFFFFFFFF)
            out.counters[s] = (sampler.n_sampled if counters is None
                               else counters[s])
            out.temperature[s] = sampler.temperature
            out.top_k[s] = sampler.top_k
            out.top_p[s] = sampler.top_p
            out.min_p[s] = getattr(sampler, "min_p", 0.0)
            out.typical_p[s] = getattr(sampler, "typical_p", 1.0)
            out.freq_pen[s] = sampler.frequency_penalty
            out.pres_pen[s] = sampler.presence_penalty
            out.rep_pen[s] = sampler.repetition_penalty
            if use_planes:
                for t, b in sampler.logit_bias.items():
                    if 0 <= t < vocab:
                        out.bias[s, t] = b
                if not use_counts:
                    for t, c in sampler.counts.items():
                        if 0 <= t < vocab:
                            out.counts[s, t] = c
            if bitmask is not None:
                out.mask_bits[s, :bitmask.shape[0]] = bitmask
                out.mask_bits[s, bitmask.shape[0]:] = 0
        return out


@dataclass
class SampleResult:
    """Device-sampled step output, one entry per sampling row: token
    ids, raw-distribution logprobs of the sampled tokens, and the
    optional batched top-``K`` logprobs gather."""
    tokens: np.ndarray        # [S] int32
    logprob: np.ndarray       # [S] f32
    top_ids: np.ndarray       # [S, K] int32
    top_lps: np.ndarray       # [S, K] f32
    #: [S] bool — speculative acceptance per row (``batched_accept``):
    #: True iff every earlier row of the row's verify window resampled
    #: exactly its draft, so this row's token is emitted.  All-True for
    #: non-speculative steps
    emit: np.ndarray = None
