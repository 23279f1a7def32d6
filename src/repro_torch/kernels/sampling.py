"""Batched on-device sampling as PyTorch device ops.

Port of ``src/repro/kernels/sampling.py`` (jnp there, fused by XLA; no
Pallas kernel).  One call samples a token for every row of ``logits
[S, V]``: logit bias, frequency/presence/repetition penalties, grammar
bitmask, temperature, top-k, top-p, min-p, typical-p, then a Gumbel-max
draw — only ``S`` token ids need to leave the device.

Randomness is counter-based and bit-compatible with the JAX package:
row ``s`` draws ``gumbel(fold_in(PRNGKey(seeds[s]), counters[s]), (V,))``
under threefry2x32 in its partitionable form (the installed jax 0.9.0
defaults), so a seeded request emits the same tokens through either
package — the determinism contract of ``repro.kernels.sampling``.
Torch has no usable uint32 arithmetic, so the hash runs in int64 with
every step masked to 32 bits.

The same sentinels as the reference keep degenerate rows well defined:
grammar-disallowed tokens sit at ``MASKED`` strictly below the
``ALLOWED_FLOOR`` every allowed token is clamped to, and top-k/p
filtered tokens at ``FILTERED``.
"""
from __future__ import annotations

import numpy as np
import torch

MASKED = -1e38
ALLOWED_FLOOR = -1e37
FILTERED = -3e37

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) over int64 tensors holding uint32
    values; ``jax._src.prng._threefry2x32_lowering`` step for step."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def gumbel_uniform(seeds: torch.Tensor, counters: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """``[S, vocab]`` f32 uniforms in ``[tiny, 1)``, row ``s`` bitwise
    equal to JAX's ``uniform(fold_in(PRNGKey(seeds[s]), counters[s]),
    (vocab,), minval=tiny)`` — the draw under :func:`gumbel_noise`.

    ``PRNGKey(seed)`` of a 32-bit seed is the key ``(0, seed)``;
    ``fold_in`` hashes the count pair ``(0, counter)`` under it; the
    partitionable bit stream hashes ``(0, i)`` for element ``i`` and
    xors the two output words; the uniform keeps the top 23 bits as a
    mantissa in [1, 2), minus 1, floored at the smallest normal."""
    seeds = seeds.long() & _M32
    zero = torch.zeros_like(seeds)
    k1, k2 = _threefry2x32(zero, seeds, zero, counters.long() & _M32)
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)[None]
    b1, b2 = _threefry2x32(k1[:, None], k2[:, None],
                           torch.zeros_like(idx), idx)
    bits = b1 ^ b2
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((mant - 1.0) * (1.0 - _F32_TINY) + _F32_TINY,
                           _F32_TINY)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``[S, vocab]`` f32 Gumbel noise ``-log(-log(u))``, row ``s`` the
    JAX draw ``gumbel(fold_in(PRNGKey(seeds[s]), counters[s]),
    (vocab,))``.  The uniforms are bitwise equal; each ``log`` may
    differ from XLA's by one ulp."""
    return -torch.log(-torch.log(gumbel_uniform(seeds, counters, vocab)))


def unpack_bitmask(mask_bits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Unpack ``[S, ceil(V/32)]`` grammar bitmask words (uint32 values,
    held in any integer dtype; bit ``v%32`` of word ``v//32`` = token
    ``v`` allowed) into bool ``[S, V]``."""
    idx = torch.arange(vocab, device=mask_bits.device)
    words = mask_bits.long()[:, idx // 32] & _M32
    return ((words >> (idx % 32)) & 1).bool()


def _penalized(logits, bias, counts, freq_pen, pres_pen, rep_pen,
               mask_bits, use_planes):
    """Bias + penalties + grammar mask, in the host ``RequestSampler``
    pipeline order; ``use_planes=False`` skips the penalty stage."""
    x = logits.float()
    if use_planes:
        x = x + bias
        seen = counts > 0
        x = x - freq_pen[:, None] * counts
        x = torch.where(seen, x - pres_pen[:, None], x)
        rep = rep_pen[:, None]
        x = torch.where(seen, torch.where(x > 0, x / rep, x * rep), x)
    allowed = unpack_bitmask(mask_bits, logits.shape[-1])
    return torch.where(allowed, torch.clamp_min(x, ALLOWED_FLOOR),
                       torch.full_like(x, MASKED))


def batched_accept(tokens, drafts, win_off):
    """Speculative acceptance over one step's sampling rows: ``emit[s]``
    is True iff every earlier row of row ``s``'s verify window resampled
    exactly its draft (``drafts == -1``: nothing to check)."""
    miss = ((drafts >= 0) & (tokens != drafts)).to(torch.int32)
    c = torch.cat([torch.zeros(1, dtype=torch.int32, device=tokens.device),
                   torch.cumsum(miss, 0).to(torch.int32)])
    idx = torch.arange(tokens.shape[0], device=tokens.device)
    before = c[idx] - c[idx - win_off.long()]
    return before == 0


def _unsort(sorted_vals, order):
    """Inverse of ``take_along_dim(vals, order)`` for a permutation."""
    return torch.empty_like(sorted_vals).scatter_(1, order, sorted_vals)


def batched_sample(logits, seeds, counters, temperature, top_k, top_p,
                   min_p, typical_p, freq_pen, pres_pen, rep_pen, bias,
                   counts, mask_bits, *, n_top: int = 0,
                   use_planes: bool = True, all_greedy: bool = False,
                   need_logprobs: bool = True):
    """Sample one token per row of ``logits [S, V]`` on its device.

    Per-row params are ``[S]`` tensors (``seeds`` hold uint32 values in
    any integer dtype); ``bias``/``counts`` are ``[S, V]`` f32 (or
    ``[S, 1]`` placeholders when ``use_planes`` is False); ``mask_bits``
    is ``[S, ceil(V/32)]``.  ``use_planes``, ``all_greedy`` and
    ``need_logprobs`` are batch-level switches that skip whole stages,
    as in the reference.  Returns ``(token [S] int32, logprob [S] f32,
    top_ids [S, n_top] int32, top_lps [S, n_top] f32)``."""
    S, V = logits.shape
    assert n_top <= V, (n_top, V)
    dev = logits.device
    x = _penalized(logits, bias, counts, freq_pen, pres_pen, rep_pen,
                   mask_bits, use_planes)
    greedy = torch.argmax(x, dim=-1)

    if all_greedy:
        token = greedy.to(torch.int32)
    else:
        t = torch.where(temperature > 0, temperature,
                        torch.ones_like(temperature))
        z = x / t[:, None]
        srt = torch.sort(z, dim=-1, descending=True).values
        kth = torch.gather(srt, 1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
        z = torch.where((top_k > 0)[:, None] & (z < kth),
                        torch.full_like(z, FILTERED), z)

        # top-p keep rule = numpy searchsorted-left + 1: token j (prob-
        # descending) survives iff the mass BEFORE it is < p
        m = torch.amax(z, dim=-1, keepdim=True)
        e = torch.exp(z - m)
        p = e / torch.sum(e, dim=-1, keepdim=True)
        order = torch.argsort(-p, dim=-1, stable=True)
        sp = torch.gather(p, 1, order)
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p[:, None]
        keep_sorted = keep_sorted | (top_p >= 1.0)[:, None]
        keep_sorted = keep_sorted & (
            (sp >= min_p[:, None] * sp[:, :1]) | (min_p <= 0.0)[:, None])
        keep = _unsort(keep_sorted, order)

        # typical-p on the same pre-filter probs, in deviation order;
        # the most typical token always survives its own filter
        surp = -torch.log(torch.where(p > 0, p, torch.ones_like(p)))
        ent = torch.sum(p * surp, dim=-1, keepdim=True)
        dev_ = torch.where(p > 0, torch.abs(surp - ent),
                           torch.full_like(p, float("inf")))
        dorder = torch.argsort(dev_, dim=-1, stable=True)
        dp = torch.gather(p, 1, dorder)
        tkeep_sorted = (((torch.cumsum(dp, dim=-1) - dp) < typical_p[:, None])
                        | (typical_p >= 1.0)[:, None])
        tkeep_sorted[:, 0] = True
        keep = keep & _unsort(tkeep_sorted, dorder)

        # a degenerate filter combination degrades to top-1
        top1 = torch.argmax(p, dim=-1)
        keep[torch.arange(S, device=dev), top1] = True
        z = torch.where(keep, z, torch.full_like(z, FILTERED))

        g = gumbel_noise(seeds, counters, V)
        stoch = torch.argmax(z + g, dim=-1)
        token = torch.where(temperature == 0.0, greedy,
                            stoch).to(torch.int32)

    if need_logprobs or n_top > 0:
        ls = torch.log_softmax(logits.float(), dim=-1)
        lp = torch.gather(ls, 1, token.long()[:, None])[:, 0]
    else:
        lp = torch.zeros(S, dtype=torch.float32, device=dev)
    if n_top > 0:
        # a stable descending sort breaks ties toward the lower id, as
        # jax.lax.top_k does (torch.topk leaves tie order unspecified)
        srt = torch.sort(ls, dim=-1, descending=True, stable=True)
        top_lps = srt.values[:, :n_top]
        top_ids = srt.indices[:, :n_top].to(torch.int32)
    else:
        top_ids = torch.zeros((S, 0), dtype=torch.int32, device=dev)
        top_lps = torch.zeros((S, 0), dtype=torch.float32, device=dev)
    return token, lp, top_ids, top_lps


def batched_sample_np(logits: np.ndarray, batch, n_top: int = 0):
    """Host convenience: run :func:`batched_sample` on CPU tensors from a
    ``SamplingParamsBatch`` (the ``core.sampler.counter_draw`` oracle)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = batched_sample(
        t(np.asarray(logits, np.float32)), t(batch.seeds.astype(np.int64)),
        t(batch.counters), t(batch.temperature), t(batch.top_k),
        t(batch.top_p), t(batch.min_p), t(batch.typical_p),
        t(batch.freq_pen), t(batch.pres_pen), t(batch.rep_pen),
        t(batch.bias), t(batch.counts), t(batch.mask_bits.astype(np.int64)),
        n_top=n_top, use_planes=batch.use_planes,
        all_greedy=batch.all_greedy)
    return tuple(o.numpy() for o in out)
