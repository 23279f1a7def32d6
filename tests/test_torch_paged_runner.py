"""The port's ``PagedModelRunner`` against the JAX package's, with the
same weights (``from_jax_params``) on the same rows: logits within a
stated tolerance, and sampled tokens, ``seq_tokens`` and ``PageManager``
state equal — across prefill, decode, a CoW fork, a speculative-window
lag-k rewind, prefix-cache adoption and device-fed (pipelined) decode."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.paged_runner import PagedModelRunner as JaxRunner
from repro.core.sampler import RequestSampler as JaxSampler
from repro.core.sampler import SamplingParamsBatch as JaxBatch
from repro.models import model as jax_model
from repro.models.pdef import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core.paged_runner import PagedModelRunner
from repro_torch.core.sampler import RequestSampler, SamplingParamsBatch
from repro_torch.weights import from_jax_params

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)
# bf16 logits of a 2-layer model computed by two BLAS libraries: each
# bf16 rounding that flips moves an activation by 2^-8 relative; the
# logits stay within a few bf16 ulps of |logit| <~ 2
LOGIT_ATOL = 3e-2
KW = dict(num_pages=40, page_size=4, max_slots=4, pages_per_seq=16,
          chunk_size=8)


@pytest.fixture(scope="module")
def pair():
    p = jax_init_params(jax_model.params_def(JCFG), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, p)
    return (JaxRunner(JCFG, p, **KW),
            PagedModelRunner(CFG, from_jax_params(CFG, tree), device="cpu",
                             **KW))


def _pm_state(r):
    pm = r.pm
    return (sorted(pm.free_pages), sorted(pm.free_slots),
            {s: (a.slot, list(a.pages), a.length)
             for s, a in pm.seqs.items()},
            dict(pm.ref), pm.n_shared, pm.n_cow_forks)


def _same_state(j, t):
    assert _pm_state(j) == _pm_state(t)
    assert j.seq_tokens == t.seq_tokens


def _logits_step(j, t, rows):
    a = j.run_step(rows)
    b = t.run_step(rows)
    assert sorted(a) == sorted(b)
    for sid in a:
        assert b[sid].dtype == np.float32
        np.testing.assert_allclose(b[sid], a[sid], atol=LOGIT_ATOL)
    _same_state(j, t)
    return a


def _batches(kws, parents=None, window=None):
    """The same sampling rows for both runners; ``window`` = (offsets,
    draft_toks, win_off) of a speculative verify window."""
    parents = parents or list(range(len(kws)))
    V = CFG.vocab_size
    ja = JaxBatch.build([(p, JaxSampler(**kw), None)
                         for p, kw in zip(parents, kws)], V)
    tb = SamplingParamsBatch.build([(p, RequestSampler(**kw), None)
                                    for p, kw in zip(parents, kws)], V)
    if window is not None:
        for b in (ja, tb):
            b.offsets, b.draft_toks, b.win_off = (
                np.asarray(w, np.int32) for w in window)
    return ja, tb


def _sampled_step(j, t, rows, kws, parents=None, window=None, **run_kw):
    ja, tb = _batches(kws, parents, window)
    ra = j.run_step(rows, sampling=ja, n_top=2, **run_kw)
    rb = t.run_step(rows, sampling=tb, n_top=2, **run_kw)
    return ra, rb


def _assert_same_tokens(ra, rb):
    np.testing.assert_array_equal(rb.tokens, ra.tokens)
    np.testing.assert_array_equal(rb.emit, ra.emit)
    np.testing.assert_allclose(rb.logprob, ra.logprob, atol=LOGIT_ATOL)


def test_runner_matches_reference(pair):
    j, t = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, CFG.vocab_size, n).tolist()
               for n in (11, 3, 7)]
    sids = [j.begin_seq(p) for p in prompts]
    assert [t.begin_seq(p) for p in prompts] == sids
    _same_state(j, t)

    # 1. mixed prefill rows (chunks of several lengths), logits path
    lg = _logits_step(j, t, [(s, p[:8], "prefill")
                             for s, p in zip(sids, prompts)])
    lg = _logits_step(j, t, [(sids[0], prompts[0][8:], "prefill")])
    nxt = {sids[0]: int(np.argmax(lg[sids[0]]))}

    # 2. sampled decode step: greedy + seeded stochastic + top-k/top-p
    kws = [dict(temperature=0.0), dict(temperature=0.9, seed=11),
           dict(temperature=1.1, top_k=5, top_p=0.8, seed=3)]
    rows = [(sids[0], [nxt[sids[0]]], "decode"),
            (sids[1], [5], "decode"), (sids[2], [9], "decode")]
    ra, rb = _sampled_step(j, t, rows, kws)
    _assert_same_tokens(ra, rb)
    _same_state(j, t)

    # 3. CoW fork of a sequence with a partial tail page, then decode
    #    both source and fork in one step
    f = j.fork_seq(sids[0])
    assert t.fork_seq(sids[0]) == f
    _same_state(j, t)
    tok = int(ra.tokens[0])
    _logits_step(j, t, [(sids[0], [tok], "decode"),
                        (f, [int(rb.tokens[1])], "decode")])

    # 4. speculative verify window (width 3) then a lag-2 rewind
    ra, rb = _sampled_step(j, t, [(sids[1], [4, 8, 15], "decode")],
                           [dict(temperature=0.0)] * 3, parents=[0, 0, 0],
                           window=([0, 1, 2], [8, 15, -1], [0, 1, 2]))
    _assert_same_tokens(ra, rb)
    j.rewind_tokens(sids[1], 2)
    t.rewind_tokens(sids[1], 2)
    _same_state(j, t)
    _logits_step(j, t, [(sids[1], [16], "decode")])

    # 5. pipelined: step N undrained, step N+1 fed device-to-device
    rows = [(sids[2], [3], "decode"), (f, [7], "decode")]
    kws = [dict(temperature=0.0), dict(temperature=0.7, seed=5)]
    ha, hb = _sampled_step(j, t, rows, kws, materialize=False)
    rows2 = [(sids[2], [0], "decode"), (f, [0], "decode")]
    ja, tb = _batches(kws)
    na = j.run_step(rows2, sampling=ja, materialize=False, prev=ha,
                    decode_srcs={0: 0, 1: 1})
    nb = t.run_step(rows2, sampling=tb, materialize=False, prev=hb,
                    decode_srcs={0: 0, 1: 1})
    _assert_same_tokens(ha.materialize(), hb.materialize())
    _assert_same_tokens(na.materialize(), nb.materialize())
    _same_state(j, t)          # placeholders backfilled identically

    # 6. finish with publish, then a new prompt adopts the cached prefix
    j.free(sids[0], publish=True)
    t.free(sids[0], publish=True)
    _same_state(j, t)
    again = j.seq_tokens[f][:10] + [2, 2]
    s_new = j.begin_seq(again)
    assert t.begin_seq(again) == s_new
    assert j.last_prefill_info == t.last_prefill_info
    assert t.last_prefill_info["prefix_cached_tokens"] > 0
    _same_state(j, t)
    done = t.seq_len(s_new)
    _logits_step(j, t, [(s_new, again[done:], "prefill")])

    st = t.stats()
    assert st["attn_kernel_calls"] == st["ragged_steps"] == \
        j.stats()["ragged_steps"]
    assert st["host_logit_rows"] == j.stats()["host_logit_rows"]
    assert st["sampled_tokens"] == j.stats()["sampled_tokens"]


def test_out_of_pages_before_any_mutation():
    """A step the pool cannot back raises before touching state."""
    from repro_torch.core.paged_cache import OutOfPages
    r = PagedModelRunner(CFG, None, device="cpu", num_pages=3, page_size=4,
                         max_slots=2, pages_per_seq=8, chunk_size=8)
    sid = r.begin_seq([1, 2, 3])
    before = _pm_state(r), dict(r.seq_tokens)
    with pytest.raises(OutOfPages):
        r.run_step([(sid, list(range(3, 20)), "prefill")])
    assert (_pm_state(r), dict(r.seq_tokens)) == before
    assert r.stats()["ragged_steps"] == 0


@pytest.mark.parametrize("quant", [{}, dict(kv_dtype="int8",
                                              weight_quant="w4a16")])
def test_warmup_touches_no_state(quant):
    r = PagedModelRunner(CFG, None, device="cpu", **KW, **quant)
    pools = [p for p in (r.k_pages, r.v_pages, r.k_scales, r.v_scales)
             if p is not None]
    before = [p.clone() for p in pools]
    n = r.warmup(CFG.vocab_size, draft_k=2)
    assert n > 0 and r.stats()["warmup_compiles"] == n
    assert r.stats()["ragged_steps"] == 0
    # only the trash page (values and scales) may have been written
    for p, p0 in zip(pools, before):
        assert torch.equal(p[:, :r.trash_page], p0[:, :r.trash_page])
    assert r.warmup(CFG.vocab_size, draft_k=2) == 0     # all seen
