"""The port's per-kind runner paths (``prefill_seq`` / ``prefill_chunk``
through the chunked-prefill kernel, batched ``decode`` through the
decode kernel) against the JAX package's, with the same weights, on bf16
and on int8 pools, through the scenarios of ``tests/test_paged_runner.py``:
int8 decode, a rewind across a page boundary, a CoW-forked tail, a
published-prefix adopt, preempt and resume.  Logits agree within the
bf16 tolerance; ``PageManager`` state, ``seq_tokens`` and the counters
are equal.

One runner pair per pool type serves every scenario (each on fresh
sequences, freed at its end), so the JAX side compiles its steps once.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.paged_runner import PagedModelRunner as JaxRunner
from repro.models import model as jax_model
from repro.models.pdef import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core.paged_runner import PagedModelRunner
from repro_torch.weights import from_jax_params

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)
# bf16 logits of a 2-layer model computed by two BLAS libraries
# (tests/test_torch_paged_runner.py)
LOGIT_ATOL = 3e-2
KW = dict(num_pages=32, page_size=4, max_slots=2, pages_per_seq=8)


@pytest.fixture(scope="module")
def weights():
    p = jax_init_params(jax_model.params_def(JCFG), jax.random.PRNGKey(0))
    return p, from_jax_params(CFG, jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module", params=["f32", "int8"])
def pair(request, weights):
    kv = request.param
    j = JaxRunner(JCFG, weights[0], kv_dtype=kv, **KW)
    t = PagedModelRunner(CFG, weights[1], kv_dtype=kv, device="cpu", **KW)
    assert t.k_pages.dtype == (torch.int8 if kv == "int8"
                               else torch.bfloat16)
    if kv == "int8":
        assert tuple(t.k_scales.shape[1:]) == (33, 4, CFG.n_kv_heads)
    assert t.page_bytes == j.page_bytes
    return j, t


def _pm_state(r):
    pm = r.pm
    return (sorted(pm.free_pages), sorted(pm.free_slots),
            {s: (a.slot, list(a.pages), a.length)
             for s, a in pm.seqs.items()},
            dict(pm.ref), pm.n_shared, pm.n_cow_forks)


def _same(j, t):
    """Equal page bookkeeping, tokens, counters and step log."""
    assert _pm_state(j) == _pm_state(t)
    assert j.seq_tokens == t.seq_tokens
    keys = ("prefill_chunks", "prefill_tokens", "decode_steps",
            "decode_tokens", "host_logit_rows", "attn_kernel_calls",
            "prefills", "forks", "rewinds")
    sj, st = j.stats(), t.stats()
    assert {k: st[k] for k in keys} == {k: sj[k] for k in keys}
    assert list(t.step_log) == list(j.step_log)


def _close(got, want):
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


def _prefill(j, t, prompt):
    sid = j.prefill_seq(prompt)
    assert t.prefill_seq(prompt) == sid
    _close(t.last_prefill_logits(), j.last_prefill_logits())
    return sid


def _decode(j, t, toks):
    a, b = j.decode(toks), t.decode(toks)
    assert sorted(a) == sorted(b)
    for s in a:
        _close(b[s], a[s])
    return b


def test_decode(pair):
    j, t = pair
    sid = _prefill(j, t, list(range(1, 12)))
    for tok in (20, 21, 22):
        _decode(j, t, {sid: tok})
    _same(j, t)
    j.free(sid)
    t.free(sid)
    _same(j, t)


def test_rewind_across_page_boundary(pair):
    """Rewinding 3 tokens across a page boundary returns the page (with
    its scale rows): replaying the window is bit-identical to the first
    pass."""
    j, t = pair
    sid = _prefill(j, t, list(range(1, 12)))           # 11 tokens, 3 pages
    first = [_decode(j, t, {sid: tok})[sid] for tok in (20, 21, 22)]
    assert len(t.pm.seqs[sid].pages) == 4
    j.rewind_tokens(sid, 3)
    t.rewind_tokens(sid, 3)
    assert len(t.pm.seqs[sid].pages) == 3
    _same(j, t)
    for i, tok in enumerate((20, 21, 22)):
        assert np.array_equal(_decode(j, t, {sid: tok})[sid], first[i]), i
    _same(j, t)
    j.free(sid)
    t.free(sid)


def test_cow_forked_tail(pair):
    """A fork copies the partial tail page (values and scales); source
    and fork diverge and keep matching the reference."""
    j, t = pair
    sid = _prefill(j, t, list(range(1, 11)))           # tail of 2 tokens
    fork = j.fork_seq(sid)
    assert t.fork_seq(sid) == fork
    _same(j, t)
    _decode(j, t, {sid: 30, fork: 40})
    _decode(j, t, {sid: 31})
    _decode(j, t, {fork: 41})
    _same(j, t)
    for s in (sid, fork):
        j.free(s)
        t.free(s)


def test_published_prefix_adopt(pair):
    """Publish, then two adopters of the cached prefix: their streams are
    bit-identical to each other (same bytes, same scales)."""
    j, t = pair
    prompt = list(range(40, 53))                       # 13 tokens
    s1 = _prefill(j, t, prompt)
    j.free(s1, publish=True)
    t.free(s1, publish=True)
    s2 = _prefill(j, t, prompt)
    assert t.last_prefill_info == j.last_prefill_info
    assert t.last_prefill_info["prefix_cached_tokens"] > 0
    s3 = _prefill(j, t, prompt)
    l2 = _decode(j, t, {s2: 60})[s2]
    l3 = _decode(j, t, {s3: 60})[s3]
    assert np.array_equal(l2, l3)
    _same(j, t)
    for s in (s2, s3):
        j.free(s)
        t.free(s)


def test_preempt_resume(pair):
    """Preempt (free without publish), then resume by re-prefilling the
    prompt and the kept tokens: the pool returns to its state before,
    and the resumed stream matches the reference's."""
    j, t = pair
    base = t.pm.stats()
    prompt = list(range(70, 80))
    sid = _prefill(j, t, prompt)
    for tok in (90, 91):
        _decode(j, t, {sid: tok})
    j.free(sid)
    t.free(sid)
    assert t.pm.stats() == base
    rsid = _prefill(j, t, prompt + [90, 91])
    _decode(j, t, {rsid: 94})
    _same(j, t)
    j.free(rsid)
    t.free(rsid)
