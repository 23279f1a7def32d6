"""The port's device sampler against ``repro.kernels.ops``: the Gumbel
draw bit for bit, and ``batched_sample`` / ``batched_accept`` token for
token over a fixed grid of sampling settings (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampler import RequestSampler, SamplingParamsBatch
from repro.grammar.matcher import pack_token_bitmask
from repro.kernels import ops
from repro_torch.kernels import sampling as ts

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

V = 48
S = 8


def _jax_uniform_and_noise(seeds, counters, vocab):
    tiny = np.finfo(np.float32).tiny

    def one(seed, counter):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), counter)
        return (jax.random.uniform(key, (vocab,), jnp.float32,
                                   minval=tiny, maxval=1.0),
                jax.random.gumbel(key, (vocab,), jnp.float32))

    u, g = jax.jit(jax.vmap(one))(jnp.asarray(seeds), jnp.asarray(counters))
    return np.asarray(u), np.asarray(g)


def test_gumbel_draw_matches_jax():
    """threefry2x32 / fold_in / partitionable bits / uniform: bitwise.
    The noise ``-log(-log(u))`` of the same uniforms: each ``log`` of
    XLA and of torch may differ by one ulp, which the outer log turns
    into at most ~5e-7 absolute near g = 0 (a relative error of one ulp
    of the inner value)."""
    seeds = np.array([0, 1, 7, 12345, 2**31 - 1, 0xFFFFFFFF], np.uint32)
    counters = np.array([0, 1, 3, 99, 123456, 2**31 - 1], np.int32)
    u_ref, g_ref = _jax_uniform_and_noise(seeds, counters, 1000)
    u = ts.gumbel_uniform(torch.from_numpy(seeds.astype(np.int64)),
                          torch.from_numpy(counters), 1000).numpy()
    np.testing.assert_array_equal(u.view(np.int32), u_ref.view(np.int32))
    g = ts.gumbel_noise(torch.from_numpy(seeds.view(np.int32)),
                        torch.from_numpy(counters), 1000).numpy()
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=2e-6)
    assert np.mean(g == g_ref) > 0.5


def _sampler(rng, temperature):
    s = RequestSampler(
        temperature=temperature,
        top_k=int(rng.choice([0, 1, 5, V])),
        top_p=float(rng.choice([1.0, 0.9, 0.3])),
        min_p=float(rng.choice([0.0, 0.1])),
        typical_p=float(rng.choice([1.0, 0.6])),
        frequency_penalty=float(rng.choice([0.0, 0.8])),
        presence_penalty=float(rng.choice([0.0, 0.5])),
        repetition_penalty=float(rng.choice([1.0, 1.3])),
        logit_bias=({int(rng.integers(0, V)): float(rng.uniform(-5, 5))}
                    if rng.random() < 0.4 else None),
        seed=int(rng.integers(0, 2**32 - 1)))
    for _ in range(int(rng.integers(0, 5))):
        s.observe(int(rng.integers(0, V)))
    return s


def _mask(rng):
    if rng.random() < 0.6:
        return None
    allowed = rng.random(V) < 0.4
    allowed[int(rng.integers(0, V))] = True
    return pack_token_bitmask(allowed)


# greedy, temperature, top-k, top-p, min-p, typical-p, penalties and
# bitmask: 12 seeded batches of S mixed rows (plus the all-greedy and
# no-planes stage skips)
GRID = list(range(12))


def _batch(grid_seed):
    rng = np.random.default_rng(grid_seed)
    specs = []
    for s in range(S):
        temp = float(rng.choice([0.0, 0.7, 1.0, 1.5]))
        if grid_seed == 0:
            temp = 0.0                       # all-greedy stage skip
        specs.append((s, _sampler(rng, temp), _mask(rng)))
    batch = SamplingParamsBatch.build(specs, V)
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    # bf16-representable rows, as the fused step feeds them
    logits = torch.from_numpy(logits).bfloat16().float().numpy()
    batch.counters = rng.integers(0, 50, S).astype(np.int32)
    return batch, logits


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("grid_seed", GRID)
@pytest.mark.parametrize("n_top", [0, 3])
def test_batched_sample_matches_jax(grid_seed, n_top):
    batch, logits = _batch(grid_seed)
    want = ops.batched_sample(
        logits, batch.seeds, batch.counters, batch.temperature,
        batch.top_k, batch.top_p, batch.min_p, batch.typical_p,
        batch.freq_pen, batch.pres_pen, batch.rep_pen, batch.bias,
        batch.counts, batch.mask_bits, n_top=n_top,
        use_planes=batch.use_planes, all_greedy=batch.all_greedy)
    got = ts.batched_sample(
        _t(logits), _t(batch.seeds.view(np.int32)), _t(batch.counters),
        _t(batch.temperature), _t(batch.top_k), _t(batch.top_p),
        _t(batch.min_p), _t(batch.typical_p), _t(batch.freq_pen),
        _t(batch.pres_pen), _t(batch.rep_pen), _t(batch.bias),
        _t(batch.counts), _t(batch.mask_bits.view(np.int32)), n_top=n_top,
        use_planes=batch.use_planes, all_greedy=batch.all_greedy)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    # logprobs: the same f32 log-softmax up to summation order
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    assert tuple(got[2].shape) == (S, n_top)
    if n_top:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_counter_draw_oracle_uses_the_port():
    """``core.sampler.counter_draw`` (the host oracle) runs the port's
    sampler and agrees with the JAX package's oracle."""
    from repro.core.sampler import counter_draw as jax_draw
    from repro_torch.core.sampler import RequestSampler as TSampler
    from repro_torch.core.sampler import counter_draw
    rng = np.random.default_rng(5)
    for _ in range(6):
        logits = rng.standard_normal(V).astype(np.float32)
        kw = dict(temperature=0.9, top_p=0.8, seed=int(rng.integers(1e6)))
        c = int(rng.integers(0, 40))
        assert counter_draw(TSampler(**kw), logits, c) == \
            jax_draw(RequestSampler(**kw), logits, c)


def _windows(rng, n):
    tokens = rng.integers(0, 5, n).astype(np.int32)
    drafts = np.full(n, -1, np.int32)
    win = np.zeros(n, np.int32)
    i = 0
    while i < n:
        w = int(rng.integers(1, 5))
        w = min(w, n - i)
        win[i:i + w] = np.arange(w)
        for j in range(w - 1):
            drafts[i + j] = (tokens[i + j] if rng.random() < 0.7
                             else rng.integers(0, 5))
        i += w
    return tokens, drafts, win


@pytest.mark.parametrize("seed", range(6))
def test_batched_accept_matches_jax(seed):
    tokens, drafts, win = _windows(np.random.default_rng(seed), 16)
    want = np.asarray(ops.batched_accept(jnp.asarray(tokens),
                                         jnp.asarray(drafts),
                                         jnp.asarray(win)))
    got = ts.batched_accept(_t(tokens), _t(drafts), _t(win)).numpy()
    np.testing.assert_array_equal(got, want)


def test_unpack_bitmask_matches_jax():
    from repro.kernels.sampling import unpack_bitmask
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, (3, 4), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(unpack_bitmask(jnp.asarray(words), 100))
    got = ts.unpack_bitmask(_t(words.view(np.int32)), 100).numpy()
    np.testing.assert_array_equal(got, want)
