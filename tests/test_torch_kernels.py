"""The port's paged attention (ragged, decode and chunked prefill, each
over bf16 and int8 pages) and RMSNorm against the JAX package's Pallas
kernels.

On the CPU every wrapper takes its plain PyTorch version (the CUDA
kernels need a card), so these hold the plain versions against
``repro.kernels.ops`` run in interpret mode on the same numpy-seeded
inputs.  The kernels themselves are held against these plain versions
on the card by ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.core.paged_runner import PagedModelRunner
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

# bf16 outputs of f32 math: the repo's kernel tolerance for bf16
# (tests/test_kernels.py) — one bf16 ulp at |x| ~ 8 is 0.06
ATTN_ATOL = 0.06
# int8 pools against the dense (unquantized) oracle (tests/test_kernels.py)
DENSE_ATOL = 0.12

RAGGED_SHAPES = [
    (4, 8, 8, 2, 64, 16, 16, 4),
    (2, 16, 4, 4, 128, 32, 8, 6),
    (8, 4, 2, 1, 64, 16, 16, 2),
    (4, 8, 16, 4, 128, 24, 16, 4),      # G = 4, D = 128 (Llama-3.1-8B)
]


def _bf16(a: np.ndarray):
    """The same bf16 values for both frameworks."""
    t = torch.from_numpy(a.astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _quantized(tk, tv):
    """int8 pools and bf16 scales from the port's ``_page_quant`` (bitwise
    the reference's): ``(k, v, port scale kwargs, jax k, jax v, jax scale
    kwargs)``."""
    kq, ks = PagedModelRunner._page_quant(tk)
    vq, vs = PagedModelRunner._page_quant(tv)
    jsc = dict(k_scales=jnp.asarray(ks.float().numpy(), jnp.bfloat16),
               v_scales=jnp.asarray(vs.float().numpy(), jnp.bfloat16))
    return (kq, vq, dict(k_scales=ks, v_scales=vs),
            jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jsc)


def _pools(rng, pages, psz, Kv, D, quant):
    """bf16 pools (both frameworks) and, with ``quant``, their int8 form:
    ``(port operands, jax operands, dense jax pools)``."""
    (tk, jk), (tv, jv) = (_bf16(rng.standard_normal((pages, psz, Kv, D)))
                          for _ in range(2))
    if not quant:
        return (tk, tv, {}), (jk, jv, {}), (jk, jv)
    kq, vq, tsc, jkq, jvq, jsc = _quantized(tk, tv)
    return (kq, vq, tsc), (jkq, jvq, jsc), (jk, jv)


def _ragged_case(B, C, H, Kv, D, pages, psz, pps, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, D))
    kp = rng.standard_normal((pages, psz, Kv, D))
    vp = rng.standard_normal((pages, psz, Kv, D))
    pt = rng.integers(0, pages, (B, pps)).astype(np.int32)
    # row kinds cycle: decode, full chunk, partial chunk, batch pad
    lengths = np.array([(1, C, max(1, C // 2), 0)[b % 4] for b in range(B)])
    starts = rng.integers(0, pps * psz - C + 1, B).astype(np.int32)
    starts[lengths == 0] = 0
    contexts = (starts + lengths).astype(np.int32)
    return q, kp, vp, pt, contexts, starts, lengths


@pytest.mark.parametrize("B,C,H,Kv,D,pages,psz,pps", RAGGED_SHAPES)
def test_ragged_plain_matches_pallas(B, C, H, Kv, D, pages, psz, pps):
    q, kp, vp, pt, ctx, st, lengths = _ragged_case(B, C, H, Kv, D, pages,
                                                   psz, pps, seed=B + C)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(kp), _bf16(vp)
    want = np.asarray(ops.paged_ragged_attention(
        jq, jk, jv, jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(st),
        interpret=True), np.float32)
    before = pa.launches
    got = pa.paged_ragged_attention(
        tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(ctx),
        torch.from_numpy(st))
    assert pa.launches == before      # CPU tensors take the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (B, C, H, D)
    got = got.float().numpy()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b], 0.0)    # pad row
            continue
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATTN_ATOL)


@pytest.mark.parametrize("B,C,H,Kv,D,pages,psz,pps", RAGGED_SHAPES[:3])
def test_ragged_int8_plain_matches_pallas(B, C, H, Kv, D, pages, psz, pps):
    """The serving kernel's int8 form: the same mixed batch over pools
    quantized by the port's ``_page_quant`` (bitwise the reference's),
    against the quantized Pallas kernel and the dense oracle on the
    original pools."""
    q, kp, vp, pt, ctx, st, lengths = _ragged_case(B, C, H, Kv, D, pages,
                                                   psz, pps, seed=B * C)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(kp), _bf16(vp)
    kq, vq, tsc, jkq, jvq, jsc = _quantized(tk, tv)
    jargs = (jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(st))
    want = np.asarray(ops.paged_ragged_attention(
        jq, jkq, jvq, *jargs, interpret=True, **jsc), np.float32)
    dense = np.asarray(ref.paged_ragged_attention_ref(jq, jk, jv, *jargs),
                       np.float32)
    before = (pa.launches, pa.launches_int8)
    got = pa.paged_ragged_attention(
        tq, kq, vq, torch.from_numpy(pt), torch.from_numpy(ctx),
        torch.from_numpy(st), **tsc)
    assert (pa.launches, pa.launches_int8) == before
    got = got.float().numpy()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b], 0.0)    # pad row
            continue
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATTN_ATOL)
        np.testing.assert_allclose(got[b, :n], dense[b, :n],
                                   atol=DENSE_ATOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,H,Kv,D,pages,psz,pps", [
    (2, 8, 2, 64, 16, 16, 4),
    (3, 4, 4, 128, 32, 8, 6),
    (1, 16, 2, 64, 64, 32, 8),
    (4, 2, 1, 128, 8, 16, 2),
])
def test_decode_plain_matches_pallas(B, H, Kv, D, pages, psz, pps, quant):
    rng = np.random.default_rng(B * 10 + H + quant)
    tq, jq = _bf16(rng.standard_normal((B, H, D)))
    (tk, tv, tsc), (jk, jv, jsc), dense = _pools(rng, pages, psz, Kv, D,
                                                 quant)
    pt = rng.integers(0, pages, (B, pps)).astype(np.int32)
    lens = rng.integers(1, pps * psz + 1, B).astype(np.int32)
    want = np.asarray(ops.paged_attention(
        jq, jk, jv, jnp.asarray(pt), jnp.asarray(lens), interpret=True,
        **jsc), np.float32)
    before = pa.decode_launches
    got = pa.paged_attention(tq, tk, tv, torch.from_numpy(pt),
                             torch.from_numpy(lens), **tsc)
    assert pa.decode_launches == before    # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)
    if quant:
        oracle = np.asarray(ref.paged_attention_ref(
            jq, *dense, jnp.asarray(pt), jnp.asarray(lens)), np.float32)
        np.testing.assert_allclose(got, oracle, atol=DENSE_ATOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("start_frac", [0.0, 0.5])
@pytest.mark.parametrize("C,H,Kv,D,pages,psz,pps", [
    (8, 8, 2, 64, 16, 16, 4),
    (16, 4, 4, 128, 32, 8, 6),
    (4, 2, 1, 64, 8, 16, 2),
])
def test_prefill_plain_matches_pallas(C, H, Kv, D, pages, psz, pps,
                                      start_frac, quant):
    """A full chunk and a padded final chunk (only its valid rows are
    compared), at the start of a sequence and mid-sequence."""
    rng = np.random.default_rng(C + H + int(start_frac * 10) + quant)
    tq, jq = _bf16(rng.standard_normal((C, H, D)))
    (tk, tv, tsc), (jk, jv, jsc), dense = _pools(rng, pages, psz, Kv, D,
                                                 quant)
    pt = rng.integers(0, pages, pps).astype(np.int32)
    start = int(start_frac * (pps * psz - C))
    for valid in (C, max(1, C // 2)):
        ctx = start + valid
        want = np.asarray(ops.paged_prefill_attention(
            jq, jk, jv, jnp.asarray(pt), ctx, start, interpret=True,
            **jsc), np.float32)
        before = pa.prefill_launches
        got = pa.paged_prefill_attention(tq, tk, tv, torch.from_numpy(pt),
                                         ctx, start, **tsc)
        assert pa.prefill_launches == before
        assert got.dtype == torch.bfloat16 and got.shape == (C, H, D)
        got = got.float().numpy()[:valid]
        np.testing.assert_allclose(got, want[:valid], atol=ATTN_ATOL)
        if quant:
            oracle = np.asarray(ref.paged_prefill_attention_ref(
                jq, *dense, jnp.asarray(pt), ctx, start), np.float32)
            np.testing.assert_allclose(got, oracle[:valid],
                                       atol=DENSE_ATOL)


@pytest.mark.parametrize("shape", [(4, 64, 512), (2, 128, 256), (1, 8, 896)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_plain_matches_pallas(shape, with_residual):
    rng = np.random.default_rng(len(shape) + shape[-1])
    tx, jx = _bf16(rng.standard_normal(shape))
    s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    tr, jr = (_bf16(rng.standard_normal(shape)) if with_residual
              else (None, None))
    want = np.asarray(ops.rmsnorm(jx, jnp.asarray(s), residual=jr,
                                  interpret=True), np.float32)
    got = rn.rmsnorm(tx, torch.from_numpy(s), residual=tr)
    assert got.dtype == torch.bfloat16
    # bf16 output: one ulp of the output (the repo's rmsnorm tolerance)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05,
                               rtol=0.02)


def test_wrappers_refuse_unknown_devices():
    x = torch.zeros((2, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rn.rmsnorm(x, torch.ones(8, device="meta"))
