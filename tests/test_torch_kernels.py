"""The port's kernels against the JAX package's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version (the CUDA
kernels need a card), so these hold the plain versions against
``repro.kernels.ops`` run in interpret mode on the same numpy-seeded
inputs.  The kernels themselves are held against these plain versions
on the card by ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

# bf16 outputs of f32 math: the repo's kernel tolerance for bf16
# (tests/test_kernels.py) — one bf16 ulp at |x| ~ 8 is 0.06
ATTN_ATOL = 0.06

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
