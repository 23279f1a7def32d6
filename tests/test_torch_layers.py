"""Layer math of the fused step against ``repro.models`` on the same
numpy-seeded inputs (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)


def _bf16(a: np.ndarray):
    t = torch.from_numpy(a.astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(
        a, jax.Array) else a.float().numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference in units of the reference's bf16 spacing."""
    spacing = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    return float(np.max(np.abs(got - want) / spacing))


@pytest.mark.parametrize("shape", [(3, 5, 256), (1, 7, 64)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(shape, plus_one):
    rng = np.random.default_rng(0)
    tx, jx = _bf16(rng.standard_normal(shape) * 3)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    got = tl.rmsnorm(tx, torch.from_numpy(s), 1e-5, plus_one=plus_one)
    want = jl.rmsnorm(jx, jnp.asarray(s), 1e-5, plus_one=plus_one)
    assert got.dtype == torch.bfloat16
    # f32 statistics in both; the cast to bf16 may round the other way
    # when the f32 values differ in their last bits: at most one ulp
    assert _ulps(_f32(got), _f32(want)) <= 1.0


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 0.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    tx, jx = _bf16(rng.standard_normal((2, 6, 4, 64)))
    pos = rng.integers(0, 4096, (2, 6)).astype(np.int32)
    got = tl.apply_rope(tx, torch.from_numpy(pos), theta)
    want = jl.apply_rope(jx, jnp.asarray(pos), theta)
    np.testing.assert_array_equal(tl.rope_freqs(64, theta or 1.0).numpy(),
                                  np.asarray(jl.rope_freqs(64, theta or 1.0)))
    # f32 rotation; XLA's and torch's cos/sin differ by an ulp or two
    # at large angles, which can flip the final bf16 rounding
    assert _ulps(_f32(got), _f32(want)) <= 1.0


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    D, F = 64, 128
    tx, jx = _bf16(rng.standard_normal((2, 3, D)))
    tp, jp = {}, {}
    names = ("wi", "wg", "wo") if jl.gated(act) else ("wi", "bi", "wo", "bo")
    shapes = {"wi": (D, F), "wg": (D, F), "wo": (F, D), "bi": (F,),
              "bo": (D,)}
    for n in names:
        tp[n], jp[n] = _bf16(rng.standard_normal(shapes[n]) * 0.1)
    got = _f32(tl.mlp(tx, tp, act))
    want = _f32(jl.mlp(jx, jp, act))
    # bf16 matmuls and elementwise ops: each framework rounds the
    # intermediates to bf16 at its own places; a few bf16 ulps of the
    # output scale
    np.testing.assert_allclose(got, want, atol=0.02 * np.abs(want).max())


@pytest.mark.parametrize("which,n_heads", [("q", None), ("k", None),
                                           ("v", None)])
def test_project_and_qk_norm(which, n_heads):
    rng = np.random.default_rng(3)
    H = CFG.n_heads if which == "q" else CFG.n_kv_heads
    tx, jx = _bf16(rng.standard_normal((2, 5, CFG.d_model)))
    tw, jw = _bf16(rng.standard_normal((CFG.d_model, H * CFG.head_dim))
                   * 0.02)
    got = tattn._project(CFG, {"w" + which: tw}, tx, which, H)
    want = jattn._project(JCFG, {"w" + which: jw}, jx, which, H)
    assert tuple(got.shape) == want.shape == (2, 5, H, CFG.head_dim)
    # one bf16 matmul: accumulation order only
    assert _ulps(_f32(got), _f32(want)) <= 1.0
    # qk-norm is the identity for configs without it, and rmsnorm per
    # head with it
    q, k = tattn._qk_norm(CFG, {}, got, got)
    assert q is got and k is got
    import dataclasses
    cfg = dataclasses.replace(CFG, qk_norm=True)
    s = torch.full((CFG.head_dim,), 1.5)
    q, _ = tattn._qk_norm(cfg, {"q_norm": s, "k_norm": s}, got, got)
    jcfg = dataclasses.replace(JCFG, qk_norm=True)
    jq, _ = jattn._qk_norm(jcfg, {"q_norm": jnp.asarray(s.numpy()),
                                  "k_norm": jnp.asarray(s.numpy())},
                           jnp.asarray(_f32(got), jnp.bfloat16),
                           jnp.asarray(_f32(got), jnp.bfloat16))
    assert _ulps(_f32(q), _f32(jq)) <= 1.0
