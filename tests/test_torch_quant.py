"""The port's int4 weight quantization and int8 KV page quantization
against the JAX package's, and the W4A16 GEMM's plain version against
the Pallas kernel (interpret mode), on numpy-seeded inputs (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.paged_runner import PagedModelRunner as JaxRunner
from repro.kernels import ops
from repro.models import model as jax_model
from repro.models.pdef import init_params as jax_init_params
from repro.quant import int4 as jint4
from repro_torch.configs import get_config
from repro_torch.core.paged_runner import PagedModelRunner
from repro_torch.kernels import w4a16_gemm as wg
from repro_torch.models.params import params_def
from repro_torch.quant import int4 as tint4
from repro_torch.weights import from_jax_params, to_tensor

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a numpy/JAX array, for bitwise
    comparison (bf16 through an int16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else \
        a.view(np.uint8)


def _bf16(a: np.ndarray):
    """The same bf16 values for both frameworks."""
    t = torch.from_numpy(a.astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("K,N,G", [(256, 128, 64), (512, 96, 32),
                                   (128, 64, 16), (1024, 32, 128)])
def test_quantize_array_bitwise(K, N, G):
    """Packed bytes, scales and the dequantized weight equal JAX's bit
    for bit, including values that round half-way and all-zero groups."""
    rng = np.random.default_rng(K + N + G)
    w = rng.standard_normal((K, N)) * 0.05
    w[:G, :4] = 0.0                            # amax 0 -> scale floor
    w[G:2 * G, 4] = np.arange(G) * 0.5 - 3.0   # exact .5 multiples
    tw, jw = _bf16(w)
    jq = jint4.quantize_array(jw, G)
    tq = tint4.quantize_array(tw, G)
    assert tq.data.dtype == torch.int8 and tq.scales.dtype == torch.bfloat16
    assert tq.shape == (K, N) and tq.group == G
    np.testing.assert_array_equal(_bits(tq.data), _bits(jq.data))
    np.testing.assert_array_equal(_bits(tq.scales), _bits(jq.scales))
    np.testing.assert_array_equal(_bits(tq.dequant()), _bits(jq.dequant()))


def test_quantize_tree_matches_reference_groups():
    """The same weights quantize to the same leaves: the reference's
    stacked tree, unstacked per layer, equals the port's per-layer tree
    bit for bit — with groups 64 (wq/wk/wv/wi/wg), 16 (attn.wo, a
    sharded 256-wide contraction) and 32 (ffn.wo) at reduced size; embed,
    lm_head and the norms stay as they are."""
    p = jax_init_params(jax_model.params_def(JCFG), jax.random.PRNGKey(0))
    jq = jint4.quantize_tree(p, jax_model.params_def(JCFG))
    port = tint4.quantize_tree(
        from_jax_params(CFG, jax.tree.map(np.asarray, p)), params_def(CFG))
    assert not tint4.is_qtensor(port["embed"])
    assert not tint4.is_qtensor(port["lm_head"])
    groups = {}
    blocks = jq["decoder"]["blocks"]
    assert len(blocks) == 1 and CFG.n_layers == 2
    for li, layer in enumerate(port["layers"]):
        assert not tint4.is_qtensor(layer["mixer_norm"])
        for part in ("attn", "ffn"):
            for name, tq in layer[part].items():
                ref = blocks[0][part][name]
                assert tint4.is_qtensor(tq) and tq.group == ref.group
                groups[f"{part}.{name}"] = tq.group
                np.testing.assert_array_equal(_bits(tq.data),
                                              _bits(ref.data[li]))
                np.testing.assert_array_equal(_bits(tq.scales),
                                              _bits(ref.scales[li]))
    assert groups == {"attn.wq": 64, "attn.wk": 64, "attn.wv": 64,
                      "attn.wo": 16, "ffn.wi": 64, "ffn.wg": 64,
                      "ffn.wo": 32}


def test_full_width_groups_match_reference():
    """At Llama-3.1-8B's full widths every projection takes group 64,
    exactly as the reference chooses."""
    full_t = params_def(get_config("llama-3.1-8b"))["layers"][0]
    full_j = jax_model.params_def(jax_get_config("llama-3.1-8b"))
    blk = full_j["decoder"]["blocks"][0]
    for part in ("attn", "ffn"):
        for name, d in full_t[part].items():
            assert tint4.should_quantize(d) == \
                jint4.should_quantize(blk[part][name]) == 64, (part, name)


@pytest.mark.parametrize("shape", [(5, 3, 4, 64), (2, 7, 8, 128)])
def test_page_quant_bitwise(shape):
    """``_page_quant`` (int8 values and bf16 scales) equals the
    reference's bit for bit, zero rows included."""
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape) * 3
    x[0, 0] = 0.0
    tx, jx = _bf16(x)
    jv, js = JaxRunner._page_quant(jx)
    tv, ts = PagedModelRunner._page_quant(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("M,K,N,G", [
    (128, 256, 128, 64),
    (256, 512, 256, 64),
    (128, 128, 384, 32),
    (64, 1024, 128, 128),
    (1, 256, 128, 64),
    (3, 512, 256, 16),
    (40, 128, 384, 32),
])
def test_w4a16_plain_matches_pallas(M, K, N, G):
    """``w4a16_gemm_plain`` against ``ops.w4a16_gemm`` (interpret mode)
    at ``tests/test_kernels.py``'s shapes plus odd M, with that file's
    tolerance (2 % of the output's largest magnitude)."""
    rng = np.random.default_rng(M * 7 + K + N)
    tx, jx = _bf16(rng.standard_normal((M, K)) * 0.1)
    _, jw = _bf16(rng.standard_normal((K, N)) * 0.05)
    jq = jint4.quantize_array(jw, G)
    want = np.asarray(ops.w4a16_gemm(jx, jq.data, jq.scales, group=G,
                                     interpret=True), np.float32)
    data = to_tensor(np.asarray(jq.data))
    scales = to_tensor(np.asarray(jq.scales))
    before = wg.launches
    got = wg.w4a16_gemm(tx, data, scales, group=G)
    assert wg.launches == before      # CPU tensors take the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=0.02)


def test_qdot_matches_reference():
    """``qdot`` is ``x @ w`` for a tensor and the W4A16 product over every
    leading dim for a QTensor: against JAX's ``qdot`` (the dequant-matmul
    on a CPU) within one bf16 ulp of the output."""
    rng = np.random.default_rng(3)
    tx, jx = _bf16(rng.standard_normal((2, 3, 256)) * 0.1)
    tw, jw = _bf16(rng.standard_normal((256, 128)) * 0.05)
    assert torch.equal(tint4.qdot(tx, tw), tx @ tw)
    got = tint4.qdot(tx, tint4.quantize_array(tw, 64))
    want = np.asarray(jint4.qdot(jx, jint4.quantize_array(jw, 64)),
                      np.float32)
    assert got.shape == (2, 3, 128) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -8, rtol=2.0 ** -7)
