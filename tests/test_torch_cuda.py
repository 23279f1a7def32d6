"""The port on the card: each hand-written CUDA kernel (ragged paged
attention over bf16 and int8 pages, its decode and chunked-prefill
entry points, the W4A16 GEMM, RMSNorm) against its plain PyTorch
version, and the runner and engine on the card — bf16, and W4A16 weights
over int8 pages — against the same code on the CPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The module imports neither JAX nor the JAX package,
so it also runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import w4a16_gemm as wg

RAGGED_SHAPES = [
    (4, 8, 8, 2, 64, 16, 16, 4),
    (2, 16, 4, 4, 128, 32, 8, 6),
    (8, 4, 2, 1, 64, 16, 16, 2),
    (4, 8, 16, 4, 128, 24, 16, 4),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _bf(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(dev).bfloat16()


def _quant(kp, vp):
    """int8 pools and their scales, by the runner's own quantizer."""
    from repro_torch.core.paged_runner import PagedModelRunner
    kq, ks = PagedModelRunner._page_quant(kp)
    vq, vs = PagedModelRunner._page_quant(vp)
    return kq, vq, dict(k_scales=ks, v_scales=vs)


def _ragged_case(B, C, H, Kv, D, pages, psz, pps, seed, dev):
    rng = np.random.default_rng(seed)
    bf = lambda shape: _bf(rng, shape, dev)  # noqa: E731
    q, kp, vp = bf((B, C, H, D)), bf((pages, psz, Kv, D)), \
        bf((pages, psz, Kv, D))
    pt = rng.integers(0, pages, (B, pps)).astype(np.int32)
    # row kinds cycle: decode, full chunk, partial chunk, batch pad
    lengths = np.array([(1, C, max(1, C // 2), 0)[b % 4] for b in range(B)])
    starts = rng.integers(0, pps * psz - C + 1, B).astype(np.int32)
    starts[lengths == 0] = 0
    contexts = (starts + lengths).astype(np.int32)
    i32 = [torch.from_numpy(a).to(dev) for a in (pt, contexts, starts)]
    return (q, kp, vp, *i32), lengths


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,Kv,D,pages,psz,pps", RAGGED_SHAPES)
def test_ragged_kernel_matches_plain(cuda, B, C, H, Kv, D, pages, psz,
                                     pps):
    args, lengths = _ragged_case(B, C, H, Kv, D, pages, psz, pps,
                                 seed=B * C, dev=cuda)
    before = pa.launches
    got = pa.paged_ragged_attention(*args).float().cpu().numpy()
    assert pa.launches == before + 1
    want = pa.paged_ragged_attention_plain(*args).float().cpu().numpy()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b], 0.0)
            continue
        # same f32 math, one bf16 rounding: summation order only
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-2)


@pytest.mark.cuda
def test_ragged_kernel_reads_q_by_strides(cuda):
    """q may be a strided view (here every other row of a wider batch):
    the kernel reads it in place, no transpose copy."""
    args, lengths = _ragged_case(4, 8, 8, 2, 128, 16, 16, 4, seed=1,
                                 dev=cuda)
    wide = torch.stack([args[0], torch.zeros_like(args[0])], dim=3)[
        :, :, :, 0]
    assert not wide.is_contiguous() and torch.equal(wide, args[0])
    got = pa.paged_ragged_attention(wide, *args[1:])
    want = pa.paged_ragged_attention(*args)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("rows", [1, 64, 2048])
def test_rmsnorm_kernel_matches_plain(cuda, with_residual, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, 4096), generator=g, device=cuda).bfloat16()
    r = (torch.randn((rows, 4096), generator=g, device=cuda).bfloat16()
         if with_residual else None)
    s = torch.rand(4096, generator=g, device=cuda) + 0.5
    before = rn.launches
    got = rn.rmsnorm(x, s, residual=r).float()
    assert rn.launches == before + 1
    want = rn.rmsnorm_plain(x, s, 1e-5, r).float()
    # rsqrtf and the reduction order may flip the last bf16 rounding
    torch.testing.assert_close(got, want, atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((4, 4096), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        rn.rmsnorm(x, torch.ones(4096, device=cuda))
    q = torch.zeros((1, 1, 8, 96), dtype=torch.bfloat16, device=cuda)
    pages = torch.zeros((2, 16, 2, 96), dtype=torch.bfloat16, device=cuda)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)  # noqa
    with pytest.raises(ValueError, match="D in"):
        pa.paged_ragged_attention(q, pages, pages, i32(1, 1), i32(1),
                                  i32(1))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,Kv,D,pages,psz,pps", RAGGED_SHAPES)
def test_ragged_int8_kernel_matches_plain(cuda, B, C, H, Kv, D, pages, psz,
                                          pps):
    (q, kp, vp, *idx), lengths = _ragged_case(B, C, H, Kv, D, pages, psz,
                                              pps, seed=B + C, dev=cuda)
    kq, vq, sc = _quant(kp, vp)
    before = (pa.launches, pa.launches_int8)
    got = pa.paged_ragged_attention(q, kq, vq, *idx, **sc).float().cpu()
    assert (pa.launches, pa.launches_int8) == (before[0], before[1] + 1)
    want = pa.paged_ragged_attention_plain(q, kq, vq, *idx,
                                           **sc).float().cpu()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b].numpy(), 0.0)
            continue
        # same f32 dequant and math, one bf16 rounding: order only
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(),
                                   atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,H,Kv,D,pages,psz,pps", [
    (2, 8, 2, 64, 16, 16, 4), (3, 4, 4, 128, 32, 8, 6),
    (8, 32, 8, 128, 160, 16, 20), (1, 16, 2, 64, 8, 8, 8)])
def test_decode_kernel_matches_plain(cuda, B, H, Kv, D, pages, psz, pps,
                                     quant):
    rng = np.random.default_rng(B * H + quant)
    q = _bf(rng, (B, H, D), cuda)
    kp, vp = _bf(rng, (pages, psz, Kv, D), cuda), \
        _bf(rng, (pages, psz, Kv, D), cuda)
    sc = {}
    if quant:
        kp, vp, sc = _quant(kp, vp)
    pt = torch.from_numpy(rng.integers(0, pages, (B, pps)).astype(
        np.int32)).to(cuda)
    lens = torch.from_numpy(rng.integers(1, pps * psz + 1, B).astype(
        np.int32)).to(cuda)
    before = (pa.launches, pa.launches_int8, pa.decode_launches)
    got = pa.paged_attention(q, kp, vp, pt, lens, **sc).float().cpu()
    assert (pa.launches, pa.launches_int8, pa.decode_launches) == \
        (before[0], before[1], before[2] + 1)
    want = pa.paged_attention_plain(q, kp, vp, pt, lens, **sc).float().cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("C,H,Kv,D,pages,psz,pps,start", [
    (8, 8, 2, 64, 16, 16, 4, 0), (16, 4, 4, 128, 32, 8, 6, 20),
    (256, 32, 8, 128, 160, 16, 144, 0), (256, 32, 8, 128, 160, 16, 144,
                                         2000)])
def test_prefill_kernel_matches_plain(cuda, C, H, Kv, D, pages, psz, pps,
                                      start, quant):
    rng = np.random.default_rng(C + start + quant)
    q = _bf(rng, (C, H, D), cuda)
    kp, vp = _bf(rng, (pages, psz, Kv, D), cuda), \
        _bf(rng, (pages, psz, Kv, D), cuda)
    sc = {}
    if quant:
        kp, vp, sc = _quant(kp, vp)
    pt = torch.from_numpy(rng.integers(0, pages, pps).astype(
        np.int32)).to(cuda)
    for valid in (C, max(1, C // 2)):
        before = pa.prefill_launches
        got = pa.paged_prefill_attention(q, kp, vp, pt, start + valid,
                                         start, **sc).float().cpu()
        assert pa.prefill_launches == before + 1
        want = pa.paged_prefill_attention_plain(
            q, kp, vp, pt, start + valid, start, **sc).float().cpu()
        np.testing.assert_allclose(got[:valid].numpy(),
                                   want[:valid].numpy(), atol=1e-2)


W4A16_SHAPES = [(256, 256, 64), (256, 256, 16), (512, 256, 32),
                (256, 512, 64), (4096, 1024, 64), (14336, 4096, 64),
                (4096, 14336, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,G", W4A16_SHAPES)
@pytest.mark.parametrize("M", [1, 3, 8, 40, 64, 65, 200])
def test_w4a16_kernel_matches_plain(cuda, M, K, N, G):
    from repro_torch.quant.int4 import quantize_array
    rng = np.random.default_rng(M + K + N + G)
    x = _bf(rng, (M, K), cuda, 0.1)
    qt = quantize_array(_bf(rng, (K, N), cuda, 0.05), G)
    before = wg.launches
    got = wg.w4a16_gemm(x, qt.data, qt.scales, group=G).float()
    assert wg.launches == before + 1
    want = wg.w4a16_gemm_plain(x, qt.data, qt.scales, G).float()
    # the same bf16 weights and f32 sums in another order: the final
    # bf16 rounding may flip (2^-7 relative), plus a floor for outputs
    # that cancel to near zero
    atol = 2.0 ** -9 * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=atol, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_qdot_launches_the_gemm_for_every_qtensor(cuda):
    """On the card every QTensor product is the W4A16 kernel — any
    leading shape, no fallback — and equals the dequant-matmul."""
    from repro_torch.quant.int4 import qdot, quantize_array
    rng = np.random.default_rng(0)
    qt = quantize_array(_bf(rng, (256, 128), cuda, 0.05), 64)
    for lead in ((1, 1), (3, 5), (2, 129)):
        x = _bf(rng, lead + (256,), cuda, 0.1)
        before = wg.launches
        y = qdot(x, qt)
        assert wg.launches == before + 1 and y.shape == lead + (128,)
        want = (x.float() @ qt.dequant().float()).bfloat16()
        torch.testing.assert_close(y.float(), want.float(), atol=1e-3,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
def test_new_wrappers_reject_bad_operands(cuda):
    i8 = lambda *s: torch.zeros(s, dtype=torch.int8, device=cuda)  # noqa
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16, device=cuda)  # noqa
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)  # noqa
    with pytest.raises(TypeError):          # f32 activations
        wg.w4a16_gemm(bf(4, 256).float(), i8(128, 128), bf(4, 128))
    with pytest.raises(ValueError, match="group"):
        wg.w4a16_gemm(bf(4, 256), i8(128, 128), bf(32, 128), group=8)
    with pytest.raises(ValueError, match="K % 64"):
        wg.w4a16_gemm(bf(4, 96), i8(48, 128), bf(3, 128), group=32)
    with pytest.raises(ValueError, match="N % 16"):
        wg.w4a16_gemm(bf(4, 256), i8(128, 24), bf(4, 24))
    with pytest.raises(ValueError, match="shape mismatch"):
        wg.w4a16_gemm(bf(4, 256), i8(128, 128), bf(2, 128))
    q, pages = bf(1, 1, 8, 64), bf(2, 16, 2, 64)
    with pytest.raises(TypeError):          # int8 pages without scales
        pa.paged_ragged_attention(q, i8(2, 16, 2, 64), i8(2, 16, 2, 64),
                                  i32(1, 1), i32(1), i32(1))
    with pytest.raises(TypeError):          # scales over bf16 pages
        pa.paged_ragged_attention(q, pages, pages, i32(1, 1), i32(1),
                                  i32(1), k_scales=bf(2, 16, 2),
                                  v_scales=bf(2, 16, 2))
    with pytest.raises(ValueError, match="k_scales"):
        pa.paged_attention(bf(1, 8, 64), i8(2, 16, 2, 64),
                           i8(2, 16, 2, 64), i32(1, 1), i32(1),
                           k_scales=bf(2, 8, 2), v_scales=bf(2, 8, 2))


@pytest.mark.cuda
def test_quantized_runner_on_card_matches_cpu(cuda):
    """W4A16 weights over int8 pages, same weights on both paths: the
    per-kind calls (``prefill_seq``, then batched ``decode``) and a fused
    ragged step agree within the bf16 tolerance of two BLAS libraries;
    on the card each forward launched 7 GEMMs per layer and the decode
    and prefill kernels once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.paged_runner import PagedModelRunner
    from repro_torch.models.params import init_params
    cfg = get_config("llama-3.1-8b", reduced=True)
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (21, 5)]
    L = cfg.n_layers
    out = {}
    for dev in ("cpu", cuda):
        r = PagedModelRunner(cfg, params, num_pages=32, page_size=16,
                             max_slots=4, pages_per_seq=8, chunk_size=16,
                             kv_dtype="int8", weight_quant="w4a16",
                             device=dev)
        c0 = (wg.launches, pa.prefill_launches, pa.decode_launches,
              pa.launches_int8)
        sids = [r.prefill_seq(p) for p in prompts]          # 2 + 1 chunks
        first = [r.last_prefill_logits()]
        dec = r.decode({s: 7 for s in sids})
        rows = r.run_step([(s, [9], "decode") for s in sids])
        out[str(dev)] = (np.stack(first + [dec[s] for s in sids]
                                  + [rows[s] for s in sids]),
                         (wg.launches - c0[0], pa.prefill_launches - c0[1],
                          pa.decode_launches - c0[2],
                          pa.launches_int8 - c0[3]))
    (lc, nc), (lg, ng) = out["cpu"], out[str(cuda)]
    assert nc == (0, 0, 0, 0)
    assert ng == (7 * L * 5, 3 * L, L, L)
    np.testing.assert_allclose(lg, lc, atol=5e-2)


@pytest.mark.cuda
def test_runner_on_card_matches_cpu(cuda):
    """The same weights on both paths: one ragged logits step agrees
    within the bf16 tolerance of two BLAS libraries, and the card path
    launched one attention kernel per layer and 2L+1 norms."""
    from repro_torch.configs import get_config
    from repro_torch.core.paged_runner import PagedModelRunner
    from repro_torch.models.params import init_params
    cfg = get_config("llama-3.1-8b", reduced=True)
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (21, 5, 9)]
    out = {}
    for dev in ("cpu", cuda):
        r = PagedModelRunner(cfg, params, num_pages=32, page_size=16,
                             max_slots=4, pages_per_seq=8, chunk_size=16,
                             device=dev)
        sids = [r.begin_seq(p) for p in prompts]
        a0, n0 = pa.launches, rn.launches
        logits = r.run_step([(s, p, "prefill")
                             for s, p in zip(sids, prompts)])
        out[str(dev)] = (np.stack([logits[s] for s in sids]),
                         pa.launches - a0, rn.launches - n0)
    (lc, ac, nc), (lg, ag, ng) = out["cpu"], out[str(cuda)]
    assert (ac, nc) == (0, 0)
    assert (ag, ng) == (cfg.n_layers, 2 * cfg.n_layers + 1)
    np.testing.assert_allclose(lg, lc, atol=5e-2)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine(cuda):
    """The port's engine on the card (pipelined, speculative, pinned
    staging, device-fed decode inputs; bf16, and W4A16 weights over int8
    pages) emits the same choices as the port's engine on the CPU with
    the same weights and options, for greedy and seeded traffic.  A differing token passes only as a true tie: the
    CPU run's top-2 log-probability margin there is inside the bf16
    logits tolerance of two BLAS libraries."""
    import threading
    import time
    from repro_torch.configs import get_config
    from repro_torch.core import ChatCompletionRequest, ChatMessage, \
        MLCEngine
    from repro_torch.models.params import init_params
    cfg = get_config("llama-3.1-8b", reduced=True)
    params = init_params(cfg, 0, "cpu")
    specs = [dict(text="one two three four one two three four", seed=0,
                  temperature=0.0, max_tokens=12),
             dict(text="The quick brown fox jumps. " * 4, seed=5,
                  temperature=0.8, max_tokens=10),
             dict(text="tell me a story", seed=9, temperature=1.2,
                  frequency_penalty=0.7, max_tokens=10),
             dict(text="two ways", seed=3, temperature=0.9, n=2,
                  max_tokens=6)]

    def serve(device, depth, spec, **quant):
        eng = MLCEngine()
        eng.load_model("m", cfg, params=params, backend="paged",
                       max_slots=3, max_context=96, page_size=16,
                       prefill_chunk_size=6, pipeline_depth=depth,
                       speculation=spec, draft_k=3, device=device, **quant)
        reqs = [ChatCompletionRequest(
            model="m", messages=[ChatMessage("user", s["text"])],
            logprobs=True, top_logprobs=2,
            **{k: v for k, v in s.items() if k != "text"}) for s in specs]
        out = [None] * len(reqs)

        def go(i):
            out[i] = eng.chat_completions_create(reqs[i])

        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(reqs))]
        for t in ts:
            t.start()
            time.sleep(0.05)
        for t in ts:
            t.join(timeout=300)
        st = eng.stats("m")
        eng.shutdown(wait=True)
        assert all(r is not None for r in out)
        assert st["runner"]["attn_kernel_calls"] == \
            st["engine"]["exec_steps"]
        assert st["runner"]["host_logit_rows"] == 0
        return [[(c.message.content,
                  [(e.token, [t.logprob for t in e.top_logprobs])
                   for e in c.logprobs.content]) for c in r.choices]
                for r in out]

    q = dict(kv_dtype="int8", weight_quant="w4a16")
    refs = {"": serve("cpu", 1, "off"), "q": serve("cpu", 1, "off", **q)}
    for depth, spec, quant in ((1, "off", ""), (2, "off", ""),
                               (2, "prompt_lookup", ""), (1, "off", "q"),
                               (2, "prompt_lookup", "q")):
        ref = refs[quant]
        got = serve(cuda, depth, spec, **(q if quant else {}))
        for r_ref, r_got in zip(ref, got):
            for (text_ref, lp_ref), (text, lp) in zip(r_ref, r_got):
                if text == text_ref:
                    continue
                i = next(k for k, (a, b) in enumerate(zip(lp, lp_ref))
                         if a[0] != b[0])
                margin = lp_ref[i][1][0] - lp_ref[i][1][1]
                assert margin < 5e-2, (depth, spec, i, text, text_ref)
