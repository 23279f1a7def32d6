"""The port on the card: each hand-written CUDA kernel against its
plain PyTorch version, and the runner and engine on the card against
the same code on the CPU.

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


def _ragged_case(B, C, H, Kv, D, pages, psz, pps, seed, dev):
    rng = np.random.default_rng(seed)
    bf = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev).bfloat16()
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
    staging, device-fed decode inputs) emits the same choices as the
    port's engine on the CPU with the same weights, for greedy and
    seeded traffic.  A differing token passes only as a true tie: the
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

    def serve(device, depth, spec):
        eng = MLCEngine()
        eng.load_model("m", cfg, params=params, backend="paged",
                       max_slots=3, max_context=96, page_size=16,
                       prefill_chunk_size=6, pipeline_depth=depth,
                       speculation=spec, draft_k=3, device=device)
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

    ref = serve("cpu", 1, "off")
    for depth, spec in ((1, "off"), (2, "off"), (2, "prompt_lookup")):
        got = serve(cuda, depth, spec)
        for r_ref, r_got in zip(ref, got):
            for (text_ref, lp_ref), (text, lp) in zip(r_ref, r_got):
                if text == text_ref:
                    continue
                i = next(k for k, (a, b) in enumerate(zip(lp, lp_ref))
                         if a[0] != b[0])
                margin = lp_ref[i][1][0] - lp_ref[i][1][1]
                assert margin < 5e-2, (depth, spec, i, text, text_ref)
