"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --verbose-build   # also print nvcc -Xptxas -v

Phases, each printed on its own line; any failure exits non-zero before
the result lines:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (Llama-3.1-8B: H=32, Kv=8, D=128, page 16):
   ragged paged attention over bf16 and int8 pages, its decode and
   chunked-prefill entry points (both page types), the W4A16 GEMM at
   M=8 and M=2048, RMSNorm at D=4096 — with times beside the card's
   bound and a library yardstick;
4. the card path against the CPU path at reduced depth, same weights,
   bf16 and W4A16 weights over int8 pages;
5. the serving path at full Llama-3.1-8B width (random weights): 8
   concurrent chat requests through ``MLCEngine``, with the kernels'
   launch counters checked against the engine's step count;
6. the same requests with ``kv_dtype="int8", weight_quant="w4a16"``
   (WebLLM's q4 serving), with its own launch checks;
7. the per-kind ``prefill_seq`` / ``decode`` calls on that runner;
8. the ``{"kernels": [...]}`` line, then the device line last.

Imports only torch, numpy and the port (``src/repro_torch``); never JAX
and never the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, dense bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# tolerances, kernel vs plain version on the same card and inputs:
# attention — both do f32 math over bf16 inputs and round once to bf16;
# only the summation order differs, which may flip that rounding: one
# bf16 ulp (<= 2^-7 relative) plus a small floor.  A key masked wrongly
# moves a long row's output by ~1e-3 and a short row's by ~1e-1, so the
# batch holds short-context rows of both kinds.
ATTN_ATOL, ATTN_RTOL = 2e-3, 2.0 ** -7
# rmsnorm — rsqrtf and the order of the sum of squares may flip the last
# bf16 rounding: allow two bf16 ulps relative (2^-7) plus a small floor
NORM_ATOL, NORM_RTOL = 1e-3, 2.0 ** -7
# card path vs CPU path, bf16 logits after 2 layers: matmul accumulation
# order differs between cuBLAS and the CPU BLAS, each flip of a bf16
# rounding moves an activation by 2^-8 relative
LOGIT_ATOL = 5e-2


def phase(name: str):
    print(f"[phase] {name}", flush=True)


def die(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warm: int = 3, graph: bool = False) -> float:
    """Device time of one ``fn()``, from CUDA events around ``iters``
    calls.  A call that is shorter than its own host-side launch leaves
    the card waiting on Python between calls; ``graph`` captures the
    ``iters`` calls in one CUDA graph and times its replay instead, so
    the host's pace does not enter the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------
def attention_case(dev, gen):
    """A mixed ragged batch at the serving path's shapes: decode rows,
    a full 256-token chunk, padded partial chunks (one at context 0, so
    its first query rows see one to a few keys), a contexts=0 pad row;
    contexts up to 2300 tokens."""
    H, Kv, D, ps, pps = 32, 8, 128, 16, 256
    C = 256
    lengths = [1, 1, 1, 1, C, 100, 64, 1, 0]
    starts = [37, 500, 2047, 1200, 2044, 900, 0, 15, 0]
    B = len(lengths)
    contexts = [s + n if n else 0 for s, n in zip(starts, lengths)]
    P = B * pps + 1
    q = torch.randn((B, C, H, D), generator=gen, device=dev).bfloat16()
    k_pages = torch.randn((P, ps, Kv, D), generator=gen,
                          device=dev).bfloat16()
    v_pages = torch.randn((P, ps, Kv, D), generator=gen,
                          device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=gen, device=dev)
    pt = perm[:B * pps].reshape(B, pps).to(torch.int32).contiguous()
    ctx = torch.tensor(contexts, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, page_tables=pt,
                contexts=ctx, starts=st, lengths=lengths, H=H, Kv=Kv, D=D,
                ps=ps)


def attention_cost(case, elem=2, scale_bytes=0):
    """Bytes each input is read once / output written once (K/V pages at
    ``elem`` bytes per value plus ``scale_bytes`` per (token, kv-head)),
    and the flops the valid query tokens need over their visible keys."""
    H, Kv, D, ps = case["H"], case["Kv"], case["D"], case["ps"]
    by = fl = 0
    for b, n in enumerate(case["lengths"]):
        ctx = int(case["contexts"][b])
        st = int(case["starts"][b])
        if ctx == 0:
            continue
        pages = -(-ctx // ps)
        by += 2 * pages * ps * Kv * (D * elem + scale_bytes)  # K and V
        by += 2 * n * H * D * 2                    # q in, out
        for c in range(n):
            fl += 4 * H * D * min(ctx, st + c + 1)  # QK^T and PV
    by += case["page_tables"].numel() * 4 + 8 * len(case["lengths"])
    return by, fl


def quantized(case):
    """The case's pools as int8 values and bf16 scales (the runner's own
    ``_page_quant``), and the dequantized bf16 pools for the yardstick."""
    from repro_torch.core.paged_runner import PagedModelRunner
    kq, ks = PagedModelRunner._page_quant(case["k_pages"])
    vq, vs = PagedModelRunner._page_quant(case["v_pages"])
    kd = (kq.float() * ks.float()[..., None]).bfloat16()
    vd = (vq.float() * vs.float()[..., None]).bfloat16()
    return kq, vq, dict(k_scales=ks, v_scales=vs), kd, vd


def sdpa_yardstick(q, k_pages, v_pages, tables, contexts, starts, ps):
    """One SDPA call over K/V gathered per row and expanded to H heads
    (the gather is done before timing), boolean causal mask, on q
    ``[B, C, H, D]``; returns its time."""
    B, C, H, D = q.shape
    Kv = k_pages.shape[2]
    T = tables.shape[1] * ps
    ptl = tables.long()
    G = H // Kv
    kg = k_pages[ptl].reshape(B, T, Kv, D).repeat_interleave(G, 2) \
        .transpose(1, 2).contiguous()
    vg = v_pages[ptl].reshape(B, T, Kv, D).repeat_interleave(G, 2) \
        .transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    t = torch.arange(T, device=q.device)
    qpos = starts.long()[:, None] + torch.arange(C, device=q.device)
    mask = ((t[None, None, :] < contexts.long()[:, None, None])
            & (t[None, None, :] <= qpos[..., None]))[:, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask))


def record(results, name, label, err, tol, kernel_ms, plain_ms, library_ms,
           by, fl):
    """Store one kernel's numbers for the JSON line and print them."""
    t_bytes, t_ops = by / HBM_BYTES_PER_S * 1e3, fl / BF16_FLOP_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    results[name] = dict(
        max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
        bound_by=bound_by, bytes=by, flops=fl)
    print(f"{label}: max_abs_err={err:.3g} (tol {tol}) "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
          f"({bound_by}; {by} B, {fl} flop)", flush=True)


def close(label, got, want, atol, rtol) -> float:
    """Max abs error of ``got`` against ``want``; dies past ``atol + rtol
    * |want|`` or on a non-finite value."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or \
            bool((diff > atol + rtol * w.abs()).any()):
        die(f"{label} kernel vs plain: max err {diff.max().item()} over "
            f"tol {atol} + {rtol:.4g}*|x|")
    return diff.max().item()


def check_ragged(dev, gen, results):
    """The ragged kernel on the mixed batch, over bf16 and int8 pages."""
    from repro_torch.kernels import paged_attention as pa
    case = attention_case(dev, gen)
    idx = (case["page_tables"], case["contexts"], case["starts"])
    kq, vq, sc, kd, vd = quantized(case)
    for name, pools, kw, ref_pools, elem, sb in (
            ("paged_ragged_attention", (case["k_pages"], case["v_pages"]),
             {}, (case["k_pages"], case["v_pages"]), 2, 0),
            ("paged_ragged_attention_int8", (kq, vq), sc, (kd, vd), 1, 2)):
        args = (case["q"], *pools, *idx)
        got = pa.paged_ragged_attention(*args, **kw)
        want = pa.paged_ragged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for b, n in enumerate(case["lengths"]):
            if n == 0:
                if torch.count_nonzero(got[b]).item():
                    die(f"{name}: contexts=0 row is not all zeros")
                continue
            err = max(err, close(
                f"{name} row {b} (start {int(case['starts'][b])}, {n} "
                f"tokens)", got[b, :n], want[b, :n], ATTN_ATOL, ATTN_RTOL))
        kernel_ms = time_ms(lambda: pa.paged_ragged_attention(*args, **kw))
        plain_ms = time_ms(lambda: pa.paged_ragged_attention_plain(
            *args, **kw), iters=3, warm=1)
        library_ms = sdpa_yardstick(case["q"], *ref_pools, *idx, case["ps"])
        by, fl = attention_cost(case, elem, sb)
        record(results, name, name, err,
               f"{ATTN_ATOL} + {ATTN_RTOL:.4g}*|x|", kernel_ms, plain_ms,
               library_ms, by, fl)


def check_decode_prefill(dev, gen, results):
    """The decode entry point (B=8 rows, contexts up to 2300) and the
    chunked-prefill entry point (one 256-token chunk at start 0 and at
    start 2000), each over bf16 and int8 pages.  The JSON line carries
    the int8 forms (the ones the quantized path launches) and the
    prefill chunk at start 2000."""
    from repro_torch.kernels import paged_attention as pa
    H, Kv, D, ps, pps = 32, 8, 128, 16, 160
    B = 8
    lens = [2300, 1800, 1201, 700, 333, 64, 17, 1]
    P = B * pps + 1
    case = dict(H=H, Kv=Kv, D=D, ps=ps, lengths=[1] * B,
                k_pages=torch.randn((P, ps, Kv, D), generator=gen,
                                    device=dev).bfloat16(),
                v_pages=torch.randn((P, ps, Kv, D), generator=gen,
                                    device=dev).bfloat16())
    perm = torch.randperm(P - 1, generator=gen, device=dev)
    case["page_tables"] = perm[:B * pps].reshape(B, pps).to(
        torch.int32).contiguous()
    case["contexts"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    case["starts"] = case["contexts"] - 1
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    kq, vq, sc, kd, vd = quantized(case)
    forms = (("bf16", (case["k_pages"], case["v_pages"]), {},
              (case["k_pages"], case["v_pages"]), 2, 0),
             ("int8", (kq, vq), sc, (kd, vd), 1, 2))
    errs = {"paged_attention": 0.0, "paged_prefill_attention": 0.0}
    for form, pools, kw, ref_pools, elem, sb in forms:
        args = (q, *pools, case["page_tables"], case["contexts"])
        got = pa.paged_attention(*args, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        errs["paged_attention"] = max(errs["paged_attention"], close(
            f"decode[{form}]", got, want, ATTN_ATOL, ATTN_RTOL))
        kernel_ms = time_ms(lambda: pa.paged_attention(*args, **kw),
                            graph=True)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(*args, **kw),
                           iters=3, warm=1)
        library_ms = sdpa_yardstick(q[:, None], *ref_pools,
                                    case["page_tables"], case["contexts"],
                                    case["starts"], ps)
        by, fl = attention_cost(case, elem, sb)
        record(results, "paged_attention", f"decode[{form}] B={B}",
               errs["paged_attention"], f"{ATTN_ATOL} + {ATTN_RTOL:.4g}*|x|",
               kernel_ms, plain_ms, library_ms, by, fl)
    C, pps1 = 256, 144
    qc = torch.randn((C, H, D), generator=gen, device=dev).bfloat16()
    table = case["page_tables"][0, :pps1].contiguous()
    for start in (0, 2000):
        ctx = start + C
        one = dict(H=H, Kv=Kv, D=D, ps=ps, lengths=[C],
                   contexts=[ctx], starts=[start],
                   page_tables=table[None])
        for form, pools, kw, ref_pools, elem, sb in forms:
            args = (qc, *pools, table, ctx, start)
            got = pa.paged_prefill_attention(*args, **kw)
            want = pa.paged_prefill_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            errs["paged_prefill_attention"] = max(
                errs["paged_prefill_attention"],
                close(f"prefill[{form}] start={start}", got, want,
                      ATTN_ATOL, ATTN_RTOL))
            kernel_ms = time_ms(
                lambda: pa.paged_prefill_attention(*args, **kw))
            plain_ms = time_ms(
                lambda: pa.paged_prefill_attention_plain(*args, **kw),
                iters=3, warm=1)
            i32 = lambda v: torch.tensor(  # noqa: E731
                [v], dtype=torch.int32, device=dev)
            library_ms = sdpa_yardstick(qc[None], *ref_pools, table[None],
                                        i32(ctx), i32(start), ps)
            by, fl = attention_cost(one, elem, sb)
            record(results, "paged_prefill_attention",
                   f"prefill[{form}] C={C} start={start}",
                   errs["paged_prefill_attention"],
                   f"{ATTN_ATOL} + {ATTN_RTOL:.4g}*|x|", kernel_ms,
                   plain_ms, library_ms, by, fl)


def check_w4a16(dev, gen, results):
    """``w4a16_gemm`` at a decode step's M=8 and a padded chunk step's
    M=2048, group 64: timed at the MLP's two shapes, checked also at the
    attention projections'.  The JSON line carries M=2048, (K, N) =
    (4096, 14336)."""
    from repro_torch.kernels import w4a16_gemm as wg
    from repro_torch.quant.int4 import quantize_array
    for K, N in ((14336, 4096), (4096, 14336)):
        # 4 weight copies (~30 MB packed each) cycle through the timed
        # calls, so each call's weight was last read ~90 MB earlier
        # and comes from HBM, not from the 50 MB L2
        ws = [quantize_array(torch.randn((K, N), generator=gen, device=dev)
                             .mul_(0.02).bfloat16(), 64) for _ in range(4)]
        w0 = ws[0]
        for M in (8, 2048):
            x = torch.randn((M, K), generator=gen, device=dev).mul_(0.1) \
                .bfloat16()
            got = wg.w4a16_gemm(x, w0.data, w0.scales, group=64)
            want = wg.w4a16_gemm_plain(x, w0.data, w0.scales, 64)
            torch.cuda.synchronize()
            # the same bf16 weights and f32 sums in another order: the
            # final bf16 rounding may flip (2^-7 relative), plus a floor
            # of 2^-9 of the largest output for sums that cancel
            atol = 2.0 ** -9 * want.float().abs().max().item()
            err = close(f"w4a16_gemm M={M} K={K} N={N}", got, want, atol,
                        2.0 ** -7)
            nxt = itertools.cycle(ws).__next__

            def kernel():
                w = nxt()
                return wg.w4a16_gemm(x, w.data, w.scales, group=64)

            kernel_ms = time_ms(kernel, graph=True)
            plain_ms = time_ms(lambda: wg.w4a16_gemm_plain(
                x, w0.data, w0.scales, 64), iters=3, warm=1)
            wd = [w.dequant() for w in ws]
            nxt_d = itertools.cycle(wd).__next__
            library_ms = time_ms(lambda: torch.matmul(x, nxt_d()),
                                 graph=True)
            del wd
            by = M * K * 2 + K * N // 2 + (K // 64) * N * 2 + M * N * 2
            fl = 2 * M * N * K
            record(results if (M, K) == (2048, 4096) else {},
                   "w4a16_gemm", f"w4a16_gemm M={M} K={K} N={N}", err,
                   "2^-9*max|y| + 2^-7*|y|", kernel_ms, plain_ms,
                   library_ms, by, fl)
    # the attention projections (wq / attn.wo, wk / wv): checked, not timed
    for K, N in ((4096, 4096), (4096, 1024)):
        w = quantize_array(torch.randn((K, N), generator=gen, device=dev)
                           .mul_(0.02).bfloat16(), 64)
        for M in (8, 2048):
            x = torch.randn((M, K), generator=gen, device=dev).mul_(0.1) \
                .bfloat16()
            got = wg.w4a16_gemm(x, w.data, w.scales, group=64)
            want = wg.w4a16_gemm_plain(x, w.data, w.scales, 64)
            torch.cuda.synchronize()
            atol = 2.0 ** -9 * want.float().abs().max().item()
            err = close(f"w4a16_gemm M={M} K={K} N={N}", got, want, atol,
                        2.0 ** -7)
            print(f"w4a16_gemm M={M} K={K} N={N}: max_abs_err={err:.3g} "
                  f"(tol 2^-9*max|y| + 2^-7*|y|)", flush=True)


def check_kernels(dev, results):
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    check_ragged(dev, gen, results)
    check_decode_prefill(dev, gen, results)
    check_w4a16(dev, gen, results)

    # -- rmsnorm, plain and residual forms, at the step's rows -----------
    D = 4096
    for R in (2048, 8):
        x = torch.randn((R, D), generator=gen, device=dev).bfloat16()
        r = torch.randn((R, D), generator=gen, device=dev).bfloat16()
        s = torch.rand((D,), generator=gen, device=dev) + 0.5
        for res in (None, r):
            got = rn.rmsnorm(x, s, eps=1e-5, residual=res)
            want = rn.rmsnorm_plain(x, s, 1e-5, res)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            bad = diff > NORM_ATOL + NORM_RTOL * want.float().abs()
            if bool(bad.any()):
                die(f"rmsnorm R={R} residual={res is not None}: max err "
                    f"{diff.max().item()}")
            e = diff.max().item()
            form = "residual" if res is not None else "plain"
            print(f"rmsnorm[{form}] R={R}: max_abs_err={e:.3g} "
                  f"(tol {NORM_ATOL} + {NORM_RTOL:.4g}*|x|)", flush=True)
        if R != 2048:
            continue
        # a ~10 us kernel: time inside a CUDA graph (see ``time_ms``),
        # cycling through 4 inputs so that a call's 16 MB input was last
        # touched 4 calls (128 MB of traffic) earlier and comes from HBM,
        # not from the 50 MB L2
        xs = [x] + [torch.randn((R, D), generator=gen, device=dev)
                    .bfloat16() for _ in range(3)]
        nxt = itertools.cycle(xs).__next__
        kernel_ms = time_ms(lambda: rn.rmsnorm(nxt(), s, eps=1e-5),
                            graph=True)
        plain_ms = time_ms(lambda: rn.rmsnorm_plain(nxt(), s, 1e-5),
                           graph=True)
        sb = s.bfloat16()
        library_ms = time_ms(lambda: F.rms_norm(nxt(), (D,), weight=sb,
                                                eps=1e-5), graph=True)
        by = 2 * R * D * 2 + D * 4
        fl = 4 * R * D
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = fl / BF16_FLOP_PER_S * 1e3
        got = rn.rmsnorm(x, s, eps=1e-5)
        e = (got.float() - rn.rmsnorm_plain(x, s, 1e-5).float()) \
            .abs().max().item()
        results["rmsnorm"] = dict(
            max_abs_err=e, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=by, flops=fl)
        print(f"rmsnorm R={R} D={D}: kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={max(t_bytes, t_ops):.4f}", flush=True)


# ---------------------------------------------------------------------
def check_card_vs_cpu(dev, **opts):
    """Same weights (built on the CPU, copied to the card), one ragged
    logits step and one greedy sampled step on each path; ``opts`` are
    the runner's quantization options."""
    from repro_torch.configs import get_config
    from repro_torch.core.paged_runner import PagedModelRunner
    from repro_torch.core.sampler import RequestSampler, SamplingParamsBatch
    from repro_torch.models.params import init_params

    cfg = get_config("llama-3.1-8b", reduced=True)
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 7, 23)]
    out = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        run = PagedModelRunner(cfg, params, num_pages=32, page_size=16,
                               max_slots=4, pages_per_seq=8,
                               chunk_size=16, device=device, **opts)
        sids = [run.begin_seq(p) for p in prompts]
        logits = run.run_step([(s, p, "prefill")
                               for s, p in zip(sids, prompts)])
        out[name] = np.stack([logits[s] for s in sids])
        # both paths decode the CPU path's greedy tokens, sampled greedily
        # on the device; top-2 logprobs give the margin of a near-tie
        first = [int(np.argmax(r)) for r in out.get("cpu", out[name])]
        rows = [(s, [t], "decode") for s, t in zip(sids, first)]
        batch = SamplingParamsBatch.build(
            [(b, RequestSampler(temperature=0.0), None)
             for b in range(len(rows))], cfg.vocab_size)
        out[name + "/step2"] = run.run_step(rows, sampling=batch, n_top=2)
    lc, lg = out["cpu"], out["cuda"]
    err = float(np.abs(lc - lg).max())
    if not np.isfinite(lg).all() or err > LOGIT_ATOL:
        die(f"card vs CPU logits: max err {err} > {LOGIT_ATOL}")
    rc, rg = out["cpu/step2"], out["cuda/step2"]
    same = []
    for i in range(len(sids)):
        ok = int(rc.tokens[i]) == int(rg.tokens[i])
        # a differing greedy token passes only on a true tie: the CPU
        # path's top-2 margin is inside the logits tolerance
        margin = float(rc.top_lps[i, 0] - rc.top_lps[i, 1])
        if not ok and margin >= LOGIT_ATOL:
            die(f"greedy token {i} differs: cpu {rc.tokens.tolist()} card "
                f"{rg.tokens.tolist()} (cpu margin {margin:.3g})")
        same.append(ok)
    print(f"card vs cpu (reduced {cfg.n_layers} layers{opts or ''}): "
          f"logits max err "
          f"{err:.3g} (tol {LOGIT_ATOL}); greedy tokens equal: {same}",
          flush=True)


# ---------------------------------------------------------------------
def _prompt_text(n_words: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "this", "is", "a", "tiny", "corpus", "for",
             "the", "demo", "engine", "json", "key", "value", "true"]
    return " ".join(words[i] for i in rng.integers(0, len(words), n_words))


def profile_serving(engine, jobs, out_path: Path):
    """Serve ``jobs`` again under ``torch.profiler`` (CPU + CUDA) and
    write the busiest ops by device and by host time, plus the device's
    busy share of the window, to ``out_path``.  Profiling slows the
    host, so these numbers are read apart from the unprofiled run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=engine.chat_completions_create,
                                    args=(r,)) for _, r in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in avg)
    steps = engine.stats("llama")["engine"]["exec_steps"]
    key = ("self_device_time_total"
           if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    text = [f"profiled window: wall {wall * 1e3:.1f} ms, device busy "
            f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
            f" %), engine exec_steps so far {steps}",
            avg.table(sort_by=key, row_limit=30),
            avg.table(sort_by="self_cpu_time_total", row_limit=30)]
    out_path.write_text("\n".join(text))
    print(text[0], flush=True)


def weight_bytes(params) -> int:
    from repro_torch.models.params import tree_leaves
    from repro_torch.quant.int4 import is_qtensor
    total = 0
    for t in tree_leaves(params):
        for part in ((t.data, t.scales) if is_qtensor(t) else (t,)):
            total += part.numel() * part.element_size()
    return total


def serve_full_width(dev, results, quant=False, profile_to=None):
    """Serve the 8 requests at full width: bf16 weights and pages, or
    (``quant``) W4A16 weights over int8 pages, WebLLM's q4 default.
    Returns the engine's runner (the engine is shut down)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ChatMessage, MLCEngine
    from repro_torch.core.api import ChatCompletionRequest
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import w4a16_gemm as wg

    cfg = get_config("llama-3.1-8b")
    opts = dict(kv_dtype="int8", weight_quant="w4a16") if quant else {}
    gc.collect()
    t0 = time.perf_counter()
    engine = MLCEngine()
    engine.load_model("llama", cfg, backend="paged", max_slots=8,
                      max_context=4096, prefill_chunk_size=256, seed=0,
                      warmup=True, device=dev, **opts)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    runner = engine.models["llama"].runner.runner
    print(f"loaded {cfg.name} ({cfg.num_params() / 1e9:.2f} B params, "
          f"{cfg.n_layers} layers{', w4a16 + int8 KV' if quant else ''}) "
          f"in {time.perf_counter() - t0:.1f} s; weights "
          f"{weight_bytes(runner.params) / 2**30:.2f} GiB, KV pools "
          f"{runner.pm.num_pages * runner.page_bytes / 2**30:.2f} GiB; "
          f"device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    tok = engine.models["llama"].tokenizer
    long_text = _prompt_text(1100, 1)     # ~2000 tokens
    n_long = len(tok.encode(tok.apply_chat_template(
        [{"role": "user", "content": long_text}])))

    def req(text, **kw):
        return ChatCompletionRequest(
            model="llama", messages=[ChatMessage("user", text)],
            max_tokens=64, **kw)

    jobs = [("short", req(_prompt_text(12 + i, 10 + i), temperature=0.0))
            for i in range(4)]
    jobs += [("long", req(long_text + f" {i}", temperature=0.8, seed=i))
             for i in range(2)]
    results_by = {}
    errors = []

    def run(name, r):
        try:
            results_by.setdefault(name, []).append(
                engine.chat_completions_create(r))
        except Exception as e:      # surfaced after join
            errors.append(repr(e))

    def chat():
        try:
            msgs = [ChatMessage("user", _prompt_text(300, 3))]
            r1 = engine.chat_completions_create(ChatCompletionRequest(
                model="llama", messages=msgs, max_tokens=64,
                temperature=0.0))
            msgs += [ChatMessage("assistant", r1.choices[0].message.content),
                     ChatMessage("user", "and then?")]
            r2 = engine.chat_completions_create(ChatCompletionRequest(
                model="llama", messages=msgs, max_tokens=64,
                temperature=0.0))
            results_by["chat"] = [r1, r2]
        except Exception as e:
            errors.append(repr(e))

    pa.launches = pa.launches_int8 = rn.launches = wg.launches = 0
    steps0 = engine.stats("llama")["engine"]["exec_steps"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    threads.append(threading.Thread(target=chat))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ragged=pa.launches, ragged_int8=pa.launches_int8,
                  rmsnorm=rn.launches, w4a16=wg.launches)
    stats = engine.stats("llama")
    if profile_to is not None and not errors:
        profile_serving(engine, jobs, profile_to)
    engine.shutdown(wait=True)
    if errors or any(t.is_alive() for t in threads):
        die(f"serving failed: {errors or 'timeout'}")
    steps = stats["engine"]["exec_steps"] - steps0
    run_stats = stats["runner"]
    responses = [r for rs in results_by.values() for r in rs]
    if len(responses) != 8:
        die(f"expected 8 responses, got {len(responses)}")
    n_gen = sum(r.usage.completion_tokens for r in responses)
    for r in responses:
        c = r.choices[0]
        if c.finish_reason not in ("stop", "length") or \
                r.usage.completion_tokens < 1:
            die(f"bad response {r.id}: {c.finish_reason}")
    cached = results_by["chat"][1].usage.extra["prefix_cached_tokens"]
    ragged = "ragged_int8" if quant else "ragged"
    checks = {
        "attn_kernel_calls == exec_steps":
            run_stats["attn_kernel_calls"] == stats["engine"]["exec_steps"],
        "host_logit_rows == 0": run_stats["host_logit_rows"] == 0,
        f"{ragged} launches == 32 x steps": counts[ragged] == 32 * steps,
        "rmsnorm launches == 65 x steps": counts["rmsnorm"] == 65 * steps,
        "w4a16_gemm launches == "
        f"{224 if quant else 0} x steps":
            counts["w4a16"] == (224 if quant else 0) * steps,
        "turn-2 prefix_cached_tokens > 0": cached > 0,
        f"kv_dtype == {opts.get('kv_dtype', 'f32')}":
            run_stats["kv_dtype"] == opts.get("kv_dtype", "f32"),
    }
    ttft = statistics.median(r.usage.extra["ttft_s"] for r in responses)
    itl = statistics.median(
        (r.usage.extra["e2e_latency_s"] - r.usage.extra["ttft_s"])
        / max(1, r.usage.completion_tokens - 1) for r in responses)
    print(f"serve: {len(responses)} requests, long prompt {n_long} tokens, "
          f"{n_gen} tokens in {wall:.2f} s = {n_gen / wall:.1f} tok/s; "
          f"TTFT p50 {ttft * 1e3:.1f} ms; ITL p50 {itl * 1e3:.2f} ms; "
          f"exec_steps {steps}; launches: {counts}; turn-2 cached {cached}; "
          f"host_ms_per_step {stats['engine']['host_ms_per_step']}",
          flush=True)
    for k, ok in checks.items():
        print(f"  check {k}: {'ok' if ok else 'FAILED'}", flush=True)
    if not all(checks.values()):
        die("serving-path checks failed")
    if quant:
        results["paged_ragged_attention_int8"]["launches"] = \
            counts["ragged_int8"]
        results["w4a16_gemm"]["launches"] = counts["w4a16"]
    else:
        results["paged_ragged_attention"]["launches"] = counts["ragged"]
        results["rmsnorm"]["launches"] = counts["rmsnorm"]
    return runner


def per_kind_full_width(runner, results):
    """The per-kind paths on the quantized full-width runner: a 600-token
    prompt through ``prefill_seq`` (chunks of 256 through the prefill
    kernel), then 4 batched ``decode`` calls; the decode and prefill
    launch counters must move by one per layer and call, and the logits
    be finite."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, runner.cfg.vocab_size, 600).tolist()
    L = runner.cfg.n_layers
    pa.decode_launches = pa.prefill_launches = 0
    t0 = time.perf_counter()
    sid = runner.prefill_seq(prompt)
    cached = runner.last_prefill_info["prefix_cached_tokens"]
    first = runner.last_prefill_logits()
    logits = [runner.decode({sid: int(np.argmax(first))})[sid]]
    for _ in range(3):
        logits.append(runner.decode({sid: int(np.argmax(logits[-1]))})[sid])
    wall = time.perf_counter() - t0
    n_pf, n_dec = pa.prefill_launches, pa.decode_launches
    chunks = -(-(len(prompt) - cached) // runner.chunk_size)
    ok = (n_pf == L * chunks and n_dec == L * 4
          and all(np.isfinite(x).all() for x in [first] + logits)
          and first.shape == (runner.cfg.vocab_size,))
    print(f"per-kind: prefill_seq of {len(prompt)} tokens ({chunks} chunks) "
          f"+ 4 decode calls in {wall:.2f} s; launches: prefill {n_pf}, "
          f"decode {n_dec}; logits finite: {ok}", flush=True)
    if not ok:
        die("per-kind path checks failed")
    runner.free(sid)
    results["paged_attention"]["launches"] = n_dec
    results["paged_prefill_attention"]["launches"] = n_pf


# ---------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="after each serving phase, serve its requests "
                         "again under torch.profiler; tables go to "
                         "chiprun_out/profile_serve*.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this smoke run needs a "
            "CUDA device")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        die(f"the port is missing ({e}): run from a checkout of the repo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    _build.build(verbose=args.verbose_build)
    _build.lib()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results = {}
    phase("kernels vs plain")
    check_kernels(dev, results)
    phase("card path vs cpu path")
    check_card_vs_cpu(dev)
    check_card_vs_cpu(dev, kv_dtype="int8", weight_quant="w4a16")
    phase("serve llama-3.1-8b at full width")
    out_dir = ROOT / "chiprun_out"
    if args.profile:
        out_dir.mkdir(exist_ok=True)
    serve_full_width(dev, results, profile_to=(
        out_dir / "profile_serve.txt" if args.profile else None))
    phase("serve llama-3.1-8b w4a16 + int8 KV at full width")
    runner = serve_full_width(dev, results, quant=True, profile_to=(
        out_dir / "profile_serve_w4a16_int8.txt" if args.profile else None))
    phase("per-kind prefill_seq / decode on the quantized runner")
    per_kind_full_width(runner, results)
    del runner

    attn_src = "src/repro_torch/kernels/csrc/paged_ragged_attention.cu"
    replaces = {
        "paged_ragged_attention": (
            attn_src, "src/repro/kernels/paged_attention.py:369"),
        "paged_ragged_attention_int8": (
            attn_src, "src/repro/kernels/paged_attention.py:369"),
        "paged_attention": (
            attn_src, "src/repro/kernels/paged_attention.py:114"),
        "paged_prefill_attention": (
            attn_src, "src/repro/kernels/paged_attention.py:237"),
        "w4a16_gemm": ("src/repro_torch/kernels/csrc/w4a16_gemm.cu",
                       "src/repro/kernels/w4a16_gemm.py:57"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:34"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        r = results[name]
        if not r.get("launches"):
            die(f"{name} was not launched on the serving path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
