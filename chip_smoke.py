"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --verbose-build   # also print nvcc -Xptxas -v

Phases, each printed on its own line; any failure exits non-zero before
the result lines:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (Llama-3.1-8B: H=32, Kv=8, D=128, page 16;
   RMSNorm at D=4096), with times beside the card's bound and a library
   yardstick;
4. the card path against the CPU path at reduced depth, same weights;
5. the serving path at full Llama-3.1-8B width (random weights): 8
   concurrent chat requests through ``MLCEngine``, with the kernels'
   launch counters checked against the engine's step count;
6. the ``{"kernels": [...]}`` line, then the device line last.

Imports only torch, numpy and the port (``src/repro_torch``); never JAX
and never the JAX package.
"""
from __future__ import annotations

import argparse
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


def attention_cost(case):
    """Bytes each input is read once / output written once, and the
    flops the valid query tokens need over their visible keys."""
    H, Kv, D, ps = case["H"], case["Kv"], case["D"], case["ps"]
    by = fl = 0
    for b, n in enumerate(case["lengths"]):
        ctx = int(case["contexts"][b])
        st = int(case["starts"][b])
        if ctx == 0:
            continue
        pages = -(-ctx // ps)
        by += 2 * pages * ps * Kv * D * 2          # K and V pages
        by += 2 * n * H * D * 2                    # q in, out
        for c in range(n):
            fl += 4 * H * D * min(ctx, st + c + 1)  # QK^T and PV
    by += case["page_tables"].numel() * 4 + 8 * len(case["lengths"])
    return by, fl


def check_kernels(dev, results):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # -- ragged paged attention ------------------------------------------
    case = attention_case(dev, gen)
    args = (case["q"], case["k_pages"], case["v_pages"],
            case["page_tables"], case["contexts"], case["starts"])
    got = pa.paged_ragged_attention(*args)
    want = pa.paged_ragged_attention_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for b, n in enumerate(case["lengths"]):
        if n == 0:
            if torch.count_nonzero(got[b]).item():
                die("attention: contexts=0 row is not all zeros")
            continue
        g, w = got[b, :n].float(), want[b, :n].float()
        diff = (g - w).abs()
        if not bool(torch.isfinite(g).all()) or \
                bool((diff > ATTN_ATOL + ATTN_RTOL * w.abs()).any()):
            die(f"attention kernel vs plain, row {b} (start "
                f"{int(case['starts'][b])}, {n} tokens): max err "
                f"{diff.max().item()} over tol {ATTN_ATOL} + "
                f"{ATTN_RTOL:.4g}*|x|")
        err = max(err, diff.max().item())
    kernel_ms = time_ms(lambda: pa.paged_ragged_attention(*args))
    plain_ms = time_ms(lambda: pa.paged_ragged_attention_plain(*args),
                       iters=3, warm=1)
    # yardstick: one SDPA call over K/V gathered per row and expanded to
    # H heads (the gather is done before timing), boolean causal mask
    B, C = case["q"].shape[:2]
    T = case["page_tables"].shape[1] * case["ps"]
    ptl = case["page_tables"].long()
    G = case["H"] // case["Kv"]
    kg = case["k_pages"][ptl].reshape(B, T, case["Kv"], case["D"]) \
        .repeat_interleave(G, 2).transpose(1, 2).contiguous()
    vg = case["v_pages"][ptl].reshape(B, T, case["Kv"], case["D"]) \
        .repeat_interleave(G, 2).transpose(1, 2).contiguous()
    qt = case["q"].transpose(1, 2).contiguous()
    t = torch.arange(T, device=dev)
    qpos = case["starts"].long()[:, None] + torch.arange(C, device=dev)
    mask = ((t[None, None, :] < case["contexts"].long()[:, None, None])
            & (t[None, None, :] <= qpos[..., None]))[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask))
    by, fl = attention_cost(case)
    t_bytes, t_ops = by / HBM_BYTES_PER_S * 1e3, fl / BF16_FLOP_PER_S * 1e3
    results["paged_ragged_attention"] = dict(
        max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=by, flops=fl)
    print(f"attention: max_abs_err={err:.3g} (tol {ATTN_ATOL} + "
          f"{ATTN_RTOL:.4g}*|x|) "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"{by} B, {fl} flop)", flush=True)

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
def check_card_vs_cpu(dev):
    """Same weights (built on the CPU, copied to the card), one ragged
    logits step and one greedy sampled step on each path."""
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
                               chunk_size=16, device=device)
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
    print(f"card vs cpu (reduced {cfg.n_layers} layers): logits max err "
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


def serve_full_width(dev, results, profile_to=None):
    from repro_torch.configs import get_config
    from repro_torch.core import ChatMessage, MLCEngine
    from repro_torch.core.api import ChatCompletionRequest
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn

    cfg = get_config("llama-3.1-8b")
    t0 = time.perf_counter()
    engine = MLCEngine()
    engine.load_model("llama", cfg, backend="paged", max_slots=8,
                      max_context=4096, prefill_chunk_size=256, seed=0,
                      warmup=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"loaded {cfg.name} ({cfg.num_params() / 1e9:.2f} B params, "
          f"{cfg.n_layers} layers) in {time.perf_counter() - t0:.1f} s; "
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

    pa.launches = 0
    rn.launches = 0
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
    attn_launches, norm_launches = pa.launches, rn.launches
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
    checks = {
        "attn_kernel_calls == exec_steps":
            run_stats["attn_kernel_calls"] == stats["engine"]["exec_steps"],
        "host_logit_rows == 0": run_stats["host_logit_rows"] == 0,
        "ragged launches == 32 x steps": attn_launches == 32 * steps,
        "rmsnorm launches == 65 x steps": norm_launches == 65 * steps,
        "turn-2 prefix_cached_tokens > 0": cached > 0,
    }
    ttft = statistics.median(r.usage.extra["ttft_s"] for r in responses)
    itl = statistics.median(
        (r.usage.extra["e2e_latency_s"] - r.usage.extra["ttft_s"])
        / max(1, r.usage.completion_tokens - 1) for r in responses)
    print(f"serve: {len(responses)} requests, long prompt {n_long} tokens, "
          f"{n_gen} tokens in {wall:.2f} s = {n_gen / wall:.1f} tok/s; "
          f"TTFT p50 {ttft * 1e3:.1f} ms; ITL p50 {itl * 1e3:.2f} ms; "
          f"exec_steps {steps}; launches: ragged {attn_launches}, "
          f"rmsnorm {norm_launches}; turn-2 cached {cached}; "
          f"host_ms_per_step {stats['engine']['host_ms_per_step']}",
          flush=True)
    for k, ok in checks.items():
        print(f"  check {k}: {'ok' if ok else 'FAILED'}", flush=True)
    if not all(checks.values()):
        die("serving-path checks failed")
    results["paged_ragged_attention"]["launches"] = attn_launches
    results["rmsnorm"]["launches"] = norm_launches


# ---------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving phase, serve its requests "
                         "again under torch.profiler; tables go to "
                         "chiprun_out/profile_serve.txt")
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
    phase("serve llama-3.1-8b at full width")
    out_dir = ROOT / "chiprun_out"
    if args.profile:
        out_dir.mkdir(exist_ok=True)
    serve_full_width(dev, results, profile_to=(
        out_dir / "profile_serve.txt" if args.profile else None))

    replaces = {
        "paged_ragged_attention": (
            "src/repro_torch/kernels/csrc/paged_ragged_attention.cu",
            "src/repro/kernels/paged_attention.py:369"),
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
