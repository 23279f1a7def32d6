"""PagedModelRunner: ragged fused steps through the paged KV cache, in
PyTorch.

Port of ``src/repro/core/paged_runner.py``, every option of it.  Every
token — prompt or completion, cold or cache-hit — flows through page
pools ``[L, P + 1, page_size, Kv, Dh]``: bf16 by default, or int8 values
with bf16 per-(token, kv-head) scale planes ``[L, P + 1, page_size, Kv]``
under ``kv_dtype="int8"`` (quantized at scatter time; the planes ride
through every page copy, fork, publish/adopt and rewind with their
pages).  Under ``weight_quant="w4a16"`` the projection weights are
packed to int4 at load and every projection goes through ``qdot`` (the
W4A16 GEMM kernel).  A whole engine step runs as ONE ragged attention
kernel launch per layer (``repro_torch.kernels.paged_attention``):

* ``run_step(rows)``: each row is a chunk of consecutive tokens of one
  sequence (a decode token is a length-1 row).  All rows' K/V are
  scattered into their pages in place (``index_put_`` on the layer's
  pool slice — JAX donated and rebound the pools), rows are padded to a
  power-of-two ``(B, C)`` bucket whose pad K/V writes land in a trash
  page, and with a :class:`SamplingParamsBatch` the step samples on the
  device (``repro_torch.kernels.sampling``) so only token ids come back.
* ``prefill_chunk(sid, tokens)`` / ``decode(seq_tokens)``: the per-kind
  single calls (one sequence's chunk through the chunked-prefill
  kernel, one batched decode token per sequence through the decode
  kernel), kept as the reference path for tests and non-interleaving
  callers; they return logits to the host (counted by
  ``host_logit_rows``).  ``prefill_seq`` loops chunks over a prompt.

PyTorch enqueues asynchronously on the current CUDA stream, so a
:class:`StepHandle` is a set of device tensors whose ``materialize()``
is a blocking ``.cpu()`` — depth-2 pipelining needs no side stream.
Host inputs go up through pinned, double-buffered staging with
``non_blocking=True`` copies (a pageable upload would synchronize the
stream and serialize the pipeline).

Page bookkeeping lives in :class:`repro_torch.core.paged_cache.PageManager`.
:class:`PagedEngineBackend` wraps the runner in the slot-keyed interface
``MLCEngine`` drives.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_cache import OutOfPages, PageManager
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.sampler import SampleResult, SamplingParamsBatch
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_prefill_attention,
                                                 paged_ragged_attention)
from repro_torch.kernels.sampling import batched_accept, batched_sample
from repro_torch.models.attention import _project, _qk_norm
from repro_torch.models.layers import apply_rope, mlp, rmsnorm
from repro_torch.models.params import (init_params, paged_supported,
                                       params_def, to_device)
from repro_torch.quant.int4 import qdot, quantize_tree

__all__ = ["OutOfPages", "PagedEngineBackend", "PagedModelRunner",
           "StepHandle", "paged_supported"]


@dataclass
class StepHandle:
    """One dispatched-but-not-materialized fused step.

    Holds the step's on-device sampling outputs.  The next step's decode
    inputs can be gathered device-to-device from ``tokens``
    (``run_step(prev=handle, decode_srcs=...)``).  ``materialize()``
    blocks until the step is done (``.cpu()``), accounts the wait to the
    runner's ``t_block_s``/``host_sync_bytes``, backfills the token
    placeholders of device-fed rows into ``seq_tokens``, and caches the
    result (idempotent)."""
    tokens: torch.Tensor      # [Sb] int32, on device
    logprob: torch.Tensor     # [Sb] f32
    top_ids: torch.Tensor     # [Sb, K] int32
    top_lps: torch.Tensor     # [Sb, K] f32
    n_rows: int               # valid sampling rows (<= Sb)
    runner: "PagedModelRunner"
    emit: torch.Tensor = None  # [Sb] bool speculative acceptance
    backfills: List[Tuple[int, int, int]] = field(default_factory=list)
    result: Optional[SampleResult] = None

    def backfill(self, sid: int, pos: int, src: int):
        """Register that ``seq_tokens[sid][pos]`` holds a placeholder for
        this handle's sampling row ``src``; resolves immediately when
        already materialized."""
        if self.result is not None:
            toks = self.runner.seq_tokens.get(sid)
            if toks is not None and pos < len(toks):
                toks[pos] = int(self.result.tokens[src])
        else:
            self.backfills.append((sid, pos, src))

    def materialize(self) -> SampleResult:
        if self.result is not None:
            return self.result
        r = self.runner
        t0 = time.perf_counter()
        tok = self.tokens.cpu().numpy()         # blocks until step done
        r.t_block_s += time.perf_counter() - t0
        n = self.n_rows
        res = SampleResult(
            tokens=tok[:n],
            logprob=self.logprob[:n].cpu().numpy(),
            top_ids=self.top_ids[:n].cpu().numpy(),
            top_lps=self.top_lps[:n].cpu().numpy(),
            emit=(self.emit[:n].cpu().numpy() if self.emit is not None
                  else np.ones(n, bool)))
        r.host_sync_bytes += (res.tokens.nbytes + res.logprob.nbytes
                              + res.top_ids.nbytes + res.top_lps.nbytes
                              + res.emit.nbytes)
        for sid, pos, src in self.backfills:
            toks = r.seq_tokens.get(sid)
            if toks is not None and pos < len(toks):
                toks[pos] = int(tok[src])
        self.result = res
        return res


class _Staging:
    """Host→device upload of one step's inputs in ONE copy: the arrays
    are packed into a pinned byte buffer (16-byte aligned slots) and
    sliced back into typed views on the device.  Two buffer sets
    alternate; before a set is repacked, the event recorded after its
    previous copy is waited on, so a pending transfer is never
    overwritten.  On the CPU the arrays are simply copied."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._events: List[Optional[object]] = [None, None]
        self._i = 0

    def upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if not self.cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(a).copy())
                    for k, a in arrays.items()}
        layout, off = {}, 0
        for k, a in arrays.items():
            layout[k] = (off, a)
            off += -(-a.nbytes // 16) * 16
        i = self._i
        self._i ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < off:
            buf = self._bufs[i] = torch.empty(max(off, 4096),
                                              dtype=torch.uint8,
                                              pin_memory=True)
        host = buf.numpy()
        for k, (o, a) in layout.items():
            host[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8) \
                .reshape(-1)
        dev = buf[:off].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[i] = ev
        out = {}
        for k, (o, a) in layout.items():
            t = dev[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype.str])
            out[k] = t.reshape(a.shape)
        return out


_TORCH_DTYPE = {np.dtype(np.int32).str: torch.int32,
                np.dtype(np.float32).str: torch.float32}


class PagedModelRunner:
    """Chunked-prefill + decode paged runner (everything runs in pages)."""

    def __init__(self, cfg: ModelConfig, params=None, *, num_pages: int = 64,
                 page_size: int = 16, max_slots: int = 4,
                 pages_per_seq: int = 8, seed: int = 0,
                 enable_prefix_cache: bool = True,
                 chunk_size: int = 16,
                 max_cached_pages: Optional[int] = None,
                 max_cached_bytes: Optional[int] = None,
                 kv_dtype: str = "f32",
                 weight_quant: str = "off",
                 device=None):
        assert paged_supported(cfg), f"{cfg.name}: paged path needs pure GQA"
        assert chunk_size >= 1
        assert kv_dtype in ("f32", "int8"), kv_dtype
        assert weight_quant in ("off", "w4a16"), weight_quant
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.max_slots = max_slots
        self.chunk_size = chunk_size
        self.kv_quant = kv_dtype == "int8"
        self.kv_dtype = kv_dtype
        self.weight_quant = weight_quant
        self.pm = PageManager(num_pages, page_size, max_slots, pages_per_seq)
        # K + V planes across every layer: what one physical page costs
        # ("f32" pools hold bf16 vectors; int8 pools one byte per element
        # plus a bf16 scale per (token, kv-head))
        kv_elem, scale_bytes = (1, 2) if self.kv_quant else (2, 0)
        self.page_bytes = (2 * cfg.n_layers * page_size * cfg.n_kv_heads
                           * (cfg.head_dim * kv_elem + scale_bytes))
        self.prefix_cache = (
            PrefixCache(self.pm, max_cached_pages=max_cached_pages,
                        max_cached_bytes=max_cached_bytes,
                        page_bytes=self.page_bytes)
            if enable_prefix_cache else None)
        self.seq_tokens: Dict[int, List[int]] = {}   # tokens whose KV is paged
        self.last_prefill_info: Dict[str, int] = {"prefix_cached_tokens": 0}
        self.n_prefills = 0               # prompt prefills (not forks)
        self.n_forks = 0                  # CoW sequence forks
        self.n_prefill_chunks = 0         # per-kind prefill chunk calls
        self.n_prefill_tokens = 0         # real (non-pad) tokens prefilled
        self.n_decode_steps = 0           # per-kind batched decode calls
        self.n_decode_tokens = 0          # tokens decoded across the batch
        self.n_ragged_steps = 0           # fused ragged steps
        self.n_sampled_tokens = 0         # tokens sampled ON DEVICE
        #: logit ROWS ([V] float vectors) pulled device→host — 0 on the
        #: fused engine path, where only sampled token ids cross back
        self.host_logit_rows = 0
        self.host_sync_bytes = 0          # device→host payload bytes
        self.t_block_s = 0.0              # host seconds blocked on device
        #: distinct fused-sampled step shapes dispatched so far, keyed by
        #: their full static signature (surfaced as ``jit_buckets``)
        self._seen_buckets: set = set()
        self.n_warmup_compiles = 0        # shapes run by warmup()
        self.n_rewinds = 0                # finish / rejected-draft rewinds
        #: sampling rows are ALWAYS padded to this fixed bucket, so a
        #: pipelined step can gather its decode inputs straight from the
        #: previous StepHandle's token array
        self._s_rows = self._bucket(max(1, max_slots))
        #: device-resident penalty count planes ``[max_slots + 1, V]``
        #: (row ``max_slots`` is the trash row pad sampling rows hit),
        #: allocated lazily at the engine's vocab
        self.count_planes = torch.zeros((1, 1), dtype=torch.float32,
                                        device=self.device)
        self._plane_vocab: Optional[int] = None
        self._staging = _Staging(self.device)
        #: bounded trace of steps: ("decode", batch_size) |
        #: ("chunk", n_valid_tokens) | ("ragged", n_decode_rows,
        #: n_prefill_tokens)
        self.step_log: Deque[Tuple] = deque(maxlen=4096)
        self._last_logits_np: Optional[np.ndarray] = None
        if params is None:
            params = init_params(cfg, seed, self.device)
        else:
            params = to_device(params, self.device)
        if weight_quant == "w4a16":
            # in place on the runner's own tree: each bf16 weight is
            # released as soon as it is packed
            params = quantize_tree(params, params_def(cfg))
        self.params = params
        self.layers = params["layers"]
        L, Kv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # one extra physical page (index num_pages) absorbs the K/V
        # writes of pad slots — never in any page table, never read
        self.trash_page = num_pages
        self.k_pages = torch.zeros(
            (L, num_pages + 1, page_size, Kv, Dh),
            dtype=torch.int8 if self.kv_quant else torch.bfloat16,
            device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        # per-(token, kv-head) dequant scale planes, laid out like the
        # pools so the page tables route them too (int8 pools only)
        self.k_scales = self.v_scales = None
        if self.kv_quant:
            self.k_scales = torch.zeros((L, num_pages + 1, page_size, Kv),
                                        dtype=torch.bfloat16,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        # persistent all-zero "previous tokens", for steps with no
        # pipelined predecessor
        self._zero_prev: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _page_quant(x: torch.Tensor):
        """Symmetric per-(token, kv-head) int8 quantization of K/V rows:
        ``x [..., Kv, Dh] -> (int8 values, bf16 scales [..., Kv])``,
        bitwise the reference's (f32 ``amax / 127`` floored at 1e-8,
        round half to even, clip to +-127).  Dequant is ``values *
        scale`` — the multiply the attention kernel fuses into its page
        loop."""
        xf = x.float()
        amax = xf.abs().amax(dim=-1)
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale.to(torch.bfloat16)

    def _scatter_kv(self, li: int, page_idx, page_off, k, v):
        """Scatter one layer's new K/V rows ``[N, Kv, Dh]`` into the pools
        in place — quantized at scatter time (values + scales) when the
        pool is int8."""
        at = (page_idx, page_off)
        if self.kv_quant:
            kq, ks = self._page_quant(k)
            vq, vs = self._page_quant(v)
            self.k_pages[li].index_put_(at, kq)
            self.v_pages[li].index_put_(at, vq)
            self.k_scales[li].index_put_(at, ks)
            self.v_scales[li].index_put_(at, vs)
        else:
            self.k_pages[li].index_put_(at, k)
            self.v_pages[li].index_put_(at, v)

    def _layer_pools(self, li: int):
        """One layer's pools and scale planes (``None`` for bf16 pools),
        the attention kernels' operands."""
        if self.kv_quant:
            return (self.k_pages[li], self.v_pages[li], self.k_scales[li],
                    self.v_scales[li])
        return self.k_pages[li], self.v_pages[li], None, None

    def _forward(self, tokens, pos, page_idx, page_off, attend):
        """The model over ``tokens``/``pos [b, s]`` with K/V scattered to
        ``page_idx``/``page_off [b*s]`` (pads to the trash page) before
        each layer's ``attend(q [b, s, H, Dh], k_pages, v_pages, k_scales,
        v_scales) -> [b, s, H*Dh]``.  Returns logits ``[b, s, V]`` in bf16
        (bf16 activations @ bf16 lm_head, the reference's rounding)."""
        cfg = self.cfg
        params = self.params
        page_idx = page_idx.long()
        page_off = page_off.long()
        x = params["embed"][tokens.long()]                     # [b,s,D]
        for li, p in enumerate(self.layers):
            h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
            q = _project(cfg, p["attn"], h, "q", cfg.n_heads)  # [b,s,H,Dh]
            k = _project(cfg, p["attn"], h, "k", cfg.n_kv_heads)
            v = _project(cfg, p["attn"], h, "v", cfg.n_kv_heads)
            q, k = _qk_norm(cfg, p["attn"], q, k)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
            self._scatter_kv(li, page_idx, page_off,
                             k.reshape(-1, cfg.n_kv_heads, cfg.head_dim),
                             v.reshape(-1, cfg.n_kv_heads, cfg.head_dim))
            att = attend(q, *self._layer_pools(li))
            x = x + qdot(att, p["attn"]["wo"])
            h = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
            x = x + mlp(h, p["ffn"], cfg.act)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    def _ragged_logits(self, tokens, pos, page_tables, contexts, starts,
                       page_idx, page_off):
        """One fused ragged step over B packed rows of C slots each.

        tokens/pos/page_idx/page_off [B*C] (row b occupies ``b*C :
        (b+1)*C``; slots past the row's valid length are pads);
        page_tables [B, pps]; contexts/starts [B].  Every row attends to
        its own page-table row — one attention kernel launch per layer.
        Returns each row's per-slot logits ``[B, C, V]``."""
        cfg = self.cfg
        B = page_tables.shape[0]
        N = tokens.shape[0]
        C = N // B

        def attend(q, kp, vp, ks, vs):
            return paged_ragged_attention(
                q[0].reshape(B, C, cfg.n_heads, cfg.head_dim), kp, vp,
                page_tables, contexts, starts, k_scales=ks,
                v_scales=vs).reshape(1, N, -1)

        logits = self._forward(tokens[None], pos[None], page_idx, page_off,
                               attend)
        return logits[0].reshape(B, C, -1)

    def _decode_logits(self, a: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One batched decode step: ``tokens [B, 1]`` at ``pos [B]``;
        table [B, pps], lens [B] including the new token.  Logits
        ``[B, V]``."""
        cfg = self.cfg
        B = a["tokens"].shape[0]

        def attend(q, kp, vp, ks, vs):
            return paged_attention(q[:, 0], kp, vp, a["table"], a["lens"],
                                   k_scales=ks, v_scales=vs
                                   ).reshape(B, 1, -1)

        return self._forward(a["tokens"], a["pos"][:, None], a["page_idx"],
                             a["page_off"], attend)[:, 0]

    def _chunk_logits(self, a: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One sequence's padded chunk: ``tokens/pos [C]``, table [pps],
        ``ctx``/``start`` [1] (tokens in pages incl. this chunk's valid
        ones; position of chunk row 0).  Logits ``[C, V]``."""
        C = a["tokens"].shape[0]

        def attend(q, kp, vp, ks, vs):
            return paged_prefill_attention(
                q[0], kp, vp, a["table"], a["ctx"], a["start"],
                k_scales=ks, v_scales=vs).reshape(1, C, -1)

        return self._forward(a["tokens"][None], a["pos"][None],
                             a["page_idx"], a["page_off"], attend)[0]

    def _ragged_sample_step(self, a: Dict[str, torch.Tensor], prev_tokens,
                            *, vocab: int, n_top: int, use_planes: bool,
                            all_greedy: bool, need_logprobs: bool,
                            use_counts: bool):
        """The fused logits→token step: ragged attention, then batched
        sampling over each sampling row's logits slot, then speculative
        acceptance and the count-plane update — all enqueued on the
        device, nothing read back.

        Slots with ``tok_src >= 0`` take their input token from
        ``prev_tokens[tok_src]`` (the previous step's on-device sampled
        tokens); ``parent``/``offsets`` pick each sampling row's logits
        slot; with ``use_counts`` penalty counts are gathered from the
        device count planes by ``slot_rows`` and the sampled tokens
        scattered back (pad rows hit the trash row, hence
        ``accumulate=True``)."""
        tok_src = a["tok_src"].long()
        tokens = torch.where(tok_src >= 0, prev_tokens[tok_src.clamp(min=0)],
                             a["tokens"])
        logits = self._ragged_logits(tokens, a["pos"], a["page_tables"],
                                     a["contexts"], a["starts"],
                                     a["page_idx"], a["page_off"])
        rows = logits[a["parent"].long(), a["offsets"].long()][:, :vocab]
        slot_rows = a["slot_rows"].long()
        counts = (self.count_planes[slot_rows] if use_counts
                  else a["counts"])
        out = batched_sample(
            rows, a["seeds"], a["counters"], a["temperature"], a["top_k"],
            a["top_p"], a["min_p"], a["typical_p"], a["freq_pen"],
            a["pres_pen"], a["rep_pen"], a["bias"], counts, a["mask_bits"],
            n_top=n_top, use_planes=use_planes or use_counts,
            all_greedy=all_greedy, need_logprobs=need_logprobs)
        emit = batched_accept(out[0], a["draft_toks"], a["win_off"])
        if use_counts:
            self.count_planes.index_put_(
                (slot_rows, out[0].long()),
                torch.ones(slot_rows.shape[0], dtype=torch.float32,
                           device=self.device), accumulate=True)
        return out + (emit,)

    # -- host-side API ---------------------------------------------------
    def begin_seq(self, prompt_ids: List[int]) -> int:
        """Open a new sequence for chunked prefill of ``prompt_ids``,
        adopting the longest prefix already in the prefix cache (full
        pages shared in place, a partial tail page forked copy-on-write).
        At least one suffix token is always left uncached.  Returns
        seq_id; ``seq_len(sid)`` reports the tokens already in pages."""
        prompt_ids = [int(t) for t in prompt_ids]
        self.n_prefills += 1
        alloc = self.pm.new_seq()
        sid = alloc.seq_id
        cached = 0
        if self.prefix_cache is not None and len(prompt_ids) > 1:
            full_pages, tail = self.prefix_cache.match(prompt_ids[:-1])
            try:
                if full_pages:
                    self.pm.share_pages(sid, full_pages,
                                        len(full_pages) * self.page_size)
                if tail is not None:
                    src, n_tok = tail
                    dst = self.pm.fork_page(sid, n_tok)
                    self._copy_page(src, dst)
            except Exception:
                self.pm.free_seq(sid)
                raise
            cached = alloc.length
        self.last_prefill_info = {"prefix_cached_tokens": cached}
        self.seq_tokens[sid] = prompt_ids[:cached]
        return sid

    def seq_len(self, sid: int) -> int:
        """Tokens currently stored in the sequence's pages."""
        return self.pm.seqs[sid].length

    def _logits_to_host(self, logits: torch.Tensor) -> np.ndarray:
        """Pull logit rows ``[n, V]`` to the host as f32 (a blocking
        copy), counted by ``host_logit_rows``/``host_sync_bytes``."""
        out = logits.float().cpu().numpy()
        self.host_logit_rows += out.shape[0]
        self.host_sync_bytes += out.nbytes
        return out

    def prefill_chunk(self, sid: int, tokens: List[int]) -> np.ndarray:
        """Prefill up to ``chunk_size`` consecutive prompt tokens through
        the chunked-prefill kernel; a partial final chunk is padded to
        ``chunk_size`` (pad rows write to the trash page).  Raises
        :class:`OutOfPages` before mutating sequence state when the pool
        cannot back the chunk.  Returns the last valid token's logits
        ``[V]``."""
        tokens = [int(t) for t in tokens]
        T = len(tokens)
        C = self.chunk_size
        assert 0 < T <= C, (T, C)
        alloc = self.pm.seqs[sid]
        start = alloc.length
        need_pages = -(-(start + T) // self.page_size)
        if need_pages > self.pm.pages_per_seq:
            raise OutOfPages(f"seq {sid} at pages_per_seq cap")
        self.pm.require_pages(max(0, need_pages - len(alloc.pages)))
        self.pm.append_tokens(sid, T)
        pages = alloc.pages
        pos = (start + np.arange(C)).astype(np.int32)
        page_idx = np.full(C, self.trash_page, np.int32)
        page_idx[:T] = [pages[p // self.page_size] for p in pos[:T]]
        tok = np.zeros(C, np.int32)
        tok[:T] = tokens
        a = self._staging.upload(dict(
            tokens=tok, pos=pos, table=self.pm.page_table([sid])[0],
            ctx=np.array([start + T], np.int32),
            start=np.array([start], np.int32), page_idx=page_idx,
            page_off=(pos % self.page_size).astype(np.int32)))
        logits = self._chunk_logits(a)
        self.seq_tokens[sid].extend(tokens)
        self.n_prefill_chunks += 1
        self.n_prefill_tokens += T
        self.step_log.append(("chunk", T))
        out = self._logits_to_host(logits[T - 1:T])[0]
        self._last_logits_np = out
        return out

    def prefill_seq(self, prompt_ids: List[int]) -> int:
        """Prefill a whole prompt: ``begin_seq`` (prefix-cache adoption)
        then a loop of ``prefill_chunk`` over the uncached suffix.
        Returns seq_id; ``last_prefill_logits()`` has the final logits."""
        prompt_ids = [int(t) for t in prompt_ids]
        sid = self.begin_seq(prompt_ids)
        done = self.seq_len(sid)
        try:
            while done < len(prompt_ids):
                n = min(self.chunk_size, len(prompt_ids) - done)
                self.prefill_chunk(sid, prompt_ids[done:done + n])
                done += n
        except Exception:
            self.free(sid)
            raise
        return sid

    def last_prefill_logits(self) -> np.ndarray:
        return self._last_logits_np

    def decode(self, seq_tokens: Dict[int, int]) -> Dict[int, np.ndarray]:
        """One batched decode step for ``{seq_id: token}`` through the
        decode kernel; returns ``{seq_id: logits [V]}``."""
        sids = sorted(seq_tokens)
        B = len(sids)
        # capacity pre-check: fail *before* touching any sequence state so
        # the engine can preempt and retry without corrupted bookkeeping
        growing = sum(1 for s in sids
                      if self.pm.seqs[s].length % self.page_size == 0
                      and self.pm.seqs[s].length // self.page_size
                      == len(self.pm.seqs[s].pages))
        self.pm.require_pages(growing)
        for s in sids:
            if -(-(self.pm.seqs[s].length + 1) // self.page_size) \
                    > self.pm.pages_per_seq:
                raise OutOfPages(f"seq {s} at pages_per_seq cap")
        pos = self.pm.context_lens(sids)               # write position
        for sid in sids:
            self.pm.append_tokens(sid, 1)
        a = self._staging.upload(dict(
            tokens=np.array([[seq_tokens[s]] for s in sids], np.int32),
            pos=pos.astype(np.int32), table=self.pm.page_table(sids),
            lens=self.pm.context_lens(sids),           # incl. the new token
            page_idx=np.array([self.pm.seqs[s].pages[p // self.page_size]
                               for s, p in zip(sids, pos)], np.int32),
            page_off=(pos % self.page_size).astype(np.int32)))
        logits = self._decode_logits(a)
        for s in sids:
            if s in self.seq_tokens:
                self.seq_tokens[s].append(int(seq_tokens[s]))
        self.n_decode_steps += 1
        self.n_decode_tokens += B
        self.step_log.append(("decode", B))
        out = self._logits_to_host(logits)
        return {s: out[i] for i, s in enumerate(sids)}

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two — pads ragged (B, C) to a bounded set of
        step shapes."""
        b = 1
        while b < n:
            b *= 2
        return b

    def run_step(self, rows: List[Tuple[int, List[int], str]],
                 sampling: Optional[SamplingParamsBatch] = None,
                 n_top: int = 0, return_logits: bool = True,
                 materialize: bool = True,
                 prev: Optional[StepHandle] = None,
                 decode_srcs: Optional[Dict[int, int]] = None):
        """Execute one fused ragged step: ONE attention kernel launch per
        layer for a whole engine step's mixed decode + prefill work.

        ``rows`` holds one ``(sid, tokens, kind)`` entry per sequence
        (``kind`` "decode" or "prefill").  The batch is padded to a
        power-of-two ``(B, C)`` bucket (pad slots write K/V into the
        trash page; pad rows carry ``context=0``).  Raises
        :class:`OutOfPages` BEFORE any sequence state mutates when the
        pool cannot back every row.

        With ``sampling`` the step samples on the device and returns a
        :class:`SampleResult` (or, with ``materialize=False``, a
        :class:`StepHandle`); ``prev``/``decode_srcs`` feed decode rows
        their input token device-to-device from the previous handle.
        Without it, each row's last-valid-token logits return as ``{sid:
        [V] float32}`` (counted by ``host_logit_rows``), or nothing with
        ``return_logits=False``."""
        assert rows, "run_step needs at least one row"
        sids = [sid for sid, _, _ in rows]
        assert len(set(sids)) == len(sids), \
            "one ragged row per sequence — merge chunks before calling"
        # atomic capacity pre-check: fail before touching any state so
        # the engine can preempt and retry without corrupted bookkeeping
        total_new = 0
        for sid, toks, _ in rows:
            alloc = self.pm.seqs[sid]
            n = len(toks)
            assert n >= 1, (sid, toks)
            need = -(-(alloc.length + n) // self.page_size)
            if need > self.pm.pages_per_seq:
                raise OutOfPages(f"seq {sid} at pages_per_seq cap")
            total_new += max(0, need - len(alloc.pages))
        self.pm.require_pages(total_new)

        B = len(rows)
        Bb = self._bucket(B)
        Cb = self._bucket(max(len(toks) for _, toks, _ in rows))
        N = Bb * Cb
        tok = np.zeros(N, np.int32)
        tok_src = np.full(N, -1, np.int32)   # >= 0: take prev_tokens[src]
        pos = np.zeros(N, np.int32)
        page_idx = np.full(N, self.trash_page, np.int32)
        page_off = np.zeros(N, np.int32)
        page_tables = np.zeros((Bb, self.pm.pages_per_seq), np.int32)
        contexts = np.zeros(Bb, np.int32)    # pad rows: 0 -> kernel skips
        starts = np.zeros(Bb, np.int32)
        lengths = np.zeros(Bb, np.int32)
        for b, (sid, toks, _) in enumerate(rows):
            alloc = self.pm.seqs[sid]
            start = alloc.length
            n = len(toks)
            self.pm.append_tokens(sid, n)
            pages = alloc.pages
            rp = start + np.arange(Cb)
            o = b * Cb
            tok[o:o + n] = toks
            pos[o:o + Cb] = rp
            page_idx[o:o + n] = [pages[p // self.page_size]
                                 for p in rp[:n]]
            page_off[o:o + Cb] = rp % self.page_size
            page_tables[b, :len(pages)] = pages
            contexts[b] = start + n
            starts[b] = start
            lengths[b] = n
            if decode_srcs and b in decode_srcs:
                # device-fed rows carry their placeholder at offset 0
                tok_src[o] = decode_srcs[b]
        attn = dict(tokens=tok, tok_src=tok_src, pos=pos,
                    page_tables=page_tables, contexts=contexts,
                    starts=starts, page_idx=page_idx, page_off=page_off)
        if sampling is not None:
            if sampling.offsets is None:
                # default: every sampling row draws from its parent
                # row's LAST valid slot
                row_last = np.array([len(t) - 1 for _, t, _ in rows],
                                    np.int32)
                sampling.offsets = row_last[sampling.parent]
            sampled = self._dispatch_sampled(sampling, n_top, attn, prev)
        else:
            assert prev is None and not decode_srcs, \
                "device-fed tokens need the fused sampled path"
            a = self._staging.upload(attn)
            logits = self._ragged_logits(
                a["tokens"], a["pos"], a["page_tables"], a["contexts"],
                a["starts"], a["page_idx"], a["page_off"])
            if return_logits:
                last = torch.from_numpy(
                    np.clip(lengths - 1, 0, Cb - 1).astype(np.int64)
                ).to(self.device)
                out = self._logits_to_host(
                    logits[torch.arange(B, device=self.device), last[:B]])
        n_dec = n_pf = 0
        result: Dict[int, np.ndarray] = {}
        for b, (sid, toks, kind) in enumerate(rows):
            if sid in self.seq_tokens:
                if decode_srcs and b in decode_srcs:
                    prev.backfill(sid, len(self.seq_tokens[sid]),
                                  decode_srcs[b])
                self.seq_tokens[sid].extend(int(t) for t in toks)
            if kind == "decode":
                n_dec += 1
                self.n_decode_tokens += len(toks)
            else:
                n_pf += len(toks)
                self.n_prefill_tokens += len(toks)
            if sampling is None and return_logits:
                result[sid] = out[b]
        self.n_ragged_steps += 1
        self.step_log.append(("ragged", n_dec, n_pf))
        if sampling is not None:
            return sampled.materialize() if materialize else sampled
        return result

    def _dispatch_sampled(self, sampling: SamplingParamsBatch, n_top: int,
                          attn: Dict[str, np.ndarray],
                          prev: Optional[StepHandle] = None) -> StepHandle:
        """Enqueue the fused attention+sampling step WITHOUT blocking and
        return a :class:`StepHandle` over its on-device outputs.

        Sampling rows are padded to at least the FIXED ``_s_rows``
        bucket (pad rows sample greedily from attention row 0, scatter
        their count update into the trash plane row, and are dropped),
        so the on-device token array keeps one shape the next step can
        gather its decode inputs from."""
        S = len(sampling)
        assert S >= 1, "sampled step needs at least one sampling row"
        Sb = max(self._s_rows, self._bucket(S))

        def pad(a, fill=0):
            out = np.empty((Sb,) + a.shape[1:], a.dtype)
            out[:S] = a
            out[S:] = fill
            return out

        if sampling.use_counts:
            self._ensure_planes(sampling.vocab)
        if sampling.slot_ids is not None:
            slot_rows = np.where(sampling.slot_ids < 0, self.max_slots,
                                 sampling.slot_ids).astype(np.int32)
        else:
            slot_rows = np.zeros(S, np.int32)
        if prev is not None:
            prev_tok = prev.tokens
        else:
            prev_tok = self._zero_prev.get(self._s_rows)
            if prev_tok is None:
                prev_tok = self._zero_prev[self._s_rows] = torch.zeros(
                    self._s_rows, dtype=torch.int32, device=self.device)
        Bb = attn["page_tables"].shape[0]
        Cb = attn["tokens"].shape[0] // Bb
        self._seen_buckets.add(
            (Bb, Cb, Sb, int(prev_tok.shape[0]), n_top,
             sampling.use_planes, sampling.use_counts,
             sampling.all_greedy, sampling.need_logprobs))
        arrays = dict(attn)
        arrays.update(
            parent=pad(sampling.parent.astype(np.int32)),
            offsets=pad(sampling.offsets.astype(np.int32)),
            # uint32 seeds and mask words travel as their int32 bit
            # patterns; the sampler masks them back to 32 bits
            seeds=pad(sampling.seeds.astype(np.uint32).view(np.int32)),
            counters=pad(sampling.counters.astype(np.int32)),
            temperature=pad(sampling.temperature),
            top_k=pad(sampling.top_k.astype(np.int32)),
            top_p=pad(sampling.top_p),
            min_p=pad(sampling.min_p),
            typical_p=pad(sampling.typical_p, 1),
            freq_pen=pad(sampling.freq_pen),
            pres_pen=pad(sampling.pres_pen),
            rep_pen=pad(sampling.rep_pen),
            bias=pad(sampling.bias.astype(np.float32)),
            counts=pad(sampling.counts.astype(np.float32)),
            slot_rows=pad(slot_rows, self.max_slots),
            mask_bits=pad(sampling.mask_bits.astype(np.uint32)
                          .view(np.int32), -1),
            draft_toks=pad(sampling.draft_toks.astype(np.int32), -1),
            win_off=pad(sampling.win_off.astype(np.int32)))
        a = self._staging.upload(arrays)
        token, lp, top_ids, top_lps, emit = self._ragged_sample_step(
            a, prev_tok, vocab=sampling.vocab, n_top=n_top,
            use_planes=sampling.use_planes, all_greedy=sampling.all_greedy,
            need_logprobs=sampling.need_logprobs,
            use_counts=sampling.use_counts)
        self.n_sampled_tokens += S
        return StepHandle(tokens=token, logprob=lp, top_ids=top_ids,
                          top_lps=top_lps, n_rows=S, runner=self, emit=emit)

    def fork_seq(self, src_sid: int) -> int:
        """Copy-on-write fork of a live sequence: full pages shared in
        place (+1 refcount), the partially filled tail page copied.
        Returns the new seq_id."""
        src = self.pm.seqs[src_sid]
        alloc = self.pm.new_seq()
        sid = alloc.seq_id
        n_full = src.length // self.page_size
        tail = src.length - n_full * self.page_size
        try:
            if n_full:
                self.pm.share_pages(sid, src.pages[:n_full],
                                    n_full * self.page_size)
            if tail:
                dst = self.pm.fork_page(sid, tail)
                self._copy_page(src.pages[n_full], dst)
        except Exception:
            self.pm.free_seq(sid)
            raise
        self.seq_tokens[sid] = list(
            self.seq_tokens.get(src_sid, ()))[:src.length]
        self.n_forks += 1
        return sid

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page's K/V payload (values AND dequant
        scales, when quantized) across every layer, in place."""
        for pool in (self.k_pages, self.v_pages, self.k_scales,
                     self.v_scales):
            if pool is not None:
                pool[:, dst].copy_(pool[:, src])

    def rewind_tokens(self, sid: int, n: int = 1):
        """Un-append the last ``n`` tokens of a live sequence (lag-1
        pipelined finish rewind, or the rejected tail of a speculative
        verify window): drops them from ``seq_tokens`` and rolls the
        page cursor back, releasing a now-empty trailing page.  The
        caller must have materialized every in-flight step that
        scatters into this sequence first: all work is ordered on one
        stream, so a released page's stale write lands before any later
        step's write to it."""
        toks = self.seq_tokens.get(sid)
        if toks is not None and n:
            del toks[len(toks) - n:]
        self.pm.rewind_tokens(sid, n)
        self.n_rewinds += 1

    # -- device-resident penalty count planes ---------------------------
    def _ensure_planes(self, vocab: int):
        if self._plane_vocab != vocab:
            self.count_planes = torch.zeros(
                (self.max_slots + 1, vocab), dtype=torch.float32,
                device=self.device)
            self._plane_vocab = vocab

    def seed_counts(self, row: int, counts, vocab: int):
        """Overwrite count-plane row ``row`` from a host ``{token:
        count}`` mapping (a penalty-bearing request binding a slot)."""
        self._ensure_planes(vocab)
        vals = np.zeros(vocab, np.float32)
        for t, c in counts.items():
            if 0 <= t < vocab:
                vals[t] = c
        self.count_planes[row] = torch.from_numpy(vals).to(self.device)

    # -- warmup -----------------------------------------------------------
    def warmup(self, vocab: int, buckets=None,
               greedy=(False, True), draft_k: int = 0) -> int:
        """Run the fused sampled step once per common ``(B, C)`` bucket on
        all-pad inputs (contexts 0, K/V into the trash page, greedy
        throwaway samples), so first-use costs (kernel library build,
        allocator growth, library handles) stop landing on the first
        request's TTFT.  No sequence state, page content, or step
        counter is touched.  Buckets follow the reference's list (see
        ``repro.core.paged_runner.PagedModelRunner.warmup``); returns
        the number of shapes run."""
        ms = max(1, self.max_slots)
        sb = self._bucket(ms)
        if buckets is None:
            cb = self._bucket(max(1, self.chunk_size))
            buckets = [(1, 1), (sb, 1), (sb, cb), (1, cb)]
            if draft_k > 0:
                w = 1 + draft_k
                sd = self._bucket(ms * w)
                buckets += [(sb, self._bucket(w), ms * w),
                            (1, self._bucket(w), w),
                            (sb, 1, ms, sd), (1, 1, 1, sd)]
                wb = 2
                while wb < self._bucket(w):
                    buckets.append((1, wb, wb))
                    wb *= 2
        words = -(-vocab // 32)
        ran = 0
        norm = [(bk[0], bk[1],
                 max(self._s_rows,
                     self._bucket(bk[2])) if len(bk) > 2 else self._s_rows,
                 max(self._s_rows,
                     self._bucket(bk[3])) if len(bk) > 3 else None)
                for bk in buckets]
        for Bb, Cb, Sb, Pb in dict.fromkeys(norm):
            if Pb is None:
                Pb = self._s_rows
            N = Bb * Cb
            i32 = lambda n, v=0: np.full(n, v, np.int32)  # noqa: E731
            f32 = lambda n, v=0.0: np.full(n, v, np.float32)  # noqa: E731
            arrays = dict(
                tokens=i32(N), tok_src=i32(N, -1), pos=i32(N),
                page_tables=np.zeros((Bb, self.pm.pages_per_seq), np.int32),
                contexts=i32(Bb), starts=i32(Bb),
                page_idx=i32(N, self.trash_page), page_off=i32(N),
                parent=i32(Sb), offsets=i32(Sb), seeds=i32(Sb),
                counters=i32(Sb), temperature=f32(Sb), top_k=i32(Sb),
                top_p=f32(Sb), min_p=f32(Sb), typical_p=f32(Sb, 1.0),
                freq_pen=f32(Sb), pres_pen=f32(Sb), rep_pen=f32(Sb),
                bias=np.zeros((Sb, 1), np.float32),
                counts=np.zeros((Sb, 1), np.float32),
                slot_rows=i32(Sb, self.max_slots),
                mask_bits=np.full((Sb, words), -1, np.int32),
                draft_toks=i32(Sb, -1), win_off=i32(Sb))
            prev = torch.zeros(Pb, dtype=torch.int32, device=self.device)
            for all_greedy in greedy:
                key = (Bb, Cb, Sb, Pb, 0, False, False,
                       bool(all_greedy), False)
                if key in self._seen_buckets:
                    continue
                a = self._staging.upload(arrays)
                self._ragged_sample_step(
                    a, prev, vocab=vocab, n_top=0, use_planes=False,
                    all_greedy=bool(all_greedy), need_logprobs=False,
                    use_counts=False)
                self._seen_buckets.add(key)
                ran += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # charged to warmup
        self.n_warmup_compiles += ran
        return ran

    def free(self, seq_id: int, publish: bool = False):
        """Release a sequence; with ``publish=True`` (and the prefix cache
        on) its pages are first inserted into the cache.  A sequence
        freed mid-prefill publishes exactly the chunks completed so
        far."""
        tokens = self.seq_tokens.pop(seq_id, None)
        if (publish and self.prefix_cache is not None and tokens
                and len(tokens) == self.pm.seqs[seq_id].length):
            self.prefix_cache.insert(tokens, self.pm.seqs[seq_id].pages)
        self.pm.free_seq(seq_id)

    def stats(self) -> dict:
        """Runner counters.  ``attn_kernel_calls`` counts attention
        dispatches (fused ragged steps + per-kind chunk and decode
        calls); the engine path issues exactly one per step."""
        out = {"pages": self.pm.stats(),
               "device": str(self.device),
               "kv_dtype": self.kv_dtype,
               "weight_quant": self.weight_quant,
               "page_bytes": self.page_bytes,
               "prefills": self.n_prefills,
               "forks": self.n_forks,
               "chunk_size": self.chunk_size,
               "prefill_chunks": self.n_prefill_chunks,
               "prefill_tokens": self.n_prefill_tokens,
               "decode_steps": self.n_decode_steps,
               "decode_tokens": self.n_decode_tokens,
               "ragged_steps": self.n_ragged_steps,
               "sampled_tokens": self.n_sampled_tokens,
               "host_logit_rows": self.host_logit_rows,
               "host_sync_bytes": self.host_sync_bytes,
               "host_block_s": self.t_block_s,
               "jit_buckets": len(self._seen_buckets),
               "warmup_compiles": self.n_warmup_compiles,
               "rewinds": self.n_rewinds,
               "attn_kernel_calls": (self.n_ragged_steps
                                     + self.n_prefill_chunks
                                     + self.n_decode_steps)}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out


class PagedEngineBackend:
    """Slot-keyed facade over :class:`PagedModelRunner` (port of the
    reference class of the same name): maps engine slots onto paged
    seq_ids, publishes finished (and preempted-mid-prefill) sequences
    into the prefix cache, frees aborted ones without publishing, and
    dispatches whole step plans as fused ragged steps."""

    supports_chunked_prefill = True
    supports_ragged_step = True

    def __init__(self, cfg: ModelConfig, params=None, *, max_slots: int = 4,
                 max_context: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None, seed: int = 0,
                 enable_prefix_cache: bool = True, chunk_size: int = 16,
                 max_cached_pages: Optional[int] = None,
                 max_cached_bytes: Optional[int] = None,
                 kv_dtype: str = "f32", weight_quant: str = "off",
                 device=None):
        pages_per_seq = -(-max_context // page_size)
        if num_pages is None:
            # room for every slot at full context plus cache headroom
            num_pages = (max_slots + 2) * pages_per_seq
        self.runner = PagedModelRunner(
            cfg, params, num_pages=num_pages, page_size=page_size,
            max_slots=max_slots, pages_per_seq=pages_per_seq, seed=seed,
            enable_prefix_cache=enable_prefix_cache, chunk_size=chunk_size,
            max_cached_pages=max_cached_pages,
            max_cached_bytes=max_cached_bytes,
            kv_dtype=kv_dtype, weight_quant=weight_quant, device=device)
        self.cfg = cfg
        self.max_context = max_context
        self.max_slots = max_slots
        self.chunk_size = chunk_size
        self.pm = self.runner.pm
        self.prefix_cache = self.runner.prefix_cache
        self._slot_seq: Dict[int, int] = {}

    @property
    def last_prefill_info(self) -> Dict[str, int]:
        return self.runner.last_prefill_info

    def prefill(self, slot: int, prompt_ids: List[int],
                embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-prompt prefill (a loop of chunks) for callers that do
        not interleave; the engine uses the chunked calls."""
        assert embeds is None, "paged backend: vision embeds unsupported"
        assert slot not in self._slot_seq, f"slot {slot} already bound"
        sid = self.runner.prefill_seq(prompt_ids)
        self._slot_seq[slot] = sid
        return self.runner.last_prefill_logits()

    def begin_prefill(self, slot: int, prompt_ids: List[int]) -> int:
        """Open ``slot`` for chunked prefill; adopts the longest cached
        prefix and returns how many leading tokens are already in pages."""
        assert slot not in self._slot_seq, f"slot {slot} already bound"
        sid = self.runner.begin_seq(prompt_ids)
        self._slot_seq[slot] = sid
        return self.runner.seq_len(sid)

    def prefill_chunk(self, slot: int, tokens: List[int]) -> np.ndarray:
        """Append one chunk of prompt tokens to ``slot``'s sequence;
        returns the last token's logits."""
        return self.runner.prefill_chunk(self._slot_seq[slot], tokens)

    def run_step(self, rows: List[Tuple[int, List[int], str]],
                 sampling: Optional[SamplingParamsBatch] = None,
                 n_top: int = 0, return_logits: bool = True,
                 materialize: bool = True, prev=None,
                 decode_srcs: Optional[Dict[int, int]] = None):
        """Fused plan execution over ``(slot, tokens, kind)`` rows (see
        :meth:`PagedModelRunner.run_step`)."""
        out = self.runner.run_step(
            [(self._slot_seq[slot], toks, kind)
             for slot, toks, kind in rows],
            sampling=sampling, n_top=n_top, return_logits=return_logits,
            materialize=materialize, prev=prev, decode_srcs=decode_srcs)
        if sampling is not None or not return_logits:
            return out
        return {slot: out[self._slot_seq[slot]] for slot, _, _ in rows}

    def seed_counts(self, slot: int, counts, vocab: int):
        """Seed the device count-plane row for ``slot`` (engine slots
        double as plane rows)."""
        self.runner.seed_counts(slot, counts, vocab)

    def rewind_token(self, slot: int, n: int = 1):
        """Lag-``n`` rewind of ``slot``'s last ``n`` tokens."""
        self.runner.rewind_tokens(self._slot_seq[slot], n)

    def warmup(self, vocab: int, draft_k: int = 0) -> int:
        return self.runner.warmup(vocab, draft_k=draft_k)

    def fork_slot(self, src_slot: int, dst_slot: int):
        """CoW-fork ``src_slot``'s sequence into ``dst_slot``."""
        assert dst_slot not in self._slot_seq, \
            f"slot {dst_slot} already bound"
        self._slot_seq[dst_slot] = self.runner.fork_seq(
            self._slot_seq[src_slot])

    def decode(self, tokens_by_slot: Dict[int, int],
               pos_by_slot: Dict[int, int]) -> Dict[int, np.ndarray]:
        del pos_by_slot                    # positions tracked by PageManager
        seq_tok = {self._slot_seq[s]: t for s, t in tokens_by_slot.items()}
        out = self.runner.decode(seq_tok)
        return {s: out[self._slot_seq[s]] for s in tokens_by_slot}

    def release(self, slot: int, publish: bool = True):
        sid = self._slot_seq.pop(slot, None)
        if sid is not None:
            self.runner.free(sid, publish=publish)

    def stats(self) -> dict:
        return self.runner.stats()
