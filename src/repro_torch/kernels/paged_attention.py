"""Paged attention over a paged KV cache — bf16 or int8 pages: the CUDA
kernel and the plain PyTorch versions, for the three entry points of
``src/repro/kernels/paged_attention.py``.

* :func:`paged_ragged_attention` ports ``paged_ragged_attention`` (the
  Pallas ``_ragged_kernel``; oracle ``ref.py::paged_ragged_attention_ref``).
  One call covers a whole engine step: row ``b`` of ``q [B, C, H, D]``
  holds up to C consecutive query tokens of one sequence starting at
  global position ``starts[b]``, and attends to its own
  ``page_tables[b]`` with keys masked to ``t < contexts[b]`` and ``t <=
  starts[b] + c``.  GQA head ``h`` reads kv-head ``h // (H // Kv)``.
  Rows with ``contexts[b] == 0`` (batch padding) output zeros; chunk pad
  slots output garbage the caller ignores.
* :func:`paged_attention` ports the decode kernel (``_kernel``; oracle
  ``paged_attention_ref``): one token per sequence, ``q [B, H, D]``,
  keys ``t < context_lens[b]``.
* :func:`paged_prefill_attention` ports the chunked-prefill kernel
  (``_prefill_kernel``; oracle ``paged_prefill_attention_ref``): one
  sequence's chunk ``q [C, H, D]`` at ``start``, keys ``t < context`` and
  causal inside the chunk.

All three run one CUDA kernel, ``csrc/paged_ragged_attention.cu``: decode
is the ragged computation with C = 1 and ``starts = context_lens - 1``,
prefill the ragged one with B = 1.  Their index tensors are built on the
device (no host sync).  With ``k_scales``/``v_scales`` (``[P, page_size,
Kv]`` bf16) the pools hold int8 values and each page is dequantized
(value * scale, f32) inside the kernel's page loop, never materialized.

A CPU tensor takes the ``*_plain`` version; a CUDA tensor launches the
kernel or raises.  Each entry point counts its own launches: ``launches``
(ragged, bf16 pages), ``launches_int8`` (ragged, int8 pages),
``decode_launches`` and ``prefill_launches`` (both page types).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches since the last reset (plain integers), per entry point
launches = 0
launches_int8 = 0
decode_launches = 0
prefill_launches = 0

_SUPPORTED_D = (64, 128)
_SUPPORTED_PAGE = (8, 16)


def _gather(pages: torch.Tensor, scales: Optional[torch.Tensor],
            tables: torch.Tensor) -> torch.Tensor:
    """``pages[tables]`` flattened to ``[B, T, Kv, D]`` f32, dequantized by
    the per-(token, kv-head) ``scales`` when given (``_dequant_gather``)."""
    B, pps = tables.shape
    _, page_size, Kv, D = pages.shape
    pt = tables.long()
    out = pages[pt].reshape(B, pps * page_size, Kv, D).float()
    if scales is not None:
        s = scales[pt].reshape(B, pps * page_size, Kv).float()
        out = out * s[..., None]
    return out


def paged_ragged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_tables: torch.Tensor,
                                 contexts: torch.Tensor,
                                 starts: torch.Tensor, *,
                                 k_scales: Optional[torch.Tensor] = None,
                                 v_scales: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Gather every row's pages (dequantized in f32 for int8 pools) and
    run masked softmax attention in f32 (the
    ``paged_ragged_attention_ref`` math, any device)."""
    B, C, H, D = q.shape
    Kv = k_pages.shape[2]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    k = _gather(k_pages, k_scales, page_tables)
    v = _gather(v_pages, v_scales, page_tables)
    T = k.shape[1]
    qf = q.reshape(B, C, Kv, G, D).float()
    scores = torch.einsum("bckgd,btkd->bckgt", qf, k) * scale
    t = torch.arange(T, device=q.device)[None, None, :]
    qpos = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (t < contexts.long()[:, None, None]) & (t <= qpos[..., None])
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    # fully masked rows (batch padding, contexts == 0) -> zeros
    p = p * mask.any(-1)[:, :, None, None, None]
    out = torch.einsum("bckgt,btkd->bckgd", p, v)
    return out.reshape(B, C, H, D).to(q.dtype)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          context_lens: torch.Tensor, *,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode: ``q [B, H, D]`` over keys ``t < context_lens[b]`` (the
    ``paged_attention_ref`` math: the ragged mask with C = 1 at position
    ``context_lens - 1``)."""
    return paged_ragged_attention_plain(
        q[:, None], k_pages, v_pages, page_table, context_lens,
        context_lens - 1, k_scales=k_scales, v_scales=v_scales,
        scale=scale)[:, 0]


def paged_prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  page_table: torch.Tensor, context, start,
                                  *, k_scales: Optional[torch.Tensor] = None,
                                  v_scales: Optional[torch.Tensor] = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """One sequence's chunk ``q [C, H, D]`` at ``start`` over keys ``t <
    context`` and ``t <= start + c`` (the ``paged_prefill_attention_ref``
    math: the ragged mask with B = 1)."""
    ctx = _scalar(context, q.device)
    st = _scalar(start, q.device)
    return paged_ragged_attention_plain(
        q[None], k_pages, v_pages, page_table[None], ctx, st,
        k_scales=k_scales, v_scales=v_scales, scale=scale)[0]


def _scalar(x: Union[int, torch.Tensor], device) -> torch.Tensor:
    """A scalar index as a ``[1]`` int32 tensor on ``device`` (a fill for
    a Python int, a view for a tensor: no host round trip)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(torch.int32)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def _check_cuda(q, k_pages, v_pages, k_scales, v_scales, page_tables,
                contexts, starts):
    B, C, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must be [P, page_size, Kv, D]")
    P, page_size, Kv, Dk = k_pages.shape
    if Dk != D or H % Kv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if D not in _SUPPORTED_D or page_size not in _SUPPORTED_PAGE:
        raise ValueError(f"kernel built for D in {_SUPPORTED_D} and "
                         f"page_size in {_SUPPORTED_PAGE}; got D={D}, "
                         f"page_size={page_size}")
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    page_dt = torch.int8 if quant else torch.bfloat16
    operands = [("q", q, torch.bfloat16), ("k_pages", k_pages, page_dt),
                ("v_pages", v_pages, page_dt),
                ("page_tables", page_tables, torch.int32),
                ("contexts", contexts, torch.int32),
                ("starts", starts, torch.int32)]
    if quant:
        operands += [("k_scales", k_scales, torch.bfloat16),
                     ("v_scales", v_scales, torch.bfloat16)]
        if tuple(k_scales.shape) != (P, page_size, Kv) or \
                k_scales.shape != v_scales.shape:
            raise ValueError("k_scales/v_scales must be [P, page_size, Kv]")
    for name, t, dt in operands:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError("page_tables must be [B, pages_per_seq]")
    if tuple(contexts.shape) != (B,) or tuple(starts.shape) != (B,):
        raise ValueError("contexts and starts must be [B]")
    if q.stride(-1) != 1 or any(s % 2 for s in q.stride()[:3]) \
            or q.data_ptr() % 4:
        raise ValueError("q needs unit stride in D, even strides elsewhere "
                         "and 4-byte alignment")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must be 16-byte aligned")


def _launch(q, k_pages, v_pages, page_tables, contexts, starts, k_scales,
            v_scales, scale) -> torch.Tensor:
    """Check the operands and launch the ragged kernel (bf16 or int8
    pages) on the current stream; the caller counts the launch."""
    _check_cuda(q, k_pages, v_pages, k_scales, v_scales, page_tables,
                contexts, starts)
    B, C, H, D = q.shape
    _, page_size, Kv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device)
    sB, sC, sH, _ = q.stride()
    lib = _build.lib()
    tail = (page_tables.data_ptr(), contexts.data_ptr(), starts.data_ptr(),
            out.data_ptr(), B, C, H, Kv, D, page_size, page_tables.shape[1],
            float(scale), _build.stream_ptr(q.device))
    if k_scales is None:
        name = "paged_ragged_attention_bf16"
        status = lib.paged_ragged_attention_bf16(
            q.data_ptr(), sB, sC, sH, k_pages.data_ptr(), v_pages.data_ptr(),
            *tail)
    else:
        name = "paged_ragged_attention_int8"
        status = lib.paged_ragged_attention_int8(
            q.data_ptr(), sB, sC, sH, k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), *tail)
    _build.check(status, name)
    return out


def _device_check(q, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def paged_ragged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           contexts: torch.Tensor, starts: torch.Tensor, *,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Ragged paged attention ``[B, C, H, D]``; the CUDA kernel for CUDA
    tensors (int8 pages with ``k_scales``/``v_scales``)."""
    global launches, launches_int8
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(
            q, k_pages, v_pages, page_tables, contexts, starts,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    _device_check(q, "paged_ragged_attention")
    out = _launch(q, k_pages, v_pages, page_tables, contexts, starts,
                  k_scales, v_scales, scale)
    if k_scales is None:
        launches += 1
    else:
        launches_int8 += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention ``[B, H, D]`` over the paged cache; on the card the
    ragged kernel with C = 1 and ``starts = context_lens - 1``."""
    global decode_launches
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     context_lens, k_scales=k_scales,
                                     v_scales=v_scales, scale=scale)
    _device_check(q, "paged_attention")
    out = _launch(q[:, None], k_pages, v_pages, page_table, context_lens,
                  context_lens - 1, k_scales, v_scales, scale)
    decode_launches += 1
    return out[:, 0]


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            context, start, *,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention ``[C, H, D]`` for one sequence
    (``context``/``start``: ints or one-element int32 tensors); on the
    card the ragged kernel with B = 1."""
    global prefill_launches
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, page_table, context, start,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    _device_check(q, "paged_prefill_attention")
    out = _launch(q[None], k_pages, v_pages, page_table[None],
                  _scalar(context, q.device), _scalar(start, q.device),
                  k_scales, v_scales, scale)
    prefill_launches += 1
    return out[0]
