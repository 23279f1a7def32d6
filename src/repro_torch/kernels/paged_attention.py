"""Ragged multi-sequence paged attention (bf16 pages): the CUDA kernel
and its plain PyTorch version.

Port of ``src/repro/kernels/paged_attention.py::paged_ragged_attention``
(the Pallas ``_ragged_kernel``) and of its oracle
``src/repro/kernels/ref.py::paged_ragged_attention_ref``; the CUDA source
is ``csrc/paged_ragged_attention.cu``.  One call covers a whole engine
step: row ``b`` of ``q [B, C, H, D]`` holds up to C consecutive query
tokens of one sequence starting at global position ``starts[b]``, and
attends to its own ``page_tables[b]`` with keys masked to ``t <
contexts[b]`` and ``t <= starts[b] + c``.  GQA head ``h`` reads kv-head
``h // (H // Kv)``.  Rows with ``contexts[b] == 0`` (batch padding)
output zeros; chunk pad slots output garbage the caller ignores.

The int8 form of the TPU kernel (``k_scales``/``v_scales``) is not
ported yet (ROADMAP A1).  A CPU tensor takes
:func:`paged_ragged_attention_plain`; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches since the last reset (plain integer)
launches = 0

_SUPPORTED_D = (64, 128)
_SUPPORTED_PAGE = (8, 16)


def paged_ragged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_tables: torch.Tensor,
                                 contexts: torch.Tensor,
                                 starts: torch.Tensor, *,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Gather every row's pages and run masked softmax attention in f32
    (the ``paged_ragged_attention_ref`` math, any device)."""
    B, C, H, D = q.shape
    _, page_size, Kv, _ = k_pages.shape
    pps = page_tables.shape[1]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    T = pps * page_size
    pt = page_tables.long()
    k = k_pages[pt].reshape(B, T, Kv, D).float()
    v = v_pages[pt].reshape(B, T, Kv, D).float()
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


def _check_cuda(q, k_pages, v_pages, page_tables, contexts, starts):
    B, C, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must be [P, page_size, Kv, D]")
    _, page_size, Kv, Dk = k_pages.shape
    if Dk != D or H % Kv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if D not in _SUPPORTED_D or page_size not in _SUPPORTED_PAGE:
        raise ValueError(f"kernel built for D in {_SUPPORTED_D} and "
                         f"page_size in {_SUPPORTED_PAGE}; got D={D}, "
                         f"page_size={page_size}")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("page_tables", page_tables, torch.int32),
                        ("contexts", contexts, torch.int32),
                        ("starts", starts, torch.int32)):
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


def paged_ragged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           contexts: torch.Tensor, starts: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Ragged paged attention; the CUDA kernel for CUDA tensors."""
    global launches
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(q, k_pages, v_pages, page_tables,
                                            contexts, starts, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_ragged_attention: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k_pages, v_pages, page_tables, contexts, starts)
    B, C, H, D = q.shape
    _, page_size, Kv, _ = k_pages.shape
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device)
    sB, sC, sH, _ = q.stride()
    status = _build.lib().paged_ragged_attention_bf16(
        q.data_ptr(), sB, sC, sH, k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), contexts.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, C, H, Kv, D, page_size, page_tables.shape[1],
        float(scale), _build.stream_ptr(q.device))
    _build.check(status, "paged_ragged_attention_bf16")
    launches += 1
    return out
