"""Fused int4-dequant GEMM (W4A16): the CUDA kernel and its plain
PyTorch version.

Port of ``src/repro/kernels/w4a16_gemm.py::w4a16_gemm`` (the Pallas
``_kernel``); the CUDA source is ``csrc/w4a16_gemm.cu``.

    x        [M, K]   bf16
    w_packed [K/2, N] int8   (low nibble = even k, high = odd k, signed)
    scales   [K/G, N] bf16   (per-(group, column) symmetric scales)
    out      [M, N]   bf16

In the TPU kernel's order: unpack the signed nibbles, multiply by the
group scale in f32, round the weight to bf16 (so it equals
``QTensor.dequant()``), accumulate ``x @ w`` in f32, store bf16.  A CPU
tensor takes :func:`w4a16_gemm_plain`; a CUDA tensor launches the kernel
or raises.  The kernel takes any M; it needs ``K % 64 == 0``,
``N % 16 == 0``, ``K % group == 0`` and a group in ``SUPPORTED_GROUPS``
(the serving shapes (K, N) of Llama-3.1-8B, (4096, 4096), (4096, 1024),
(4096, 14336) and (14336, 4096), all qualify, and so do its reduced
widths).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (plain integer)
launches = 0

SUPPORTED_GROUPS = (16, 32, 64, 128)
_K_STEP = 64          # the kernel's K tile
_N_VEC = 16           # columns per 16-byte load of packed weights


def unpack_dequant(w_packed: torch.Tensor, scales: torch.Tensor,
                   group: int) -> torch.Tensor:
    """bf16 ``[K, N]``: ``bf16(nibble * scale)`` computed in f32."""
    d = w_packed.to(torch.int16)
    low = ((d & 0x0F) ^ 0x08) - 0x08
    high = d >> 4
    K2, N = w_packed.shape
    q = torch.stack([low, high], dim=1).reshape(2 * K2 // group, group, N)
    w = q.float() * scales.float()[:, None, :]
    return w.reshape(2 * K2, N).to(torch.bfloat16)


def w4a16_gemm_plain(x: torch.Tensor, w_packed: torch.Tensor,
                     scales: torch.Tensor, group: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops (any device)."""
    w = unpack_dequant(w_packed, scales, group)
    return (x.float() @ w.float()).to(torch.bfloat16)


def _check_cuda(x, w_packed, scales, group):
    if x.dim() != 2 or w_packed.dim() != 2 or scales.dim() != 2:
        raise ValueError("w4a16_gemm takes x [M, K], w_packed [K/2, N], "
                         "scales [K/G, N]")
    M, K = x.shape
    K2, N = w_packed.shape
    for name, t, dt in (("x", x, torch.bfloat16),
                        ("w_packed", w_packed, torch.int8),
                        ("scales", scales, torch.bfloat16)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if group not in SUPPORTED_GROUPS:
        raise ValueError(f"kernel built for group in {SUPPORTED_GROUPS}; "
                         f"got group={group}")
    if K != 2 * K2 or K % group or tuple(scales.shape) != (K // group, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scales "
                         f"{tuple(scales.shape)}, group {group}")
    if K % _K_STEP or N % _N_VEC:
        raise ValueError(f"kernel needs K % {_K_STEP} == 0 and N % "
                         f"{_N_VEC} == 0; got K={K}, N={N}")


def w4a16_gemm(x: torch.Tensor, w_packed: torch.Tensor,
               scales: torch.Tensor, *, group: int = 64) -> torch.Tensor:
    """``x @ dequant(w)`` in bf16; the CUDA kernel for CUDA tensors."""
    global launches
    if x.device.type == "cpu":
        return w4a16_gemm_plain(x, w_packed, scales, group)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_gemm: unsupported device {x.device}")
    _check_cuda(x, w_packed, scales, group)
    M, K = x.shape
    N = w_packed.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    status = _build.lib().w4a16_gemm_bf16(
        x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        M, N, K, group, _build.stream_ptr(x.device))
    _build.check(status, "w4a16_gemm_bf16")
    launches += 1
    return out
