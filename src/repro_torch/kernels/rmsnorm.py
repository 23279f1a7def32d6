"""Row RMSNorm (optional residual add first): the CUDA kernel and its
plain PyTorch version.

Port of the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py`` (``_kernel``
and ``_kernel_res``); the CUDA source is ``csrc/rmsnorm.cu``.

    x [..., D] bf16, scale [D] f32 (, residual [..., D]) -> [..., D] bf16

Statistics are f32; the output is ``norm(x [+ residual]) * scale`` cast
back to x's dtype.  A tensor on the CPU takes :func:`rmsnorm_plain`; a
CUDA tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (a plain integer; the smoke
#: script zeroes it before driving the serving path)
launches = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch ops (any device)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _check_cuda(x, scale, residual):
    D = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rmsnorm kernel takes bf16 x, got {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (D,):
        raise TypeError(f"rmsnorm kernel takes f32 scale [{D}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if D % 8:
        raise ValueError(f"rmsnorm kernel needs D % 8 == 0, got D={D}")
    tensors = [x, scale] + ([residual] if residual is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("rmsnorm operands on different devices")
        if not t.is_contiguous():
            raise ValueError("rmsnorm kernel needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("rmsnorm kernel needs 16-byte aligned operands")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("residual must match x in shape and dtype")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm over the last dim; the CUDA kernel for CUDA tensors."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _check_cuda(x, scale, residual)
    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty_like(x)
    status = _build.lib().rmsnorm_bf16(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        _build.stream_ptr(x.device))
    _build.check(status, "rmsnorm_bf16")
    launches += 1
    return out
