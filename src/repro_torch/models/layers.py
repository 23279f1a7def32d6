"""Layer math of the fused step: norms, rope, activations, gated MLP.

Port of ``src/repro/models/layers.py`` (``rmsnorm``, ``rope_freqs``,
``apply_rope``, ``act_fn``, ``gated``, ``mlp``).  The MLP's products go
through ``qdot``: ``torch.matmul`` in the weights' dtype (bf16) for
plain weights, as XLA computes them outside any Pallas kernel in the
reference, and the W4A16 GEMM kernel for packed ones.  On a CUDA tensor
:func:`rmsnorm` runs the hand-written kernel of
``repro_torch.kernels.rmsnorm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.quant.int4 import qdot


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            *, plus_one: bool = False) -> torch.Tensor:
    """f32 statistics over the last dim, output cast to ``x.dtype``."""
    s = (1.0 + scale) if plus_one else scale
    return rmsnorm_kernel.rmsnorm(x.contiguous(), s.contiguous(), eps=eps)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions broadcastable to [..., S].  The
    half-split rotation runs in f32."""
    if theta <= 0.0:
        return x
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                  # [Dh/2]
    ang = positions[..., None].float() * inv               # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_gated": lambda x: F.gelu(x, approximate="tanh"),
        "relu_sq": lambda x: torch.square(F.relu(x)),
    }[name]


def gated(name: str) -> bool:
    return name in ("silu", "gelu_gated")


def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated: ``f(x @ wg) * (x @ wi) @ wo``; else biased ``f(x @ wi + bi)
    @ wo + bo``."""
    f = act_fn(act)
    if gated(act):
        return qdot(f(qdot(x, p["wg"])) * qdot(x, p["wi"]), p["wo"])
    return qdot(f(qdot(x, p["wi"]) + p["bi"]), p["wo"]) + p["bo"]
