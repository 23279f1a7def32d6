"""Q/K/V projections and QK-norm of the fused step.

Port of ``src/repro/models/attention.py::_project`` and ``_qk_norm``.
Projections go through ``qdot`` (the W4A16 GEMM for packed weights).
Attention itself is ``repro_torch.kernels.paged_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.quant.int4 import qdot

NEG_INF = -1e30


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor, which: str,
             n_heads: int) -> torch.Tensor:
    """x [B, S, D] @ w{which} (+ bias) -> [B, S, n_heads, head_dim]."""
    y = qdot(x, p["w" + which])
    if cfg.qkv_bias and ("b" + which) in p:
        y = y + p["b" + which]
    B, S = x.shape[:2]
    return y.reshape(B, S, n_heads, cfg.head_dim)


def _qk_norm(cfg: ModelConfig, p: dict, q: torch.Tensor, k: torch.Tensor):
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k
