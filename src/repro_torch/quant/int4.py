"""int4 group quantization of weights (WebLLM serves q4f16 models).

Port of ``src/repro/quant/int4.py`` (``QTensor``, ``choose_group``,
``should_quantize``, ``quantize_array``, ``quantize_tree``, ``qdot``).
Weights are quantized along the contraction dim (axis -2) in groups: two
int4 values pack into one int8 (low nibble = even k, sign-extended),
scales are bf16 per (group, column).  The packed bytes and scales are
bitwise those of the reference.

Group size adapts so that group boundaries never straddle a 16-way
'model'-axis shard of the contraction dim (the reference's production
layout), so the groups are not uniform: at reduced size Llama-3.1-8B
gets 64 for wq/wk/wv/wi/wg, 16 for ``attn.wo`` and 32 for ``ffn.wo``.

:func:`qdot` sends every :class:`QTensor` product to
``repro_torch.kernels.w4a16_gemm`` — on a CUDA tensor always the
hand-written kernel (no shape fallback), on a CPU tensor its plain
version, which computes the same function.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels.w4a16_gemm import unpack_dequant, w4a16_gemm
from repro_torch.models.params import ParamDef

MODEL_AXIS_SIZE = 16          # production model-parallel degree
DEFAULT_GROUP = 64
MIN_K = 128                   # don't quantize tiny contractions

# the model-sharded axes that a weight of this port contracts over
# (attn.wo over heads_flat, ffn.wo over d_ff)
_SHARDED_K_AXES = {"heads_flat", "d_ff"}


class QTensor:
    """Packed int4 weight: data int8 ``[..., K/2, N]``, scales bf16
    ``[..., K/G, N]``."""

    def __init__(self, data: torch.Tensor, scales: torch.Tensor,
                 group: int):
        self.data = data
        self.scales = scales
        self.group = group

    @property
    def shape(self):
        s = list(self.data.shape)
        s[-2] *= 2
        return tuple(s)

    def dequant(self) -> torch.Tensor:
        """bf16 weight ``[K, N]``: each nibble times its group scale,
        rounded to bf16 (the reference's ``dequant``; the product of a
        4-bit integer and a bf16 scale is exact in f32, so rounding it
        once equals the reference's bf16 multiply)."""
        return unpack_dequant(self.data, self.scales, self.group)

    def __repr__(self):
        return f"QTensor(shape={self.shape}, group={self.group})"


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def choose_group(K: int, k_sharded: bool) -> Optional[int]:
    if K < MIN_K or K % 2:
        return None
    g = DEFAULT_GROUP
    need = MODEL_AXIS_SIZE if k_sharded else 1
    while g >= 4:
        if K % (g * need) == 0:
            return g
        g //= 2
    return None


def should_quantize(d: ParamDef) -> Optional[int]:
    """Returns the group size, or None for a weight that stays as it is
    (norms, embed and lm_head, tiny contractions)."""
    if d.init != "normal" or d.dtype != torch.bfloat16 or len(d.shape) < 2:
        return None
    axes = d.axes or (None,) * len(d.shape)
    if "vocab" in axes:           # embed / lm_head stay bf16
        return None
    k_sharded = axes[-2] in _SHARDED_K_AXES
    return choose_group(d.shape[-2], k_sharded)


def quantize_array(w: torch.Tensor, group: int) -> QTensor:
    """Symmetric per-(group, column) int4 quantization, bitwise the
    reference's: f32 ``amax / 7`` floored at 1e-8, round half to even,
    clip to [-8, 7], nibbles packed in int16 and masked to 8 bits (a
    left shift of a negative int8 is not the reference's wrap-around)."""
    shape = w.shape
    K, N = shape[-2], shape[-1]
    wf = w.float().reshape(*shape[:-2], K // group, group, N)
    amax = wf.abs().amax(dim=-2, keepdim=True)             # [..., K/G, 1, N]
    scale = torch.clamp(amax / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int16)
    q = q.reshape(*shape[:-2], K, N)
    even = q[..., 0::2, :]
    odd = q[..., 1::2, :]
    packed = ((even & 0x0F) | ((odd & 0x0F) << 4)).to(torch.uint8) \
        .view(torch.int8)
    scales = scale[..., 0, :].to(torch.bfloat16)           # [..., K/G, N]
    return QTensor(packed.contiguous(), scales.contiguous(), group)


def quantize_tree(params, defs):
    """Quantize every weight the defs select, replacing the leaves of
    ``params``' own dicts and lists in place (and returning it): each
    bf16 weight is released as soon as its packed form exists, unless
    the caller still holds it."""
    if isinstance(defs, dict):
        for k in defs:
            params[k] = quantize_tree(params[k], defs[k])
        return params
    if isinstance(defs, (list, tuple)):
        for i, d in enumerate(defs):
            params[i] = quantize_tree(params[i], d)
        return params
    g = should_quantize(defs)
    return quantize_array(params, g) if g else params


def qdot(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Matmul with a maybe-quantized RHS: ``x @ w`` for a tensor, the
    W4A16 GEMM for a :class:`QTensor` (every leading dim of ``x`` folds
    into M)."""
    if not is_qtensor(w):
        return x @ w
    K, N = w.shape[-2], w.shape[-1]
    lead = x.shape[:-1]
    y = w4a16_gemm(x.reshape(-1, K).to(torch.bfloat16).contiguous(),
                   w.data, w.scales, group=w.group)
    return y.reshape(*lead, N).to(x.dtype)
