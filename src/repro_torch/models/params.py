"""Parameter definitions and initialization for the pure-GQA dense
decoder the paged path serves.

Port of ``src/repro/models/pdef.py`` (``ParamDef``, ``init_one``) and
``src/repro/models/model.py::params_def``, in the PER-LAYER layout the
port runs: ``{"embed", "final_norm", ["lm_head"], "layers": [...]}``
where each layer is ``{"mixer_norm", "attn": {wq, wk, wv, wo}, "ffn_norm",
"ffn": {wi, wg, wo}}``.  The JAX tree stacks its scanned layers instead;
``repro_torch.weights`` converts one into the other.

Initialization follows the reference's rules — normal x scale, zeros,
ones — but draws from a seeded ``torch.Generator`` on the target device,
so the numbers differ from JAX's; parity tests load the JAX weights
through ``repro_torch.weights.from_jax_params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02           # stddev for normal
    #: logical axis name per dim (the reference's sharding names); the
    #: W4A16 group choice reads whether the contraction axis is sharded
    axes: Tuple[Optional[str], ...] = ()


def linear(din: int, dout: int, in_ax: Optional[str],
           out_ax: Optional[str]) -> ParamDef:
    return ParamDef((din, dout), torch.bfloat16, "normal", 0.02,
                    axes=(in_ax, out_ax))


def norm_scale(d: int) -> ParamDef:
    return ParamDef((d,), torch.float32, "ones", axes=(None,))


def paged_supported(cfg: ModelConfig) -> bool:
    """The paged path serves a decoder of plain attention + dense FFN."""
    return (not cfg.is_encdec
            and all(s.mixer == "attn" and s.ffn == "dense"
                    for s in cfg.layer_pattern))


def _layer_def(cfg: ModelConfig) -> dict:
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"mixer_norm": norm_scale(d),
            "attn": {"wq": linear(d, q_dim, "d_model", "heads_flat"),
                     "wk": linear(d, kv_dim, "d_model", "kv_flat"),
                     "wv": linear(d, kv_dim, "d_model", "kv_flat"),
                     "wo": linear(q_dim, d, "heads_flat", "d_model")},
            "ffn_norm": norm_scale(d),
            "ffn": {"wi": linear(d, cfg.d_ff, "d_model", "d_ff"),
                    "wg": linear(d, cfg.d_ff, "d_model", "d_ff"),
                    "wo": linear(cfg.d_ff, d, "d_ff", "d_model")}}


def params_def(cfg: ModelConfig) -> Dict[str, Any]:
    """The pure-GQA dense decoder with a gated MLP; QKV bias, QK-norm,
    ungated MLPs and other families are later work."""
    if (not paged_supported(cfg) or cfg.qkv_bias or cfg.qk_norm
            or cfg.act not in ("silu", "gelu_gated")):
        raise NotImplementedError(
            f"{cfg.name}: the port serves pure-GQA dense decoders with a "
            "gated MLP only (other model families: ROADMAP A6)")
    V, D = cfg.vocab_size, cfg.d_model
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, D), torch.bfloat16, "normal", 0.02,
                          axes=("vocab", "d_model")),
        "final_norm": norm_scale(D),
        "layers": [_layer_def(cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = linear(D, V, "d_model", "vocab")
    return defs


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def count_params(cfg: ModelConfig) -> int:
    total = 0
    for d in tree_leaves(params_def(cfg)):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def init_one(d: ParamDef, gen: torch.Generator,
             device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "normal":
        # one tensor at a time: the f32 transient is one weight, never
        # the whole model
        return (torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device) * d.scale).to(d.dtype)
    raise ValueError(d.init)


def init_params(cfg: ModelConfig, seed: int,
                device: torch.device) -> Dict[str, Any]:
    """Random weights from a seeded generator on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda d: init_one(d, gen, device), params_def(cfg))


def to_device(params, device: torch.device):
    return tree_map(lambda t: t.to(device), params)
