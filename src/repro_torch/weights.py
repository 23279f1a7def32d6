"""Carry the JAX package's weights into the port.

``from_jax_params(cfg, tree)`` takes the JAX param tree with every leaf
already converted to numpy by the caller
(``jax.tree.map(np.asarray, params)``), so this module never sees JAX,
and returns the port's per-layer params (``repro_torch.models.params``)
as CPU tensors, bit for bit.  bf16 leaves arrive as ml_dtypes
``bfloat16`` arrays; they are recognized by ``dtype.name`` and
reinterpreted through an int16 view, so the port needs no ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_tensor(a) -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 included) -> CPU tensor, bitwise."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _convert(tree):
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v) for v in tree]
    return to_tensor(tree)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Unstack ``decoder.blocks`` into per-layer dicts, keeping the
    reference's ``prefix`` + blocks + ``suffix`` order (as
    ``PagedModelRunner._layer_params`` does)."""
    dec = tree["decoder"]
    g = cfg.grouped_pattern()
    layers: List[dict] = [_convert(p) for p in dec["prefix"]]
    if g.n_blocks:
        stacked = [_convert(b) for b in dec["blocks"]]
        for i in range(g.n_blocks):
            for j in range(len(g.block)):
                layers.append(_index(stacked[j], i))
    layers += [_convert(p) for p in dec["suffix"]]
    assert len(layers) == cfg.n_layers, (len(layers), cfg.n_layers)
    out = {"embed": to_tensor(tree["embed"]),
           "final_norm": to_tensor(tree["final_norm"]),
           "layers": layers}
    if "lm_head" in tree:
        out["lm_head"] = to_tensor(tree["lm_head"])
    return out
