"""Incremental Earley recognizer over bytes + per-step token bitmasks.

This is the XGrammar analogue WebLLM runs in WASM: given the grammar and
the tokenizer's token->bytes table (a trie), each decode step produces a
boolean vocab mask of tokens whose byte expansion keeps the input inside
the grammar.  The Earley chart is persistent/immutable, so speculative
advances during the trie DFS share prefixes for free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.grammar.gbnf import ByteSet, Grammar


@dataclass(frozen=True)
class _Item:
    rule: str
    prod: int
    dot: int
    origin: int


class _Trie:
    __slots__ = ("children", "tokens")

    def __init__(self):
        self.children: Dict[int, "_Trie"] = {}
        self.tokens: List[int] = []


_TRIE_CACHE: Dict[int, _Trie] = {}


def pack_token_bitmask(mask: np.ndarray) -> np.ndarray:
    """Pack a bool ``[V]`` token mask into ``uint32 [ceil(V/32)]`` words
    (bit ``v % 32`` of word ``v // 32`` = token ``v`` allowed) — the
    wire format the device sampling op consumes, 32x smaller than the
    bool mask it replaces on the host→device path."""
    v = mask.shape[-1]
    w = -(-v // 32)
    padded = np.zeros(w * 32, dtype=bool)
    padded[:v] = mask
    bits = padded.reshape(w, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)


def _token_trie(tokenizer) -> _Trie:
    key = id(tokenizer)
    if key in _TRIE_CACHE:
        return _TRIE_CACHE[key]
    root = _Trie()
    for tid in range(tokenizer.vocab_size):
        if tid < tokenizer.n_special:
            continue                      # specials handled separately
        node = root
        for b in tokenizer.token_bytes(tid):
            node = node.children.setdefault(b, _Trie()) \
                if b not in node.children else node.children[b]
        node.tokens.append(tid)
    _TRIE_CACHE[key] = root
    return root


class GrammarMatcher:
    def __init__(self, grammar: Grammar, tokenizer):
        self.g = grammar
        self.tok = tokenizer
        self.trie = _token_trie(tokenizer)
        self._nullable = self._compute_nullable()
        self.reset()

    # ------------------------------------------------------------------
    def _compute_nullable(self) -> Set[str]:
        nullable: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, prods in self.g.rules.items():
                if name in nullable:
                    continue
                for prod in prods:
                    if all(isinstance(s, str) and s in nullable
                           for s in prod):
                        nullable.add(name)
                        changed = True
                        break
        return nullable

    def reset(self):
        s0: Set[_Item] = set()
        for pi in range(len(self.g.rules[self.g.root])):
            s0.add(_Item(self.g.root, pi, 0, 0))
        self.chart: List[FrozenSet[_Item]] = [self._closure(s0, 0, [])]

    # ------------------------------------------------------------------
    def _next_sym(self, item: _Item):
        prod = self.g.rules[item.rule][item.prod]
        return prod[item.dot] if item.dot < len(prod) else None

    def _closure(self, items: Set[_Item], set_idx: int,
                 chart: Sequence[FrozenSet[_Item]]) -> FrozenSet[_Item]:
        work = list(items)
        seen = set(items)
        while work:
            it = work.pop()
            sym = self._next_sym(it)
            if isinstance(sym, str):
                # predict
                for pi in range(len(self.g.rules[sym])):
                    ni = _Item(sym, pi, 0, set_idx)
                    if ni not in seen:
                        seen.add(ni)
                        work.append(ni)
                if sym in self._nullable:          # Aycock-Horspool
                    ni = _Item(it.rule, it.prod, it.dot + 1, it.origin)
                    if ni not in seen:
                        seen.add(ni)
                        work.append(ni)
            elif sym is None:
                # complete: advance items in the origin set waiting on rule
                src = (seen if it.origin == set_idx
                       else chart[it.origin])
                for parent in list(src):
                    if self._next_sym(parent) == it.rule:
                        ni = _Item(parent.rule, parent.prod,
                                   parent.dot + 1, parent.origin)
                        if ni not in seen:
                            seen.add(ni)
                            work.append(ni)
        return frozenset(seen)

    def _advance(self, chart: List[FrozenSet[_Item]],
                 byte: int) -> Optional[List[FrozenSet[_Item]]]:
        cur = chart[-1]
        idx = len(chart)
        nxt: Set[_Item] = set()
        for it in cur:
            sym = self._next_sym(it)
            if isinstance(sym, ByteSet) and sym.matches(byte):
                nxt.add(_Item(it.rule, it.prod, it.dot + 1, it.origin))
        if not nxt:
            return None
        closed = self._closure(nxt, idx, chart)
        return chart + [closed]

    # ------------------------------------------------------------------
    def accept_bytes(self, data: bytes) -> bool:
        chart = self.chart
        for b in data:
            chart = self._advance(chart, b)
            if chart is None:
                return False
        self.chart = chart
        return True

    def accept_token(self, token_id: int) -> bool:
        if token_id == self.tok.eos_id:
            return self.can_terminate()
        return self.accept_bytes(self.tok.token_bytes(token_id))

    def can_terminate(self) -> bool:
        return any(it.rule == self.g.root and it.origin == 0
                   and self._next_sym(it) is None
                   for it in self.chart[-1])

    def token_mask(self) -> np.ndarray:
        """Boolean [vocab] mask of acceptable next tokens (incl. EOS)."""
        mask = np.zeros(self.tok.vocab_size, dtype=bool)

        def dfs(node: _Trie, chart: List[FrozenSet[_Item]]):
            for tid in node.tokens:
                mask[tid] = True
            for b, child in node.children.items():
                nc = self._advance(chart, b)
                if nc is not None:
                    dfs(child, nc)

        for b, child in self.trie.children.items():
            nc = self._advance(self.chart, b)
            if nc is not None:
                dfs(child, nc)
        if self.can_terminate():
            mask[self.tok.eos_id] = True
        return mask

    def token_bitmask(self) -> np.ndarray:
        """``token_mask()`` packed to ``uint32 [ceil(V/32)]`` for the
        batched device sampler (see :func:`pack_token_bitmask`)."""
        return pack_token_bitmask(self.token_mask())
