"""Byte-level BPE tokenizer (trainable, offline-friendly).

WebLLM ships each model's tokenizer alongside the compiled artifact; we
train small byte-level BPE vocabularies on sample text.  Byte fallback is
total: every byte is a base token, so encode/decode round-trips arbitrary
UTF-8 (property-tested).  ``token_bytes`` exposes the raw byte sequence
per id — the grammar engine builds its trie from that.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPECIALS = ("<|pad|>", "<|bos|>", "<|eos|>", "<|im_start|>", "<|im_end|>")


class ByteBPETokenizer:
    def __init__(self, merges: Optional[List[Tuple[int, int]]] = None,
                 specials: Sequence[str] = SPECIALS):
        self.specials = list(specials)
        self.n_special = len(self.specials)
        self.merges: List[Tuple[int, int]] = list(merges or [])
        self._rebuild()

    # -- identity ------------------------------------------------------
    @property
    def pad_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return 1

    @property
    def eos_id(self) -> int:
        return 2

    @property
    def vocab_size(self) -> int:
        return self.n_special + 256 + len(self.merges)

    def _rebuild(self):
        # token id layout: [specials][256 bytes][merges]
        self._bytes_of: List[bytes] = [s.encode() for s in self.specials]
        self._bytes_of += [bytes([b]) for b in range(256)]
        self._merge_rank: Dict[Tuple[int, int], int] = {}
        for rank, (a, b) in enumerate(self.merges):
            self._bytes_of.append(self._bytes_of[a] + self._bytes_of[b])
            self._merge_rank[(a, b)] = rank
        self._special_ids = {s: i for i, s in enumerate(self.specials)}

    # -- training ------------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 1024,
              specials: Sequence[str] = SPECIALS) -> "ByteBPETokenizer":
        tok = cls(specials=specials)
        n_merges = max(0, vocab_size - tok.vocab_size)
        words: Counter = Counter()
        for text in corpus:
            for piece in text.split(" "):
                words[(piece + " ").encode()] += 1
        seqs = {w: [tok.n_special + b for b in w] for w in words}
        for _ in range(n_merges):
            pairs: Counter = Counter()
            for w, cnt in words.items():
                s = seqs[w]
                for i in range(len(s) - 1):
                    pairs[(s[i], s[i + 1])] += cnt
            if not pairs:
                break
            (a, b), cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            new_id = tok.vocab_size
            tok.merges.append((a, b))
            tok._rebuild()
            for w in seqs:
                s = seqs[w]
                out = []
                i = 0
                while i < len(s):
                    if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(s[i])
                        i += 1
                seqs[w] = out
        return tok

    # -- encode / decode ----------------------------------------------
    def encode(self, text: str, *, add_bos: bool = False,
               allow_specials: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        chunks = [text]
        if allow_specials:
            chunks = self._split_specials(text)
        for chunk in chunks:
            if allow_specials and chunk in self._special_ids:
                ids.append(self._special_ids[chunk])
                continue
            ids.extend(self._encode_bytes(chunk.encode()))
        return ids

    def _split_specials(self, text: str) -> List[str]:
        out, rest = [], text
        while rest:
            hits = [(rest.find(s), s) for s in self.specials
                    if rest.find(s) >= 0]
            if not hits:
                out.append(rest)
                break
            pos, s = min(hits)
            if pos:
                out.append(rest[:pos])
            out.append(s)
            rest = rest[pos + len(s):]
        return out

    def _encode_bytes(self, data: bytes) -> List[int]:
        s = [self.n_special + b for b in data]
        while len(s) > 1:
            best_rank, best_i = None, -1
            for i in range(len(s) - 1):
                r = self._merge_rank.get((s[i], s[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            a, b = self.merges[best_rank]
            merged = self.n_special + 256 + best_rank
            s = s[:best_i] + [merged] + s[best_i + 2:]
        return s

    def token_bytes(self, token_id: int) -> bytes:
        return self._bytes_of[token_id]

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(self._bytes_of[i] for i in ids
                        if i >= self.n_special)
        return data.decode("utf-8", errors="replace")

    # -- chat template (WebLLM-style OpenAI messages -> prompt) ---------
    def apply_chat_template(self, messages: Sequence[dict]) -> str:
        parts = []
        for m in messages:
            content = m.get("content")
            if content is None:
                # assistant tool-call turns carry no text; render the
                # calls as JSON so the model sees its own actions
                calls = []
                for c in m.get("tool_calls") or []:
                    fn = (c.function if hasattr(c, "function")
                          else (c or {}).get("function", {}))
                    calls.append({
                        "name": getattr(fn, "name", None)
                        if not isinstance(fn, dict) else fn.get("name"),
                        "arguments": getattr(fn, "arguments", None)
                        if not isinstance(fn, dict) else fn.get("arguments"),
                    })
                content = json.dumps(calls) if calls else ""
            parts.append(f"<|im_start|>{m['role']}\n{content}<|im_end|>")
        parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    # -- persistence ----------------------------------------------------
    def save(self, path: str):
        Path(path).write_text(json.dumps(
            {"merges": self.merges, "specials": self.specials}))

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        d = json.loads(Path(path).read_text())
        return cls(merges=[tuple(m) for m in d["merges"]],
                   specials=d["specials"])
