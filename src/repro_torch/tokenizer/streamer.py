"""Streaming detokenizer: emits the longest valid UTF-8 prefix as tokens
arrive.  Incomplete multi-byte codepoints split across tokens stay
buffered; permanently-invalid bytes are emitted as replacement chars
immediately (they can never be repaired by future bytes, and holding
them would starve streaming of progress chunks forever)."""
from __future__ import annotations

import codecs


class DetokStreamer:
    def __init__(self, tokenizer):
        self.tok = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def put(self, token_id: int) -> str:
        if token_id < self.tok.n_special:
            return ""                      # specials never stream out
        return self._dec.decode(self.tok.token_bytes(token_id))

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)
