"""Incremental OpenAI-style ``delta.tool_calls`` streaming.

A grammar-constrained tool call decodes as one JSON object
``{"name": <fn>, "arguments": <json>}`` (``grammar/json_schema.py``'s
``tools_to_gbnf``).  Instead of buffering the whole call and attaching
it to the final chunk, :class:`ToolCallStreamer` watches the growing
text and emits OpenAI-shaped deltas as soon as they are certain:

* one opening delta carrying the call ``id`` and function ``name`` the
  moment the name string closes, then
* ``arguments`` **fragments** — every new character that is provably
  inside the arguments JSON value streams immediately (for container
  and string values every scanned character is inside the value until
  its terminator appears, so nothing is held back).

The concatenation of the streamed fragments is exactly the arguments
JSON the non-streaming response carries.  The streamer is fed the full
accumulated text each time (idempotent; it tracks what it already
emitted), so the engine calls it from the ordinary progress-emission
path with no extra state machine of its own.
"""
from __future__ import annotations

import json
import re
import uuid
from typing import List, Optional

from repro_torch.core import api

_NAME_RE = re.compile(r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"')
_ARGS_RE = re.compile(r'"arguments"\s*:\s*')


def _value_end(s: str, i: int) -> Optional[int]:
    """End index (exclusive) of the JSON value starting at ``s[i]``, or
    None while it is still incomplete.  Containers track brace/bracket
    depth (string-aware), strings track escapes, and primitives end at
    the first JSON delimiter."""
    c = s[i]
    if c in "{[":
        depth, in_str, esc = 0, False, False
        for j in range(i, len(s)):
            ch = s[j]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
                if depth == 0:
                    return j + 1
        return None
    if c == '"':
        esc = False
        for j in range(i + 1, len(s)):
            ch = s[j]
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                return j + 1
        return None
    for j in range(i, len(s)):
        if s[j] in " \t\r\n,}]":
            return j
    return None


class ToolCallStreamer:
    """Turns one choice's accumulating constrained tool-call text into
    incremental ``delta.tool_calls`` entries (argument-fragment chunks,
    OpenAI streaming shape)."""

    def __init__(self):
        self.call_id = "call_" + uuid.uuid4().hex[:12]
        self.emitted = False              # any delta sent yet
        self._name_end: Optional[int] = None
        self._args_start: Optional[int] = None
        self._args_end: Optional[int] = None
        self._args_sent = 0

    def feed(self, text: str) -> List[api.ToolCall]:
        """Feed the FULL accumulated text; returns the new deltas it
        unlocks (possibly empty).  Each delta is an
        :class:`api.ToolCall` with ``index=0`` — the opening one carries
        ``id``/``type``/``name``, later ones only argument fragments."""
        out: List[api.ToolCall] = []
        if self._name_end is None:
            m = _NAME_RE.search(text)
            if m is None:
                return out
            self._name_end = m.end()
            out.append(api.ToolCall(
                id=self.call_id, index=0,
                function=api.FunctionCall(
                    name=json.loads('"' + m.group(1) + '"'),
                    arguments="")))
        if self._args_start is None:
            m = _ARGS_RE.search(text, self._name_end)
            if m is not None and len(text) > m.end():
                self._args_start = m.end()
        if self._args_start is not None and self._args_end is None:
            end = _value_end(text, self._args_start)
            limit = len(text) if end is None else end
            frag = text[self._args_start + self._args_sent:limit]
            if frag:
                out.append(api.ToolCall(
                    index=0,
                    function=api.FunctionCall(arguments=frag)))
                self._args_sent += len(frag)
            if end is not None:
                self._args_end = end
        if out:
            self.emitted = True
        return out
