"""OpenAI-style API types (the JSON-in/JSON-out engine protocol).

WebLLM's endpoint-like design: every request/response/chunk is a plain
JSON-serializable dict (`to_dict`/`from_dict`), because the frontend and
backend engines exchange them purely by message-passing (core/worker.py).

Covers the fields real OpenAI clients send: ``n``-way sampling,
``tools``/``tool_choice`` function calling (``finish_reason ==
"tool_calls"`` + ``message.tool_calls``), per-token ``logprobs`` with
``top_logprobs`` alternatives, and ``stream_options``.  Every
``from_dict`` path — request, chunk, and response alike — drops unknown
keys instead of raising, so forward-compat holds across the worker
boundary in both directions.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional, Union


def _known(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop keys a dataclass doesn't declare — OpenAI-style clients send
    fields we don't implement and forward-compat means ignoring them
    rather than raising TypeError."""
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class FunctionCall:
    name: str = ""
    arguments: str = ""                 # JSON-encoded argument object


@dataclass
class ToolCall:
    id: str = ""
    function: FunctionCall = field(default_factory=FunctionCall)
    type: str = "function"
    # set on streaming deltas (OpenAI shape): which call in the
    # choice's tool_calls list this fragment extends
    index: Optional[int] = None


def _tool_calls_from(lst) -> Optional[List[ToolCall]]:
    if not lst:
        return None
    out = []
    for t in lst:
        if isinstance(t, ToolCall):
            out.append(t)
            continue
        t = _known(ToolCall, dict(t))
        fn = t.get("function") or {}
        if isinstance(fn, dict):
            t["function"] = FunctionCall(**_known(FunctionCall, fn))
        out.append(ToolCall(**t))
    return out


@dataclass
class ChatMessage:
    role: str
    content: Optional[str] = None
    tool_calls: Optional[List[ToolCall]] = None
    tool_call_id: Optional[str] = None   # for role == "tool" results

    def __post_init__(self):
        self.tool_calls = _tool_calls_from(self.tool_calls)


def _message_from(d) -> ChatMessage:
    if isinstance(d, ChatMessage):
        return d
    return ChatMessage(**_known(ChatMessage, dict(d)))


@dataclass
class TopLogprob:
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[List[int]] = None


@dataclass
class TokenLogprob:
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[List[int]] = None
    top_logprobs: List[TopLogprob] = field(default_factory=list)


@dataclass
class Logprobs:
    content: List[TokenLogprob] = field(default_factory=list)


def _logprobs_from(d) -> Optional[Logprobs]:
    if d is None or isinstance(d, Logprobs):
        return d
    content = []
    for t in (d.get("content") or []):
        t = _known(TokenLogprob, dict(t))
        t["top_logprobs"] = [TopLogprob(**_known(TopLogprob, x))
                             for x in (t.get("top_logprobs") or [])]
        content.append(TokenLogprob(**t))
    return Logprobs(content=content)


@dataclass
class ResponseFormat:
    type: str = "text"                  # text | json_object | json_schema | grammar
    json_schema: Optional[Dict[str, Any]] = None
    grammar: Optional[str] = None       # GBNF text for type == "grammar"


@dataclass
class ChatCompletionRequest:
    messages: List[ChatMessage]
    model: str = "default"
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    # min-p filter: drop tokens with p < min_p * max(p) (0 = disabled)
    min_p: float = 0.0
    # locally-typical sampling: keep the lowest |surprisal - entropy|
    # tokens until their mass reaches typical_p (1 = disabled)
    typical_p: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: List[str] = field(default_factory=list)
    stream: bool = False
    # usage on the final chunk is on by default (engine extension);
    # {"include_usage": false} turns it off
    stream_options: Optional[Dict[str, Any]] = None
    n: int = 1                          # choices per request (CoW-shared KV)
    seed: Optional[int] = None          # choice i samples with seed + i
    logprobs: bool = False
    top_logprobs: int = 0
    logit_bias: Dict[int, float] = field(default_factory=dict)
    # OpenAI function calling: [{"type": "function", "function":
    #   {"name", "description", "parameters": <JSON schema>}}, ...]
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Union[str, Dict[str, Any]] = "auto"
    parallel_tool_calls: bool = True
    response_format: ResponseFormat = field(default_factory=ResponseFormat)
    # vision-language input: stub image embeddings are attached by id
    image_embeds: Optional[str] = None

    def __post_init__(self):
        self.messages = [_message_from(m) for m in self.messages]
        if isinstance(self.response_format, dict):
            self.response_format = ResponseFormat(
                **_known(ResponseFormat, self.response_format))
        self.logit_bias = {int(k): float(v)
                           for k, v in (self.logit_bias or {}).items()}

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        d = _known(cls, dict(d))
        d["messages"] = [_message_from(m) for m in d.get("messages", [])]
        rf = d.get("response_format") or {}
        d["response_format"] = ResponseFormat(**_known(ResponseFormat, rf))
        d["logit_bias"] = {int(k): float(v)
                           for k, v in (d.get("logit_bias") or {}).items()}
        return cls(**d)


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    # WebLLM extension: perf stats in usage.extra
    extra: Dict[str, float] = field(default_factory=dict)


@dataclass
class ChoiceDelta:
    content: str = ""
    role: Optional[str] = None
    tool_calls: Optional[List[ToolCall]] = None


@dataclass
class ChunkChoice:
    delta: ChoiceDelta
    index: int = 0
    finish_reason: Optional[str] = None
    logprobs: Optional[Logprobs] = None


@dataclass
class ChatCompletionChunk:
    id: str
    choices: List[ChunkChoice]
    model: str
    created: int = field(default_factory=lambda: int(time.time()))
    object: str = "chat.completion.chunk"
    usage: Optional[Usage] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionChunk":
        d = _known(cls, dict(d))
        choices = []
        for c in d.get("choices", []):
            c = _known(ChunkChoice, dict(c))
            delta = _known(ChoiceDelta, dict(c.get("delta") or {}))
            delta["tool_calls"] = _tool_calls_from(delta.get("tool_calls"))
            c["delta"] = ChoiceDelta(**delta)
            c["logprobs"] = _logprobs_from(c.get("logprobs"))
            choices.append(ChunkChoice(**c))
        d["choices"] = choices
        d["usage"] = (Usage(**_known(Usage, d["usage"]))
                      if d.get("usage") else None)
        return cls(**d)


@dataclass
class Choice:
    message: ChatMessage
    index: int = 0
    finish_reason: str = "stop"
    logprobs: Optional[Logprobs] = None


@dataclass
class ChatCompletionResponse:
    id: str
    choices: List[Choice]
    model: str
    usage: Usage
    created: int = field(default_factory=lambda: int(time.time()))
    object: str = "chat.completion"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionResponse":
        d = _known(cls, dict(d))
        choices = []
        for c in d.get("choices", []):
            c = _known(Choice, dict(c))
            c["message"] = _message_from(c.get("message") or {"role": ""})
            c["logprobs"] = _logprobs_from(c.get("logprobs"))
            c.setdefault("finish_reason", "stop")
            choices.append(Choice(**c))
        d["choices"] = choices
        d["usage"] = Usage(**_known(Usage, d.get("usage") or {}))
        return cls(**d)


def new_request_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:16]
