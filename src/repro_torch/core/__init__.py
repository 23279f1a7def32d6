"""The port's serving core: ``MLCEngine`` over the paged backend."""
from repro_torch.core.api import (ChatCompletionRequest,  # noqa: F401
                                  ChatCompletionResponse, ChatMessage,
                                  FunctionCall, Logprobs, ResponseFormat,
                                  ToolCall)
from repro_torch.core.engine import EngineCrashed, MLCEngine  # noqa: F401
from repro_torch.core.paged_runner import PagedEngineBackend  # noqa: F401
from repro_torch.core.prefix_cache import PrefixCache  # noqa: F401
