from repro_torch.tokenizer.bpe import ByteBPETokenizer  # noqa: F401
from repro_torch.tokenizer.streamer import DetokStreamer  # noqa: F401
