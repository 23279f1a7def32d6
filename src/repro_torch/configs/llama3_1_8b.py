"""llama-3.1-8b — the paper's Table 1 model #1. [arXiv:2407.21783]

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab 128256.
Served 4-bit quantized in WebLLM (q4f16_1); our serve path mirrors that.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, pattern_from_rule

CONFIG = ModelConfig(
    name="llama-3.1-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=pattern_from_rule(32, lambda i: LayerSpec("attn", "dense")),
    rope_theta=500000.0,
    act="silu",
    max_context=131072,
    sub_quadratic=False,
    source="arXiv:2407.21783 (Llama 3.1 8B) — WebLLM Table 1",
)
