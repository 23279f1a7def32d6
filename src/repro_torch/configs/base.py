"""Core configuration dataclasses (a copy of ``repro.configs.base``).

Every architecture is expressed as a :class:`ModelConfig` built from
per-layer :class:`LayerSpec` entries.  The layer pattern is grouped into
(prefix, repeated block x n, suffix), the layout the JAX package's param
tree stacks its scanned blocks in — ``repro_torch.weights`` unstacks it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence, Tuple

MixerKind = Literal["attn", "swa", "mla", "mamba", "rwkv6"]
FFNKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    """One transformer(-ish) layer: a sequence mixer + an FFN."""

    mixer: MixerKind = "attn"
    ffn: FFNKind = "dense"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0      # deepseek-style always-on experts
    shared_d_ff: int = 0             # d_ff of the (merged) shared expert
    dense_residual: bool = False     # arctic: dense MLP in parallel w/ MoE
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => plain q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class RWKV6Config:
    head_dim: int = 64
    decay_lora_rank: int = 64        # data-dependent decay LoRA (Finch)
    mix_lora_rank: int = 32          # token-shift mix LoRA ("x" LoRAs)


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB (per brief: embeddings are precomputed).

    ``kind='audio'``: input is mel-frame embeddings [B, n_frames, d_model]
    feeding the encoder.  ``kind='vision'``: patch embeddings
    [B, n_patches, d_model] prepended to the text sequence at prefill.
    """

    kind: Literal["none", "audio", "vision"] = "none"
    num_embeds: int = 0              # frames / patches provided by the stub


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper)."""

    n_layers: int = 6
    max_positions: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    layer_pattern: Tuple[LayerSpec, ...] = ()
    # --- attention details ---
    rope_theta: float = 10000.0
    local_rope_theta: float = 0.0    # gemma3: different theta for SWA layers
    sliding_window: int = 0          # window size for 'swa' layers
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # gemma3
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                # "silu" (gated) | "gelu" (whisper-style)
    # --- sub-configs (present iff pattern uses them) ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv6: Optional[RWKV6Config] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: Optional[EncoderConfig] = None   # present => enc-dec model
    # --- serving options ---
    kv_cache_dtype: str = "bf16"     # "bf16" | "int8" (quantized KV cache)
    # --- bookkeeping ---
    source: str = ""                 # citation for the config numbers
    max_context: int = 131072
    sub_quadratic: bool = False      # eligible for long_500k decode

    # ------------------------------------------------------------------
    def __post_init__(self):
        if not self.layer_pattern:
            object.__setattr__(
                self, "layer_pattern",
                tuple(LayerSpec() for _ in range(self.n_layers)))
        assert len(self.layer_pattern) == self.n_layers, (
            f"{self.name}: pattern len {len(self.layer_pattern)} != "
            f"n_layers {self.n_layers}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        kinds = {s.mixer for s in self.layer_pattern}
        if "mla" in kinds:
            assert self.mla is not None
        if "mamba" in kinds:
            assert self.mamba is not None
        if "rwkv6" in kinds:
            assert self.rwkv6 is not None
        if any(s.ffn == "moe" for s in self.layer_pattern):
            assert self.moe is not None

    # -- derived ------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def grouped_pattern(self) -> "GroupedPattern":
        return group_pattern(self.layer_pattern)

    def num_params(self) -> int:
        """Total parameter count (exact, matching models.params.params_def)."""
        from repro_torch.models.params import count_params  # lazy: no cycle
        return count_params(self)

    def reduced(self, *, n_layers: int = 2, d_model: int = 0,
                n_experts: int = 4, vocab_size: int = 512,
                seq_cap: int = 0) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (per brief:
        <=2 layers, d_model<=512, <=4 experts)."""
        d_model = d_model or min(self.d_model, 256)
        head_dim = min(self.head_dim, 64)
        n_heads = max(2, min(self.n_heads, d_model // head_dim))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pat = _shrink_pattern(self.layer_pattern, n_layers)
        kw: dict = dict(
            name=self.name + "-smoke", n_layers=len(pat), d_model=d_model,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
            d_ff=max(64, d_model * 2), vocab_size=vocab_size,
            layer_pattern=pat,
            rope_theta=self.rope_theta,
            local_rope_theta=self.local_rope_theta,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            logit_softcap=self.logit_softcap,
            tie_embeddings=self.tie_embeddings, norm_eps=self.norm_eps,
            act=self.act, source=self.source,
            max_context=min(self.max_context, seq_cap or 4096),
            sub_quadratic=self.sub_quadratic,
            frontend=dataclasses.replace(
                self.frontend,
                num_embeds=min(self.frontend.num_embeds, 8))
            if self.frontend.kind != "none" else self.frontend,
        )
        if self.moe is not None:
            ne = min(self.moe.num_experts, n_experts)
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=ne, top_k=min(self.moe.top_k, 2),
                expert_d_ff=max(32, d_model),
                shared_d_ff=max(32, d_model) if self.moe.num_shared_experts else 0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                                  qk_nope_head_dim=head_dim,
                                  qk_rope_head_dim=32, v_head_dim=head_dim)
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(self.mamba, d_state=8)
        if self.rwkv6 is not None:
            kw["rwkv6"] = RWKV6Config(head_dim=min(64, d_model // 2),
                                      decay_lora_rank=16, mix_lora_rank=8)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(n_layers=min(2, self.encoder.n_layers),
                                          max_positions=32)
        return ModelConfig(**kw)


# ----------------------------------------------------------------------
# Pattern grouping: (prefix, block x n_blocks, suffix)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class GroupedPattern:
    prefix: Tuple[LayerSpec, ...]
    block: Tuple[LayerSpec, ...]
    n_blocks: int
    suffix: Tuple[LayerSpec, ...]

    @property
    def total(self) -> int:
        return len(self.prefix) + len(self.block) * self.n_blocks + len(self.suffix)


def group_pattern(pattern: Sequence[LayerSpec],
                  max_block: int = 8) -> GroupedPattern:
    """Find the best (prefix, repeated block, suffix) decomposition.

    Scans block sizes 1..max_block and prefix offsets 0..max_block, picks
    the decomposition maximizing layers covered by the scanned block.
    """
    pattern = tuple(pattern)
    n = len(pattern)
    best = GroupedPattern(pattern, (), 0, ())  # fully unrolled fallback
    best_cov = 0
    for bs in range(1, min(max_block, n) + 1):
        for pre in range(0, min(max_block, n) + 1):
            avail = n - pre
            nb = avail // bs
            if nb < 2:
                continue
            block = pattern[pre:pre + bs]
            ok = all(
                pattern[pre + k * bs: pre + (k + 1) * bs] == block
                for k in range(nb))
            if not ok:
                # try fewer blocks (longest matching run)
                while nb >= 2 and not all(
                        pattern[pre + k * bs: pre + (k + 1) * bs] == block
                        for k in range(nb)):
                    nb -= 1
                if nb < 2:
                    continue
            cov = nb * bs
            # prefer more coverage; tie-break on smaller block (cheaper body)
            if cov > best_cov or (cov == best_cov and bs < len(best.block or (0,) * 99)):
                best = GroupedPattern(pattern[:pre], block, nb,
                                      pattern[pre + nb * bs:])
                best_cov = cov
    return best


def _shrink_pattern(pattern: Sequence[LayerSpec], n: int) -> Tuple[LayerSpec, ...]:
    """Keep a representative mini-pattern: preserve at least one of each
    distinct layer spec present, within n layers (n may grow to fit)."""
    distinct: list[LayerSpec] = []
    for s in pattern:
        if s not in distinct:
            distinct.append(s)
    n = max(n, len(distinct))
    out = list(distinct)
    i = 0
    while len(out) < n:
        out.append(pattern[i % len(pattern)])
        i += 1
    return tuple(out[:n])


# ----------------------------------------------------------------------
# Input shapes (assigned)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def pattern_from_rule(n_layers: int, rule) -> Tuple[LayerSpec, ...]:
    """Build a layer pattern from a callable i -> LayerSpec."""
    return tuple(rule(i) for i in range(n_layers))
