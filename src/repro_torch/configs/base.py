"""Config system: model architecture + input-shape + runtime configs.

Every assigned architecture gets one file in this package exporting
``CONFIG`` (full-size, dry-run only) and ``reduced()`` (CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config. Families: dense | moe | rwkv6 | hybrid | encdec."""

    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention (unused for rwkv6)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    attention: str = "full"          # "full" | "swa" | "none"
    window: int = 0                  # sliding-window size when attention == "swa"
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN residual in parallel with MoE
    capacity_factor: float = 1.25
    # "ep": experts sharded over model axis, tokens cross shards (GSPMD)
    # "tp": expert weights F-sharded over model, dispatch stays local to the
    #       data shard; combine ends in one small all-reduce (beyond-paper
    #       §Perf optimisation — wins when experts are small / k is large)
    moe_strategy: str = "ep"
    # §Perf hillclimb knobs (False = baseline):
    bf16_reduce: bool = False    # force row-parallel partial sums to reduce
                                 # in bf16 at the block boundary (not deferred
                                 # into f32 norm inputs)
    seq_parallel: bool = False   # Megatron-SP: shard sequence over "model"
                                 # between blocks (AR → RS+AG, half wire)
    decode_partials: bool = False  # flash-decoding style: seq-sharded cache
                                   # with partial-softmax combine
    attn_bf16_probs: bool = False  # PV matmul reads bf16 probabilities
                                   # (accumulators stay f32)
    decode_grouped: bool = False   # GQA decode without repeat_kv
                                   # materialisation (KH-grouped einsums)
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0               # N: state size per head
    ssm_head_dim: int = 0            # P: channels per SSM head
    ssm_expand: int = 2              # d_inner = ssm_expand * d_model
    conv_width: int = 4
    attn_every: int = 0              # hybrid: shared attn block every k SSM blocks
    # RWKV6
    rwkv_head_size: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_ratio: int = 1       # S_enc = seq_len // ratio (conv-frontend downsampling)
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    # misc architecture knobs
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    act: str = "silu"                # "silu" | "gelu"
    tie_embeddings: bool = False
    # runtime
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    use_pallas: bool = False         # Pallas kernels (TPU target) vs pure-jnp path
    scan_layers: bool = True
    remat: str = "selective"         # "none" | "full" | "selective"
    attn_chunk: int = 1024           # KV-chunk for online-softmax prefill attention
    vocab_pad_to: int = 256          # pad vocab so it shards evenly
    # cache semantics, set per family: grows-with-context vs fixed-size state
    state_only: bool = False         # True for pure-SSM/linear-attn archs

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:        # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:      # mamba2
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def param_count(self) -> int:
        """Approximate parameter count N (embedding + blocks)."""
        d, f, l = self.d_model, self.d_ff, self.num_layers
        n = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        if self.family == "rwkv6":
            per = d * d * 4 + d * self.q_dim_rwkv() + 2 * d * f
            n += l * per
        elif self.family == "hybrid":
            di, nstate = self.d_inner, self.ssm_state
            per_ssm = d * (2 * di + 2 * self.ssm_heads * nstate + self.ssm_heads) + di * d
            n += l * per_ssm
            n_attn_apps = (l // self.attn_every) if self.attn_every else 0
            if n_attn_apps:
                shared = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d + 3 * d * f
                n += shared  # shared weights counted once
        else:
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            if self.family == "moe":
                ffn = self.num_experts * 3 * d * f
                if self.moe_dense_residual:
                    ffn += 3 * d * f
            else:
                ffn = 3 * d * f
            n += l * (attn + ffn)
            if self.is_encoder_decoder:
                n += self.num_encoder_layers * (attn + 3 * d * f)
                n += self.num_layers * (attn)  # cross-attention
        return n

    def q_dim_rwkv(self) -> int:
        return self.d_model

    def active_param_count(self) -> int:
        """N_active: for MoE, only routed experts count toward step FLOPs."""
        if self.family != "moe":
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.num_layers
        n = self.param_count()
        n -= l * self.num_experts * 3 * d * f
        n += l * self.experts_per_token * 3 * d * f
        if self.moe_dense_residual:
            pass  # dense residual already counted
        return n

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=64,
            d_ff=128,
            vocab_size=256,
            vocab_pad_to=32,
            attn_chunk=32,
            remat="none",
        )
        if self.num_heads:
            kw.update(num_heads=4, num_kv_heads=min(self.num_kv_heads, 2), head_dim=16)
        if self.family == "moe":
            kw.update(num_experts=4, experts_per_token=min(self.experts_per_token, 2))
        if self.family == "hybrid":
            kw.update(ssm_state=16, ssm_head_dim=16, attn_every=2,
                      num_heads=4, num_kv_heads=4, head_dim=16)
        if self.family == "rwkv6":
            kw.update(rwkv_head_size=16, rwkv_lora_decay=8, rwkv_lora_mix=8)
        if self.is_encoder_decoder:
            kw.update(num_encoder_layers=2)
        if self.window:
            kw.update(window=32)
        kw.update(overrides)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention / bounded cache.

    Runs for SSM / hybrid / linear-attn / SWA archs; skipped for pure
    full-attention archs (recorded in DESIGN.md §Arch-applicability).
    """
    if shape.name == "long_500k":
        return cfg.family in ("rwkv6", "hybrid") or cfg.attention == "swa"
    return True


@dataclass(frozen=True)
class TrainConfig:
    """Runtime training hyper-parameters (substrate, not arch)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1            # grad-accumulation factor
    zero1: bool = True               # shard optimizer state over data axis
    grad_compression: str = "none"   # "none" | "int8" (error-feedback)
    checkpoint_every: int = 200
    async_checkpoint: bool = True
    step_deadline_s: float = 0.0     # straggler mitigation; 0 = off
