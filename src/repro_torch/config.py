"""Configuration system for the PyTorch port (a copy of ``repro.config``).

Everything a run needs is described by three frozen dataclasses:

* :class:`ModelConfig`   — architecture (one per arch in ``repro_torch.configs``)
* :class:`ShapeConfig`   — input-shape cell (train_4k / prefill_32k / decode_32k / long_500k)
* :class:`RunConfig`     — mesh, sharding, bridge, optimizer and step options

Configs are plain data: importing a config never touches device state.  The
port keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# Block kinds (per-layer behaviour inside a transformer stack)
# ---------------------------------------------------------------------------
FULL_ATTN = "full"        # full causal attention
SWA_ATTN = "swa"          # sliding-window causal attention
GLOBAL_ATTN = "global"    # full attention layer inside a local:global pattern
RGLRU = "rglru"           # RG-LRU recurrent block (recurrentgemma / griffin)
MLSTM = "mlstm"           # xLSTM matrix-memory block
SLSTM = "slstm"           # xLSTM scalar-memory block

ATTENTION_KINDS = (FULL_ATTN, SWA_ATTN, GLOBAL_ATTN)
RECURRENT_KINDS = (RGLRU, MLSTM, SLSTM)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description, sufficient to build params + fwd/decode fns."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # Per-period layer pattern, tiled to num_layers (remainder allowed).
    # e.g. gemma3: 5×swa + 1×global; recurrentgemma: (rglru, rglru, swa).
    layer_pattern: Sequence[str] = (FULL_ATTN,)
    window_size: int = 0             # sliding window for swa layers

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # Encoder-decoder (seamless): encoder layers are bidirectional FULL_ATTN.
    num_encoder_layers: int = 0
    cross_attention: bool = False

    # Frontend stubs for [vlm] / [audio]: inputs are precomputed embeddings.
    embed_inputs: bool = False       # True -> input is (B, S, d_model) floats
    num_prefix_embeds: int = 0       # e.g. image patch tokens prepended

    # Misc architectural knobs
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    glu: bool = True                 # gated FFN (SwiGLU/GeGLU)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"

    # xLSTM internals
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333333
    conv_width: int = 4
    lru_width: int = 0               # 0 -> d_model

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # -- derived ------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to 256 so vocab shards over TP=16 (Megatron
        convention); logits are sliced back to ``vocab_size``."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def layers(self) -> tuple[str, ...]:
        """Full per-layer kind list (pattern tiled, truncated to num_layers)."""
        pat = tuple(self.layer_pattern)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return any(k in ATTENTION_KINDS for k in self.layers)

    @property
    def is_recurrent_only(self) -> bool:
        return all(k in RECURRENT_KINDS for k in self.layers)

    @property
    def supports_long_context(self) -> bool:
        """True when per-token decode state is bounded (sub-quadratic family)."""
        return all(k != FULL_ATTN for k in self.layers) or self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        hd, h, kv = self.head_dim, self.num_heads, self.num_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layers:
            total += d  # pre-norm
            if kind in ATTENTION_KINDS:
                total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            elif kind == RGLRU:
                w = self.lru_width
                total += 2 * d * w + w * d          # in/out proj (x,y branches)
                total += self.conv_width * w        # temporal conv
                total += 2 * w                      # input & recurrent gates (diag)
            elif kind == MLSTM:
                pf = self.mlstm_proj_factor
                inner = int(d * pf)
                total += 2 * d * inner + inner * d  # up(x2) + down
                total += 3 * inner * inner // max(self.num_heads, 1)  # qkv per head (block-diag approx)
                total += 3 * inner                  # i,f,o gates
            elif kind == SLSTM:
                pf = self.slstm_proj_factor
                inner = int(d * pf)
                total += 4 * d * d                  # recurrent cell weights (i,f,z,o)
                total += d * inner + inner * d      # ffn up/down
            # FFN
            if kind in ATTENTION_KINDS or kind == RGLRU:
                total += d  # post-norm
                if self.is_moe:
                    total += d * self.num_experts                       # router
                    ff = self.d_ff
                    total += self.num_experts * (3 if self.glu else 2) * d * ff
                elif self.d_ff > 0:
                    total += (3 if self.glu else 2) * d * self.d_ff
        if self.cross_attention:
            for _ in range(self.num_layers):
                total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d + d
        for _ in range(self.num_encoder_layers):
            total += d + d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            total += d + (3 if self.glu else 2) * d * self.d_ff
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        per_layer_all = self.num_experts * (3 if self.glu else 2) * d * ff
        per_layer_act = self.experts_per_token * (3 if self.glu else 2) * d * ff
        n_moe_layers = sum(1 for k in self.layers if k in ATTENTION_KINDS)
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_act)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class BridgeConfig:
    """Software-defined memory-bus bridge parameters (paper §2)."""

    page_elems: int = 16_384          # elements per page (the 'flit batch')
    epoch_budget: int = 8             # rate limiter: max pages pulled per epoch
    num_epochs: int = 0               # 0 -> one full ring rotation (N-1 epochs)
    mode: str = "pull"                # pull (paper) | push (beyond-paper)
    edge_buffer: bool = True          # double-buffer transfers across epochs
    channels: int = 1                 # pipelined round-engine depth (1=serial;
                                      # >1 overlaps request/data flits across
                                      # round chunks, bit-exact results)
    fused: bool = True                # fused datapath: one kernel pair per
                                      # round (False = the unfused engine,
                                      # which launches no kernel and
                                      # ignores channels)
    mem_axis: str = "data"            # mesh axis hosting the memory pool
    # modelled hardware (perfmodel): the paper prototype's values; the
    # card's projection is perfmodel.DEVICE_HW
    link_gbps: float = 10.0           # paper prototype: 10G Aurora
    rtt_cycles: int = 134             # paper: 134-cycle data-flit round trip
    clock_mhz: float = 167.5          # 134 cycles == 800ns  -> 167.5 MHz


@dataclass(frozen=True)
class ShardingConfig:
    """Logical→mesh-axis rules. Axis names refer to mesh axes."""

    batch_axes: tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    seq_axis: str = "data"            # sequence parallelism for long prefill
    # SP disabled by default: the data axis already carries batch DP, and
    # binding both to one axis is invalid.  Enable per-run for batch-1 work.
    shard_seq_threshold: int = 1 << 40
    expert_axis: str = "model"
    zero_axis: str = "data"           # optimizer-state sharding (ZeRO) axis
    enable_zero: bool = True
    kv_pages_axis: str = "data"       # disaggregated KV pool axis


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False      # int8 ring all-reduce w/ error feedback


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    remat: str = "block"              # none | block | full
    scan_layers: bool = True
    attn_impl: str = "xla"            # xla | pallas
    kv_placement: str = "local"       # local | bridge_pull | bridge_push
    microbatch: int = 1               # gradient accumulation steps
    seed: int = 0

    def cache_key(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


def reduced(model: ModelConfig, **overrides: Any) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = len(tuple(model.layer_pattern))
    # Keep the full config's pattern remainder so smoke tests exercise the
    # unscanned tail path (e.g. recurrentgemma's 38 = 12*3 + 2).
    n_layers = min(model.num_layers, 2 * pat + model.num_layers % pat)
    shrink: dict[str, Any] = dict(
        num_layers=n_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(model.num_kv_heads, 2) if model.num_kv_heads > 1 else 1,
        d_ff=256 if model.d_ff > 0 else 0,
        vocab_size=512,
        head_dim=32,
        window_size=min(model.window_size, 64) if model.window_size else 0,
        num_experts=min(model.num_experts, 4) if model.num_experts else 0,
        experts_per_token=min(model.experts_per_token, 2) if model.experts_per_token else 0,
        num_encoder_layers=min(model.num_encoder_layers, 2),
        lru_width=128 if model.lru_width else 0,
        num_prefix_embeds=min(model.num_prefix_embeds, 8),
    )
    shrink.update(overrides)
    return dataclasses.replace(model, **shrink)

