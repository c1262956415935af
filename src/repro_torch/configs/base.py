"""Configuration dataclasses for the PyTorch port.

A copy of the dataclasses of ``repro.configs.base`` (the port imports
nothing of ``repro``): models, the shape grid, training, sharding and
serving. ``ShardingConfig`` is kept so that ``TrainConfig`` and
``ServeConfig`` have the reference's fields; on one card it selects
nothing.
Plain dataclasses (no external deps) so configs are hashable-ish, printable and
trivially serializable. One ``ModelConfig`` per ported architecture lives in
``repro_torch.configs.<arch>``; the registry maps ``--arch`` ids to them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyper-parameters."""

    d_state: int = 128          # N — state dimension per head
    head_dim: int = 64          # P — channels per SSM head
    expand: int = 2             # d_inner = expand * d_model
    chunk_size: int = 128       # SSD chunk length (MXU-aligned)
    n_groups: int = 1           # B/C groups (GVA-style)
    conv_width: int = 4         # depthwise causal conv width
    dt_min: float = 1e-3
    dt_max: float = 1e-1


@dataclass(frozen=True)
class MoEConfig:
    """Top-k routed mixture-of-experts FFN.

    ``group_size``: tokens are routed in independent groups of this size
    (GShard "groups"). None = one global group — the naive baseline whose
    dispatch einsums are QUADRATIC in tokens (recorded as such in
    EXPERIMENTS.md §Perf; the grouped variant is hillclimb iteration 1)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    group_size: Optional[int] = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int                         # FFN hidden (per expert when MoE)
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // num_heads
    # attention variants
    qk_norm: bool = False
    swa_window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 10_000.0
    # norms / activations
    norm_type: str = "rmsnorm"        # rmsnorm | np_layernorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"
    mlp_type: str = "glu"             # glu (gate/up/down) | mlp (up/down)
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0               # hybrid: one (shared) attn block every N ssm blocks
    shared_attn: bool = False         # hybrid: attention weights shared across insertions
    # encoder-decoder (audio family)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_ctx: int = 0                  # encoder context length (e.g. whisper 1500 frames)
    # modality frontend stubs: precomputed embeddings prepended to the token sequence
    vision_tokens: int = 0            # vlm: number of patch-embedding tokens
    vision_dim: int = 0               # vlm: patch-embedding feature dim (projected to d_model)
    frontend_note: str = ""
    # head padding (beyond-paper perf knob): grow q/kv head counts with
    # ZERO-weight heads so they tile the TP axis. Function-preserving: pad q
    # rows of wq and pad output rows of wo are zero, so pad heads contribute
    # exactly 0. None = the paper-faithful baseline (non-divisible heads are
    # replicated over the model axis instead — see sharding/specs.py).
    pad_q_heads: Optional[int] = None
    pad_kv_heads: Optional[int] = None

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ------------------------------------------------------------
    @property
    def q_heads_eff(self) -> int:
        return self.pad_q_heads or self.num_heads

    @property
    def kv_heads_eff(self) -> int:
        return self.pad_kv_heads or self.num_kv_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM state or SWA ring)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return (self.d_inner // self.ssm.head_dim) if self.ssm else 0

    def param_count(self) -> int:
        """Approximate parameter count (exact for what we instantiate)."""
        c, D = self, self.d_model
        n = c.vocab_size * D                      # embed
        if not c.tie_embeddings:
            n += c.vocab_size * D                 # lm head
        per_attn = (
            c.num_heads * c.head_dim * D          # q
            + 2 * c.num_kv_heads * c.head_dim * D  # k, v
            + c.num_heads * c.head_dim * D        # o
        )
        per_ffn = (3 if c.mlp_type == "glu" else 2) * D * c.d_ff  # (gate,) up, down
        if c.moe:
            per_ffn = c.moe.num_experts * per_ffn + D * c.moe.num_experts
        per_ssm = 0
        if c.ssm:
            di, s = c.d_inner, c.ssm
            per_ssm = (
                D * (2 * di + 2 * s.n_groups * s.d_state + self.ssm_heads)  # in_proj(zx) + BC + dt
                + s.conv_width * (di + 2 * s.n_groups * s.d_state)           # conv
                + self.ssm_heads * 2                                          # A_log, D
                + di * D                                                      # out_proj
                + di                                                          # gate norm
            )
        norm_p = 0 if c.norm_type == "np_layernorm" else D
        if c.family == "ssm":
            n += c.num_layers * (per_ssm + 2 * norm_p)
        elif c.family == "hybrid":
            n_attn = 1 if c.shared_attn else max(1, c.num_layers // max(1, c.attn_every))
            n += c.num_layers * (per_ssm + 2 * norm_p) + n_attn * (per_attn + norm_p)
        elif c.enc_dec:
            n += c.enc_layers * (per_attn + per_ffn + 3 * norm_p)             # enc self+ffn
            n += c.num_layers * (2 * per_attn + per_ffn + 4 * norm_p)         # dec self+cross+ffn
        else:
            n += c.num_layers * (per_attn + per_ffn + 2 * norm_p)
        if c.vision_tokens:
            n += c.vision_dim * D + D
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k experts only)."""
        if not self.moe:
            return self.param_count()
        c = self
        dense_ffn = 3 * c.d_model * c.d_ff
        unused = (c.moe.num_experts - c.moe.top_k) * dense_ffn * c.num_layers
        return int(self.param_count() - unused)


# ---------------------------------------------------------------------------
# Input shapes (the assigned grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason) for an (arch, shape) cell. Skips are recorded, never silent."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; %s is pure full-attention" % model.name
    return True, ""


# ---------------------------------------------------------------------------
# Training / serving / sharding knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclass(frozen=True)
class ShardingConfig:
    policy: str = "tp"            # tp | fsdp_tp
    # MPKLink fabric switches (beyond-paper explicit-collective paths)
    fabric_tp: bool = False       # explicit shard_map TP exchange instead of GSPMD
    fabric_guard: bool = False    # tag+MAC guard on fabric channels
    grad_compression: bool = False  # int8+EF on cross-pod gradient reduce
    remat: str = "block"          # none | block | full
    scan_layers: bool = True


@dataclass(frozen=True)
class TrainConfig:
    microbatch_size: int = 8      # per-step microbatch (grad accumulation over global/micro)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 128
    max_seq: int = 32_768
    dtype: str = "bfloat16"
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    decode_steps: int = 32


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
