"""qwen3-14b — dense, qk_norm + GQA. [hf:Qwen/Qwen3-8B family; hf]

40 layers, d_model 5120, 40 query heads (head_dim 128), 8 KV heads, d_ff 17408,
vocab 151936. RMSNorm on q/k per head (qk_norm). Pure full attention →
long_500k is skipped (documented).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
    )
