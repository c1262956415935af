"""grok-1-314b — 8-expert top-2 MoE, the memory-pressure stress arch. [hf:xai-org/grok-1]

64 layers, d_model 6144, 48 query heads (head_dim 128), 8 KV heads,
8 experts x d_ff 32768 top-2, vocab 131072. 314B params → bf16 weights alone
are 628 GB, more than any one card holds: the port runs it reduced, on the
CPU (the JAX package shards it with its fsdp_tp policy). Pure full attention
→ long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2),
    )
