"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention. [arXiv:2401.04088; hf]

32 layers, d_model 4096, 32 query heads (head_dim 128), 8 KV heads,
8 experts x d_ff 14336 with top-2 routing, vocab 32000, SWA window 4096.
SWA → sub-quadratic: a decode state whose ``max_seq`` passes the window
is a ring KV cache of 4096 slots (a dense cache serves up to it).
The EP all_to_all dispatch is the paper-representative MPKLink channel.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    swa_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        swa_window=32,
        moe=MoEConfig(num_experts=4, top_k=2),
    )
