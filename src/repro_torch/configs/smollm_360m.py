"""smollm-360m — llama-architecture small model. [hf:HuggingFaceTB/SmolLM-360M; hf]

32 layers, d_model 960, 15 query heads (head_dim 64), 5 KV heads, d_ff 2560,
vocab 49152. The 15-head count (g 3) is the one the JAX package pads to
32/8 for its 16-way model axis; the port runs both layouts. Pure full
attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke",
        family="dense",
        num_layers=2,
        d_model=60,
        num_heads=3,
        num_kv_heads=1,
        head_dim=20,
        d_ff=160,
        vocab_size=256,
        tie_embeddings=True,
    )
