"""llama3.2-1b — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]

16 layers, d_model 2048, 32 query heads (head_dim 64), 8 KV heads, d_ff 8192,
vocab 128256, rope_theta 500000. Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        tie_embeddings=True,
    )
