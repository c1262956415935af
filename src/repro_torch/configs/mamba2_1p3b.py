"""mamba2-1.3b — pure SSD (state-space duality) stack, attention-free. [arXiv:2405.21060]

48 layers, d_model 2048, d_inner 4096 (expand 2), 64 SSM heads of dim 64,
d_state 128, chunked SSD scan. vocab 50280. No attention anywhere →
long_500k runs on pure recurrent state (O(1) memory per token at decode).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=128),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk_size=16),
        tie_embeddings=True,
    )
