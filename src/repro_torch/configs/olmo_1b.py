"""olmo-1b — dense with non-parametric LayerNorm. [arXiv:2402.00838; hf]

16 layers, d_model 2048, 16 heads (MHA, kv=16, head_dim 128), d_ff 8192,
vocab 50304. OLMo's norms carry no scale/bias (non-parametric) — exercised as
norm_type="np_layernorm". Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="np_layernorm",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        norm_type="np_layernorm",
        tie_embeddings=True,
    )
