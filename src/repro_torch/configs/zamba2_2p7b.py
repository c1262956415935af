"""zamba2-2.7b — Mamba2 backbone with a shared attention block. [arXiv:2411.15242; hf]

54 Mamba2 layers, d_model 2560; one *shared-weight* full-attention block (32H MHA,
kv=32) interleaved every 6 SSM layers (9 insertions). ssm_state=64.
Hybrid → sub-quadratic → long_500k runs (SSM state + one full-attn block whose
KV cache is the only quadratic-ish structure; at decode it is O(L) per token).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=128),
    attn_every=6,
    shared_attn=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk_size=16),
        attn_every=2,
        shared_attn=True,
    )
