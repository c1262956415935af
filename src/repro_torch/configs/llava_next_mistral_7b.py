"""llava-next-mistral-7b — Mistral-7B backbone + anyres vision frontend (stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
The backbone only; the anyres tiling frontend is a stub that supplies
precomputed patch embeddings (CLIP-ViT-L/14 336px → 576 tokens a tile,
anyres up to 5 tiles → 2880 vision tokens, projected 1024 → 4096).
Mistral-7B uses sliding-window attention (window 4096), so a context past
the window decodes on a ring cache of 4096 slots.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    swa_window=4096,
    rope_theta=1e6,
    vision_tokens=2880,
    vision_dim=1024,
    frontend_note="anyres tiling stub: input_specs() supplies (batch, 2880, 1024) "
                  "precomputed patch embeddings; backbone projects to d_model.",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        swa_window=32,
        vision_tokens=8,
        vision_dim=24,
    )
