"""whisper-tiny — encoder-decoder with conv audio frontend (stub). [arXiv:2212.04356]

4 encoder + 4 decoder layers, d_model 384, 6 heads (MHA, head_dim 64),
d_ff 1536, vocab 51865. The conv1d/mel frontend is a stub: the caller
supplies precomputed frame embeddings (batch, 1500, 384). Decoder
self-attention is full attention; decode runs the decoder against the
encoder's output, cross-attended through K/V projected once.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    act="gelu",
    mlp_type="mlp",
    enc_dec=True,
    enc_layers=4,
    enc_ctx=1500,
    frontend_note="conv+mel frontend stub: input_specs() supplies (batch, 1500, 384) "
                  "precomputed frame embeddings fed to the encoder.",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        norm_type="layernorm",
        act="gelu",
        mlp_type="mlp",
        enc_dec=True,
        enc_layers=2,
        enc_ctx=24,
    )
