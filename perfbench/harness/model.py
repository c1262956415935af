"""The program's model configuration from a configuration file."""
from __future__ import annotations


def port_config(cfg: dict):
    """The ``repro_torch`` ``ModelConfig`` of a configuration file's
    published keys: a sparse-expert family gets an ``MoEConfig`` of its
    experts and experts per token (no routing groups)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    moe = None
    if cfg.get("num_local_experts"):
        moe = MoEConfig(num_experts=cfg["num_local_experts"],
                        top_k=cfg["num_experts_per_tok"])
    return ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        qk_norm=bool(cfg.get("qk_norm", False)), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], moe=moe)
