"""The port's ``ModelConfig`` from a configuration file: the published keys
as before, and the ``"port"`` object setting any field by its name."""
import copy

import numpy as np
import pytest
import torch

from perfbench.harness import bench
from perfbench.harness.model import port_config
from perfbench.tests.tiny import TINY


def _file(config):
    return copy.deepcopy(bench.load_cell({"grok-1-314b": "grok-1-314b.serve",
                                          "qwen3-14b": "qwen3-14b.train"}[config]).config)


def _written_out(config):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    if config == "grok-1-314b":
        return ModelConfig(
            name="grok-1-314b", family="moe", num_layers=4, d_model=6144, num_heads=48,
            num_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128, qk_norm=False,
            swa_window=None, rope_theta=10000.0, norm_type="rmsnorm", norm_eps=1e-05,
            act="silu", mlp_type="glu", tie_embeddings=False,
            moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                          router_z_loss=1e-3, load_balance_loss=1e-2, group_size=None),
            ssm=None, attn_every=0, shared_attn=False, enc_dec=False, enc_layers=0,
            enc_ctx=0, vision_tokens=0, vision_dim=0, frontend_note="",
            pad_q_heads=None, pad_kv_heads=None)
    return ModelConfig(
        name="qwen3-14b", family="dense", num_layers=4, d_model=5120, num_heads=40,
        num_kv_heads=8, d_ff=17408, vocab_size=151936, head_dim=128, qk_norm=True,
        swa_window=None, rope_theta=1000000.0, norm_type="rmsnorm", norm_eps=1e-06,
        act="silu", mlp_type="glu", tie_embeddings=False, moe=None, ssm=None,
        attn_every=0, shared_attn=False, enc_dec=False, enc_layers=0, enc_ctx=0,
        vision_tokens=0, vision_dim=0, frontend_note="", pad_q_heads=None,
        pad_kv_heads=None)


@pytest.mark.parametrize("config", ["grok-1-314b", "qwen3-14b"])
def test_the_benchmark_files_give_the_same_model_config(config):
    import dataclasses
    got, want = port_config(_file(config)), _written_out(config)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert type(getattr(got, f.name)) is type(getattr(want, f.name)), f.name
    assert got == want


def test_port_sets_top_level_and_nested_fields():
    from repro_torch.configs.base import MoEConfig, SSMConfig
    cfg = _file("grok-1-314b")
    cfg["port"] = {"swa_window": 4096, "tie_embeddings": True, "norm_eps": 1,
                   "ssm": {"d_state": 128, "head_dim": 64, "n_groups": 1},
                   "moe": {"group_size": 256, "capacity_factor": 2}}
    got = port_config(cfg)
    assert got.swa_window == 4096 and got.tie_embeddings is True
    assert got.norm_eps == 1.0 and isinstance(got.norm_eps, float)
    assert got.ssm == SSMConfig(d_state=128, head_dim=64, n_groups=1)
    # merged over the published experts, which stay
    assert got.moe == MoEConfig(num_experts=8, top_k=2, group_size=256, capacity_factor=2.0)
    # without published experts, the object builds one from the defaults
    cfg = _file("qwen3-14b")
    cfg["port"] = {"moe": {"num_experts": 4}, "pad_q_heads": None}
    assert port_config(cfg).moe == MoEConfig(num_experts=4)


@pytest.mark.parametrize("port, name", [
    ({"swa_windw": 8}, "port.swa_windw"),
    ({"moe": {"topk": 3}}, "port.moe.topk"),
    ({"ssm": {"d_state": 64, "state_dim": 64}}, "port.ssm.state_dim"),
])
def test_an_unknown_name_is_refused_with_its_name_and_file(port, name):
    cfg = _file("grok-1-314b")
    cfg["port"] = port
    with pytest.raises(ValueError, match=name.replace(".", r"\.")) as e:
        port_config(cfg)
    assert "perfbench/configs/grok-1-314b.json" in str(e.value)


@pytest.mark.parametrize("port", [{"qk_norm": "yes"}, {"swa_window": 1.5},
                                  {"num_layers": None}, {"ssm": 3}, {"moe": {"top_k": True}}])
def test_a_value_of_the_wrong_type_is_refused(port):
    cfg = _file("qwen3-14b")
    cfg["port"] = port
    with pytest.raises(ValueError, match=next(iter(port))):
        port_config(cfg)


def test_port_family_runs_the_ports_dense_family_under_a_new_reference_name():
    """A file whose top-level family names a reference of its own runs the
    port's family that ``"port"`` names: here the port's dense decode,
    against the dense reference's forward."""
    from repro_torch.models import decode_step, init_decode_state
    cfg = _file("qwen3-14b")
    cfg.update(TINY["dense"], family="a-new-family", port={"family": "dense"})
    mcfg = port_config(cfg)
    assert mcfg.family == "dense" and cfg["family"] == "a-new-family"
    fam = bench.reference_module("dense")
    params = fam.make_params(cfg, 3, torch.float32, torch.device("cpu"))
    seq = torch.from_numpy(np.random.default_rng(1).integers(0, cfg["vocab_size"], 16))
    state = init_decode_state(mcfg, 1, len(seq) + 1, dtype=torch.float32, device="cpu")
    got = []
    with torch.no_grad():
        for t in seq.tolist():
            logits, state = decode_step(mcfg, params, state, torch.tensor([[t]]),
                                        dtype=torch.float32)
            got.append(logits[0, -1].float())
    want = fam.logits(cfg, params, [seq], [0], "f32")[0]
    assert torch.allclose(torch.stack(got), want, atol=2e-4, rtol=0)


def test_a_field_the_port_adds_later_is_read_from_its_type():
    """Names and types come from the dataclass: a field of a type the port
    has no instance of yet, a tuple such as a layer pattern, comes from a
    JSON list; a nested dataclass's nested fields merge over its base."""
    import dataclasses
    from typing import Optional, Tuple

    from perfbench.harness import model

    @dataclasses.dataclass(frozen=True)
    class Inner:
        width: int = 1
        scale: float = 1.0

    @dataclasses.dataclass(frozen=True)
    class Later:
        pattern: Tuple[str, ...] = ()
        inner: Optional[Inner] = None

    got = model._fields(Later, {"pattern": ["ssm", "attn"], "inner": {"scale": 2}},
                        {"inner": Inner(width=7)}, "a.json", "port")
    assert Later(**got) == Later(pattern=("ssm", "attn"), inner=Inner(width=7, scale=2.0))
    with pytest.raises(ValueError, match=r"a\.json: port\.inner\.depth"):
        model._fields(Later, {"inner": {"depth": 2}}, {}, "a.json", "port")
