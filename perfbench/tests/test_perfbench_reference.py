"""The plain references against the port at the reduced configurations
(float32 on the CPU), and a lower precision failing where bf16 passes."""
import copy

import numpy as np
import pytest
import torch

from perfbench.harness import bench
from perfbench.harness.model import port_config
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import common
from perfbench.tests.tiny import tiny_cell

SERVE = "grok-1-314b.serve"
TRAIN = "qwen3-14b.train"


def _cfg(workload):
    return tiny_cell(workload).config


def _family(cfg):
    return bench.reference_module(cfg["family"])


def _tokens(n, vocab, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, n))


def _port_decode(cfg, params, seq, dtype):
    """The port's decode step over ``seq`` one token at a time (B = 1) →
    the logits (len, V) f32."""
    from repro_torch.models import decode_step, init_decode_state
    mcfg = port_config(cfg)
    state = init_decode_state(mcfg, 1, len(seq) + 1, dtype=dtype, device="cpu")
    out = []
    with torch.no_grad():
        for t in seq.tolist():
            logits, state = decode_step(mcfg, params, state,
                                        torch.tensor([[t]]), dtype=dtype)
            out.append(logits[0, -1].float())
    return torch.stack(out)


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_reference_forward_matches_the_port_decode(workload):
    """The reference's forward over a whole sequence equals the port's
    decode step fed that sequence token by token (float32): attention over
    the cache, RoPE, the FFN (routing and experts in the MoE) and the head."""
    cfg = _cfg(workload)
    fam = _family(cfg)
    params = fam.make_params(cfg, 3, torch.float32, torch.device("cpu"))
    seq = _tokens(24, cfg["vocab_size"], 1)
    got = _port_decode(cfg, params, seq, torch.float32)
    want = fam.logits(cfg, params, [seq], [0], "f32")[0]
    assert torch.allclose(got, want, atol=2e-4, rtol=0), (got - want).abs().max()


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_lower_precision_fails_where_bf16_passes(workload):
    """Against the float32 reference, the port in bf16 (its serving
    precision) keeps the median position's logit error several times below
    the float8 control's."""
    cfg = _cfg(workload)
    fam = _family(cfg)
    params = fam.make_params(cfg, 4, torch.bfloat16, torch.device("cpu"))
    seq = _tokens(32, cfg["vocab_size"], 2)
    ref = fam.logits(cfg, params, [seq], [0], "f32")[0]
    bf16 = _port_decode(cfg, params, seq, torch.bfloat16)
    fp8 = fam.logits(cfg, params, [seq], [0], "fp8")[0]

    def med_rms(x):
        return float((x - ref).square().mean(-1).sqrt().median())
    assert med_rms(fp8) > 3 * med_rms(bf16)


def test_reference_loss_and_gradients_match_the_port():
    from repro_torch.models import loss_fn
    cfg = _cfg(TRAIN)
    fam = _family(cfg)
    params = fam.make_params(cfg, 5, torch.float32, torch.device("cpu"))
    toks = torch.stack([_tokens(16, cfg["vocab_size"], s) for s in (7, 8)])
    ref_p = copy.deepcopy(params)
    flat = [t for _, t in common.walk(params)]
    for t in flat:
        t.requires_grad_(True)
    loss, _ = loss_fn(port_config(cfg), params, {"tokens": toks, "labels": toks},
                      dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    rflat = [t for _, t in common.walk(ref_p)]
    for t in rflat:
        t.requires_grad_(True)
    rloss = sum(fam.row_loss(cfg, ref_p, r) for r in toks) / toks.shape[0]
    rloss.backward()
    assert loss.item() == pytest.approx(rloss.item(), rel=1e-5)
    for g, t in zip(grads, rflat):
        assert torch.allclose(g, t.grad, atol=1e-6, rtol=1e-4)


def test_reference_adamw_matches_the_port():
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import adamw_update, init_opt_state
    opt = bench.load_cell(TRAIN).traffic["optimizer"]
    opt = dict(opt, warmup_steps=2, total_steps=10, lr=1e-2, grad_clip=0.5)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(4, 6, generator=g), "b": {"c": torch.randn(5, generator=g)}}
    mine = copy.deepcopy(params)
    state = init_opt_state(params)
    flat = [t for _, t in common.walk(mine)]
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    for step in range(1, 4):
        grads = {"a": torch.randn(4, 6, generator=g), "b": {"c": torch.randn(5, generator=g)}}
        params, state, met = adamw_update(params, grads, state, OptimizerConfig(**opt))
        gn = ref_adamw.step(flat, [t for _, t in common.walk(grads)], m, v, step, opt)
        assert gn == pytest.approx(float(met["grad_norm"]), rel=1e-6)
    for (_, a), b in zip(common.walk(params), flat):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5)
