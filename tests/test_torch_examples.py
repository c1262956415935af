"""The port's examples (``repro_torch.examples``) run on the CPU at their
smallest settings, each under a wall-clock bound, and their checks hold:
every ``main`` raises when a check fails and prints its ``... OK`` line
when all pass. Beside them, the parts that have a reference twin are held
to it: the chaos storm's outcome sequence (strict and healing) equals the
reference's ``examples/chaos_demo.py`` for the same seed, ``train_e2e``'s
model equals the reference's ``build_config``, and ``serve_decode``
offers the reference's architectures. The fabric demo (four ranks) is in
``test_torch_examples_fabric.py``."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

import torch_proc_handlers as H
from repro_torch.examples import (chaos_demo, gateway_demo, mpklink_demo,
                                  quickstart, serve_decode, train_e2e)
from repro_torch.examples._common import parser

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _bounded_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with H.bounded(120):
        yield
    torch.set_num_threads(before)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_defaults_to_the_card():
    assert parser(__doc__).parse_args([]).device == "cuda"


def test_mpklink_demo(capsys):
    mpklink_demo.main(CPU)
    out = capsys.readouterr().out
    for line in ("200000 words → count=200000", "revoked key rejected",
                 "forged seed rejected", "tampered frame rejected",
                 "tampered payload:   ok=0", "mpklink_demo OK"):
        assert line in out, line
    assert out.count(" µs") == 6                    # all six transports


def test_gateway_demo(capsys):
    gateway_demo.main(CPU)
    out = capsys.readouterr().out
    for line in ("80 requests", "errors=[]", "CA refused foreign client",
                 "allow-listed client served", "forged frame rejected by the guard",
                 "CA re-keyed him transparently", "banned client refused re-key",
                 "gateway_demo OK"):
        assert line in out, line


def test_a_failed_check_raises(monkeypatch):
    """An example raises on a wrong answer; it never prints and goes on."""
    monkeypatch.setattr(gateway_demo, "parse_count", lambda resp: -1)
    with pytest.raises(AssertionError, match="errors"):
        gateway_demo.main(CPU)
    monkeypatch.setattr(mpklink_demo, "parse_count", lambda resp: -1)
    with pytest.raises(AssertionError, match="word count"):
        mpklink_demo.main(CPU)


def test_chaos_demo(capsys):
    chaos_demo.main(CPU)
    out = capsys.readouterr().out
    for line in ("outcome sequences identical: True", "'error': 0",
                 "SHED", "final health: {'state': 'closed'", "chaos_demo OK"):
        assert line in out, line


def _signature(sig):
    """A storm's outcome sequence with the answer's type named alike (the
    reference answers arrays, the port tensors)."""
    return [(i, status, kind, "answer" if t in ("ndarray", "Tensor") else t)
            for i, status, kind, t in sig]


@pytest.mark.parametrize("retries", [0, 3])
def test_chaos_storm_equals_the_reference(retries):
    ref = _reference_example("chaos_demo")
    plan, sig, counts, _ = chaos_demo.run_storm("cpu", chaos_demo.SEED, retries)
    rplan, rsig, rcounts, _ = ref.run_storm(seed=chaos_demo.SEED, retries=retries)
    assert plan.spec() == rplan.spec()
    assert [(e.index, e.kind) for e in plan.schedule()] == [
        (e.index, e.kind) for e in rplan.schedule()]
    assert _signature(sig) == _signature(rsig)
    assert counts == rcounts


def test_quickstart(capsys):
    quickstart.main(CPU + ["--steps", "10"])
    out = capsys.readouterr().out
    assert "word count over MPKLink channel: 10000" in out
    assert "forged frame rejected" in out and "quickstart OK" in out
    toks = ast.literal_eval(out.split("greedy decode:")[1].splitlines()[0].strip())
    assert len(toks) == quickstart.DECODE_TOKENS


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "llama3.2-1b"])
def test_serve_decode(arch, capsys):
    serve_decode.main(CPU + ["--arch", arch, "--requests", "6"])
    out = capsys.readouterr().out
    assert "6 requests" in out and "serve_decode OK" in out
    assert "served tokens agree with the full-sequence forward" in out


def test_serve_decode_offers_the_reference_archs():
    src = (ROOT / "examples" / "serve_decode.py").read_text()
    choices = next(kw.value for node in ast.walk(ast.parse(src))
                   if isinstance(node, ast.Call) for kw in node.keywords
                   if kw.arg == "choices")
    assert serve_decode.ARCHS == ast.literal_eval(choices)


def test_train_e2e_restarts_from_its_checkpoint(capsys):
    train_e2e.main(CPU + ["--steps", "24", "--width", "64", "--layers", "2",
                          "--seq", "32", "--checkpoint-every", "8",
                          "--fail-at", "13"])
    out = capsys.readouterr().out
    assert "restarts           : 1" in out
    assert "steps run          : 29" in out           # 24 + (13 - 8) again
    assert "IMPROVED" in out and "train_e2e OK" in out
    assert "restarting from last checkpoint" in out


@pytest.mark.parametrize("width,layers", [(128, 4), (64, 2), (960, 32)])
def test_train_e2e_model_equals_the_reference(width, layers):
    ref = _reference_example("train_e2e").build_config(width, layers)
    mine = train_e2e.build_config(width, layers)
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "tie_embeddings"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", serve_decode.ARCHS)
def test_example_models_fit_the_kernels_tiles(arch):
    """The examples' models take the kernels' shapes on the card (the
    reference's reduced heads are narrower than any kernel's tile): flash
    attention's head dims, decode attention's group and width, the SSD
    scan's multiples of 32; depth, head counts and widths stay reduced."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples._common import kernel_tiled
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    base = get_reduced(arch)
    cfg = kernel_tiled(base)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == (
        base.num_layers, base.d_model, base.num_heads, base.vocab_size)
    if cfg.num_heads:
        assert cfg.head_dim in flash_attention.HEAD_DIMS
        assert cfg.head_dim <= decode_attention.MAX_HEAD_DIM
        assert cfg.num_heads // cfg.num_kv_heads <= decode_attention.MAX_GROUP
    if cfg.ssm is not None:
        s = cfg.ssm
        assert s.head_dim % 32 == 0 and s.head_dim <= ssd_scan.MAX_P
        assert s.d_state % 32 == 0 and s.d_state <= ssd_scan.MAX_N
        assert s.chunk_size % 32 == 0 and s.chunk_size <= ssd_scan.MAX_CHUNK
    q = train_e2e.build_config(128, 4)                 # train_e2e's default
    assert q.head_dim in flash_attention.HEAD_DIMS
