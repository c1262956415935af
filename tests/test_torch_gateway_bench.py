"""The gateway's entry point on the CPU: ``repro_torch.core``'s exports,
the launch and key-sync arithmetic of ``launch/gateway_bench.py`` held to
launches counted from the code (the kernels' plain versions stand in for
them and are counted as the card counts its kernels), and each of the
benchmark's five cells run small."""
import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.core import ServiceGateway, framing
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import mpk_guard as _mg
from repro_torch.kernels import ops
from repro_torch.launch import gateway_bench as gb

GUARD = ("guard_copy", "mac_batch", "mac_init_state", "mac_update", "mac_finalize")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gateway's tensors are tiny: one intra-op thread a worker keeps
    its latencies steady when the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_core_exports():
    for name in ("ServiceGateway", "GatewayClient", "CallCoalescer",
                 "ServiceHealth", "ReplicaRouter", "Replica", "ServiceFleet",
                 "simulate_assignments", "ALL_TRANSPORTS"):
        assert name in core.__all__ and hasattr(core, name)
    # the reference's composition: the in-process transports plus the
    # process transports and the REST / socket-RPC baselines
    assert core.ALL_TRANSPORTS == {**core.TRANSPORTS, **core.PROC_TRANSPORTS,
                                   **core.BASELINE_TRANSPORTS}
    from repro.core import ALL_TRANSPORTS as REF
    assert sorted(core.ALL_TRANSPORTS) == sorted(REF)


@pytest.fixture
def counted(monkeypatch):
    """Route the guard kernels' calls on CPU tensors through their plain
    versions while counting each as a launch, and let the arithmetic
    answer as it does for the card."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    for name in ("guard_copy", "mac_batch", "mac_update", "mac_finalize"):
        monkeypatch.setattr(_mg, f"{name}_cuda", getattr(_mg, f"{name}_plain"))
    monkeypatch.setattr(_da, "decode_attention_cuda", _da.decode_attention_plain)

    def mac_init_state(tag, device):
        ops.LAUNCHES.bump("mac_init_state")
        return _mg.mac_init_state_plain(tag, torch.device(device))

    monkeypatch.setattr(ops, "mac_init_state", mac_init_state)
    monkeypatch.setattr(gb, "_on_card", lambda device: True)
    gw = ServiceGateway("mpklink_opt", device="cpu")
    gw.register_service("wc", wordcount_handler)
    gw.register_service("echo", lambda r: r)
    gw.start()
    client = gw.connect("counter")
    client.open("wc")
    client.open("echo")
    yield gw, client
    gw.close()


def _count(gw, fn):
    ops.LAUNCHES.reset()
    syncs0 = gw.transport.sync_count
    out = fn()
    got = {k: v for k, v in ops.LAUNCHES.snapshot().items() if k in GUARD and v}
    return out, got, gw.transport.sync_count - syncs0


@pytest.mark.parametrize("n_words", [5, 200, 3000])
def test_single_envelope_launches(counted, n_words):
    gw, client = counted
    text = make_text(n_words, seed=n_words)
    out, got, syncs = _count(gw, lambda: client.call("wc", text))
    assert parse_count(out) == n_words
    assert got == gb.single_launches(text.nbytes, 8, "cuda")
    assert got["guard_copy"] == 4
    assert syncs == gb.envelope_syncs(gw.transport,
                                      gb.single_bytes(text.nbytes, 8)[0]) == 2


def test_batch_envelope_launches(counted):
    gw, client = counted
    pays = [np.arange(n, dtype=np.int32) for n in (3, 3, 200, 700)]
    outs, got, syncs = _count(gw, lambda: client.call_batch("echo", pays))
    assert [o.tolist() for o in outs] == [p.tolist() for p in pays]
    sizes = [p.nbytes for p in pays]
    assert got == gb.batch_launches(sizes, sizes, "cuda")
    assert got["mac_batch"] == 2 * 3 + 2 * 3          # three row counts
    assert syncs == 2


def test_scatter_envelope_launches(counted):
    gw, client = counted
    texts = [make_text(n, seed=n) for n in (10, 120)]
    items = [("echo", np.arange(5, dtype=np.int32)), ("wc", texts[0]),
             ("echo", np.arange(300, dtype=np.int32)), ("wc", texts[1])]
    outs, got, syncs = _count(gw, lambda: client.call_many(items))
    assert [parse_count(outs[1]), parse_count(outs[3])] == [10, 120]
    sizes = [(s, p.nbytes, p.nbytes if s == "echo" else 8) for s, p in items]
    assert got == gb.scatter_launches(sizes, "cuda")
    assert got["guard_copy"] == 2 + len(items)
    assert syncs == 2


def test_launch_arithmetic_is_empty_on_the_cpu():
    assert gb.single_launches(100, 8, "cpu") == {}
    assert gb.batch_launches([100], [8], "cpu") == {}
    assert gb.scatter_launches([("wc", 100, 8)], "cpu") == {}


def test_bench_cells_run_small_on_the_cpu():
    gw = ServiceGateway("mpklink_opt", device="cpu")
    gw.register_service("wordcount", wordcount_handler)
    gw.register_service("digest", gb.digest_handler)
    gw.start()
    try:
        cell = gb.run_cell(gw, "wordcount", 3, 2,
                           lambda i, j: make_text(20 + i + j, seed=j))
        assert cell["requests"] == 6 and cell["all_macs_verified"]
        assert cell["key_syncs"] == 12
        for mode, k in (("lockstep", 1), ("batched", 4)):
            cell = gb.run_batch_cell(gw, "wordcount", k, 8,
                                     lambda j: make_text(30, seed=j), mode)
            assert cell["messages"] == 8 and cell["all_macs_verified"]
        cell = gb.run_payload_cell(gw, 4096, 2, in_flight=2)
        assert cell["requests"] == 4 and cell["macs_verified_clients"] >= 4
    finally:
        gw.close()
    seq = gb.run_scatter_cell("mpklink_opt", 0, 3, 2, "sequential", device="cpu")
    sc = gb.run_scatter_cell("mpklink_opt", 2, 3, 2, "scatter", device="cpu")
    assert seq["requests"] == sc["requests"] == 6
    assert sc["scatter_envelopes"] == 2 and sc["rejected"] == 0
    assert sum(s["executed"] for s in sc["shards"]) == 6
    fan = [gb.run_fanin_cell("mpklink_opt", 6, 2, c, device="cpu")
           for c in (False, True)]
    assert all(f["all_macs_verified"] and not f["errors"] for f in fan)
    assert fan[1]["coalescer"]["coalesced_calls"] == 12
    summary = gb.summarize([], [], [seq, sc], fan)
    assert summary["scatter_speedup_vs_sequential"]["workers2"] is not None
    assert summary["fanin_speedup_coalesced_over_inline"]["mpklink_opt/6c"] is not None


def test_digest_handler_sums_bytes():
    req = torch.arange(10, dtype=torch.int32)
    want = int(req.numpy().view(np.uint8).sum())
    out = gb.digest_handler(req)
    assert out.dtype == torch.int64 and int(out[0]) == want
    assert int(gb.make_micro_handler(3, delay=0.0)(req)[0]) == want + 3
    assert framing.frame_rows(out.numel() * 8) == 2
