"""What the port's gateway keeps past a request owns its memory, and what
its guard kernels read starts 16-byte aligned.

* The dedup window holds clones: mutating the tensor a response was put
  from leaves the cached answer as it was.
* Scatter envelopes pushed through the transport's ring (their requests
  are views of arena slots that the transport hands out again) until the
  ring and the arena wrap, then a lost-response replay of the first
  token: the answer is still the original bytes, and the handler ran once.
* A frame carved from a response behind an error blob (padded to 4 bytes
  only) is copied to an aligned tensor; an aligned one is viewed in place.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ServiceGateway, framing, gateway
from repro_torch.core.gateway import GW_MAGIC, _OK, _SOK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gateway's tensors are tiny: one intra-op thread a worker keeps
    its latencies (which the routers and breakers act on) steady when the
    tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dedup_window_owns_its_bytes():
    gw = ServiceGateway("mpklink_opt", device="cpu")
    gw.register_service("echo", lambda r: r)
    try:
        svc = gw._services["echo"]
        base = torch.arange(64, dtype=torch.int32)
        view = base[8:24]
        gw._dedup_put(svc, 1, 77, view)
        base.fill_(-1)
        got = gw._dedup_get(svc, 1, 77)
        assert got.tolist() == list(range(8, 24))
        assert got.data_ptr() != view.data_ptr()
    finally:
        gw.close()


def _scatter_env(cid, chan, token, payload, seq):
    frame = framing.build_frame(payload, seed=chan.seed, seq=seq, device="cpu")
    return np.concatenate([
        np.array([gateway.GW_SCAT_MAGIC, cid, 1, 0], "<u4").view(np.uint8),
        np.array([GW_MAGIC, chan.sid, token, 0], "<u4").view(np.uint8),
        frame.numpy().reshape(-1).view(np.uint8)])


def _answer(resp, chan, seq):
    raw = resp.reshape(-1).view(torch.uint8)
    hb = gateway._HostBytes(raw)
    route = hb.words(0, 4)
    assert route[0] == GW_MAGIC and route[1] == _SOK and route[3] == 1
    [(status, (frame, hdr))] = gateway._read_items(hb, 1, "scatter")
    assert status == _OK
    return framing.verify_view(frame, seed=chan.seed, expect_seq=seq,
                               header=hdr)


def test_dedup_replay_after_ring_wrap_returns_original_bytes():
    runs = []

    def echo(req):
        runs.append(1)
        return req                      # the response views the request

    gw = ServiceGateway("mpklink_opt", device="cpu",
                        transport_kwargs={"ring_slots": 2})
    gw.register_service("echo", echo)
    gw.start()
    try:
        client = gw.connect("ringer")
        chan = client.open("echo")
        session = gw.transport.connect("ring")      # a raw ring session
        tokens = client.mint_tokens(12)
        payloads = [np.full(300, 1000 + k, np.int32) for k in range(12)]
        envs = [_scatter_env(client.cid, chan, t, p, seq)
                for seq, (t, p) in enumerate(zip(tokens, payloads))]
        first = None
        reused0 = framing.STATS.snapshot()["arena_reused"]
        for k in range(0, 12, 2):           # 6 windows through 2 ring slots
            outs = session.call_batch(envs[k:k + 2])
            for j, out in enumerate(outs):
                ans = _answer(out, chan, k + j)
                np.testing.assert_array_equal(ans.numpy(), payloads[k + j])
                if first is None:
                    first = ans.clone()
        assert framing.STATS.snapshot()["arena_reused"] > reused0
        assert len(runs) == 12
        deduped = gw.stats["deduped"]
        [replay] = session.call_batch([envs[0]])    # a lost-response replay
        ans = _answer(replay, chan, 0)
        np.testing.assert_array_equal(ans.numpy(), payloads[0])
        assert torch.equal(ans, first)
        assert len(runs) == 12 and gw.stats["deduped"] == deduped + 1
    finally:
        gw.close()


@pytest.mark.parametrize("ofs, copied", [(16, False), (32, False), (20, True),
                                         (44, True)])
def test_misaligned_frame_is_copied_before_the_guard(ofs, copied):
    frame = framing.build_frame(np.arange(40, dtype=np.int32), seed=9, seq=3,
                                device="cpu")
    nb = frame.numel() * 4
    raw = torch.zeros(ofs + nb + 8, dtype=torch.uint8)
    assert raw.data_ptr() % 16 == 0
    raw[ofs:ofs + nb] = frame.reshape(-1).view(torch.uint8)
    got = gateway._frame_view(raw, ofs, nb)
    assert got.data_ptr() % 16 == 0
    assert (got.data_ptr() != raw[ofs:].data_ptr()) == copied
    out = framing.verify_view(got, seed=9, expect_seq=3)
    assert out.tolist() == list(range(40))
