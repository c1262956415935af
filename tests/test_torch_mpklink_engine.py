"""The main path without the gateway, on the CPU: the port's
``MPKLinkOptTransport`` serves the port's ``EngineService`` for reduced
llama3.2-1b (and the hybrid zamba2-2.7b), and the tokens equal those the reference's
``MPKLinkOptTransport`` gives in front of the JAX ``EngineService`` with
the same (converted) parameters: four concurrent sessions in lockstep,
then the same prompts through one session's ring (``call_batch``). Each
response crosses the wire as the handler's int32 token bytes."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.transports import MPKLinkOptTransport as JMPKLinkOptTransport
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.runtime import EngineService as JEngineService
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.transports import MPKLinkOptTransport
from repro_torch.runtime import EngineService, ServingEngine, encode_prompt

PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42]]
MAX_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tokens(resp) -> list:
    raw = resp.cpu().numpy() if isinstance(resp, torch.Tensor) else np.asarray(resp)
    return np.frombuffer(np.ascontiguousarray(raw).tobytes(), np.int32).tolist()


def _through_sessions(tr, svc):
    """Four concurrent lockstep sessions, then the four prompts as one
    ring batch through a fifth session."""
    try:
        sessions = [tr.connect(f"client-{i}") for i in range(len(PROMPTS))]
        lock, errors = {}, []

        def client(i):
            try:
                lock[i] = _tokens(sessions[i].request(encode_prompt(PROMPTS[i], MAX_NEW)))
            except BaseException as e:      # noqa: B036 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        ring = tr.connect("ring")
        batch = [_tokens(r) for r in ring.call_batch(
            [encode_prompt(p, MAX_NEW) for p in PROMPTS])]
        syncs = ring.sync_count
    finally:
        tr.close()
        svc.close()
    return [lock[i] for i in range(len(PROMPTS))], batch, syncs


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_port_mpklink_opt_serves_the_port_engine(arch):
    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JServingEngine(jcfg, jparams, max_batch=4, max_seq=32,
                          impl=JImpl(attention="naive", remat=False))
    jsvc = JEngineService(jeng, timeout=120.0).start()
    want = _through_sessions(JMPKLinkOptTransport(jsvc.handler, timeout=120.0,
                                                  max_keys=32), jsvc)
    eng = ServingEngine(get_reduced(arch), tparams, max_batch=4, max_seq=32,
                        dtype=torch.float32, device="cpu")
    svc = EngineService(eng, timeout=120.0).start()
    got = _through_sessions(MPKLinkOptTransport(svc.handler, timeout=120.0,
                                                max_keys=32, device="cpu"), svc)
    assert got == want
    lock, batch, syncs = got
    assert lock == batch
    assert all(len(t) == MAX_NEW for t in lock)
    assert syncs == 2                   # one flush, one drain pass
