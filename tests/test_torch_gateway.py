"""The main path end to end on the CPU: an unchanged
``repro.core.ServiceGateway`` over ``mpklink_opt`` serves the port's
``EngineService`` (``handler`` and ``handler_batch``) for reduced
llama3.2-1b and reduced zamba2-2.7b, and the tokens equal those the JAX
engine gives behind the same gateway with the same (converted) parameters,
for lockstep calls and for one batch envelope (the pattern of
``tests/test_coalescer.py``'s engine-service test)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import ServiceGateway
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.runtime import EngineService as JEngineService
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.runtime import EngineService, ServingEngine, encode_prompt

PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42]]
MAX_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _through_gateway(svc):
    """Four lockstep calls, then the same four prompts as one batch
    envelope, through a fresh mpklink_opt gateway in front of ``svc``."""
    gw = ServiceGateway("mpklink_opt", max_keys=512,
                        transport_kwargs={"timeout": 120.0})
    gw.register_service("infer", svc.handler, batch_handler=svc.handler_batch)
    gw.start()
    try:
        client = gw.connect("client")
        client.open("infer")
        lock = [np.asarray(client.call("infer", encode_prompt(p, MAX_NEW))).tolist()
                for p in PROMPTS]
        batch = [np.asarray(r).tolist() for r in client.call_batch(
            "infer", [encode_prompt(p, MAX_NEW) for p in PROMPTS])]
    finally:
        gw.close()
        svc.close()
    return lock, batch


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_reference_gateway_serves_the_port_engine(arch):
    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JServingEngine(jcfg, jparams, max_batch=4, max_seq=32,
                          impl=JImpl(attention="naive", remat=False))
    want = _through_gateway(JEngineService(jeng, timeout=120.0).start())
    eng = ServingEngine(get_reduced(arch), tparams, max_batch=4, max_seq=32,
                        dtype=torch.float32, device="cpu")
    got = _through_gateway(EngineService(eng, timeout=120.0).start())
    assert got == want
    assert all(len(t) == MAX_NEW for part in got for t in part)


def _all_paths(gw, svc):
    """Four lockstep calls, one batch envelope, one scatter envelope and
    four coalesced concurrent calls of the same prompts through ``gw`` in
    front of ``svc`` → the tokens of each path."""
    import threading

    gw.register_service("infer", svc.handler, batch_handler=svc.handler_batch)
    gw.start()
    try:
        client = gw.connect("client")
        client.open("infer")
        reqs = [encode_prompt(p, MAX_NEW) for p in PROMPTS]
        lock = [np.asarray(client.call("infer", r)).tolist() for r in reqs]
        batch = [np.asarray(r).tolist()
                 for r in client.call_batch("infer", reqs)]
        scatter = [np.asarray(r).tolist()
                   for r in client.call_many([("infer", r) for r in reqs])]
        gw.enable_coalescing(max_batch=8, max_wait_us=20000.0)
        callers = [gw.connect(f"caller-{i}") for i in range(len(reqs))]
        coalesced, errors = [None] * len(reqs), []

        def call(i):
            try:
                coalesced[i] = np.asarray(callers[i].call("infer", reqs[i])).tolist()
            except Exception as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errors, errors
    finally:
        gw.close()
        svc.close()
    return lock, batch, scatter, coalesced


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_port_gateway_serves_the_port_engine(arch):
    """The main path with the port on both sides: the port's
    ``ServiceGateway`` and ``GatewayClient`` over the port's
    ``mpklink_opt`` serve the port's ``EngineService``, and every path
    (lockstep, batch, scatter, coalesced) gives the tokens of the JAX
    gateway in front of the JAX engine."""
    from repro_torch.core import ServiceGateway as PServiceGateway

    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JServingEngine(jcfg, jparams, max_batch=4, max_seq=32,
                          impl=JImpl(attention="naive", remat=False))
    want = _all_paths(ServiceGateway("mpklink_opt", max_keys=512,
                                     transport_kwargs={"timeout": 120.0}),
                      JEngineService(jeng, timeout=120.0).start())
    eng = ServingEngine(get_reduced(arch), tparams, max_batch=4, max_seq=32,
                        dtype=torch.float32, device="cpu")
    psvc = EngineService(eng, timeout=120.0).start()
    got = _all_paths(PServiceGateway("mpklink_opt", max_keys=512, device="cpu",
                                     transport_kwargs={"timeout": 120.0}), psvc)
    assert got == want
    assert all(len(t) == MAX_NEW for part in got for t in part)
    assert psvc.cohorts and max(psvc.cohorts) > 1
