"""``register_engine_fleet`` in the port: reduced llama3.2-1b in f32 behind
two replica processes (the default ``mpklink_opt_proc``) answers with the
greedy tokens of the reference's ``register_engine_fleet`` in front of the
JAX engine on the same (converted) parameters; the replica handler
pickles without its service and builds its engine in its child; the
``FLEET_STATS`` request reports a replica's ticks and kernel launches."""
import functools
import json
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro.configs import get_reduced as jget_reduced
from repro.core import ServiceGateway as JGateway
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.runtime import ServingEngine as JServingEngine
from repro.runtime import encode_prompt as jencode_prompt
from repro.runtime.serve import register_engine_fleet as jregister_engine_fleet
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import ServiceGateway, procwire
from repro_torch.runtime import (FleetHandler, ServingEngine,
                                 encode_prompt, register_engine_fleet)
from repro_torch.runtime.serve import FLEET_STATS

pytestmark = pytest.mark.proc

MAX_BATCH, MAX_SEQ, MAX_NEW = 4, 48, 5
PROMPTS = [[(7 * i + j) % 200 + 1 for j in range(2 + i % 4)] for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _port_proc_hygiene(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    H.proc_hygiene(request.module.__name__)


@pytest.fixture(autouse=True)
def _bounded():
    with H.bounded(150):
        yield


@pytest.fixture(scope="module")
def params():
    jparams = jinit_params(jget_reduced("llama3.2-1b"), jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _factory(tparams):
    return functools.partial(ServingEngine, get_reduced("llama3.2-1b"),
                             tparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                             dtype=torch.float32, device="cpu")


def _reference_tokens(jparams):
    jcfg = jget_reduced("llama3.2-1b")
    gw = JGateway("mpklink_opt", transport_kwargs={"timeout": 120.0})
    jregister_engine_fleet(
        gw, "infer", lambda: JServingEngine(
            jcfg, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
            impl=JImpl(attention="naive", remat=False)),
        replicas=2, transport="mpklink_opt")
    gw.start()
    try:
        cli = gw.connect("ref")
        return [np.ascontiguousarray(cli.call("infer", jencode_prompt(
            p, MAX_NEW))).view(np.uint8).view(np.int32).tolist()
            for p in PROMPTS]
    finally:
        gw.close()


def test_register_engine_fleet_tokens_match_the_reference(params):
    jparams, tparams = params
    want = _reference_tokens(jparams)
    gw = ServiceGateway("mpklink_opt", device="cpu",
                        transport_kwargs={"timeout": 120.0})
    rids = register_engine_fleet(gw, "infer", _factory(tparams), replicas=2,
                                 transport_kwargs={"timeout": 120.0})
    gw.start()
    try:
        assert rids == [0, 1]
        fleet = gw.fleet("infer")
        for rep in fleet._replicas.values():
            assert isinstance(rep.transport, procwire.ProcMPKLinkOptTransport)
        got, errors = {}, []

        def client(i):
            try:
                cli = gw.connect(f"c{i}")
                for k in range(i, len(PROMPTS), 3):
                    got[k] = H.host(cli.call(
                        "infer", encode_prompt(PROMPTS[k], MAX_NEW))) \
                        .view(np.int32).tolist()
                cli.close()
            except Exception as e:          # reported below
                errors.append(repr(e))

        ts = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        assert [got[k] for k in range(len(PROMPTS))] == want
        # both replicas served, each in a child process of its own
        pids = {rep.session._proc.pid for rep in fleet._replicas.values()
                if rep.session._proc is not None}
        assert len(pids) == sum(1 for s in fleet.snapshot() if s["served"])
    finally:
        gw.close()


def test_fleet_handler_pickles_without_its_service(params):
    _, tparams = params
    h = FleetHandler(_factory(tparams), timeout=30.0)
    out = h(encode_prompt([1, 2, 3], 2))
    assert np.asarray(out).size == 2
    assert h._svc is not None
    clone = pickle.loads(pickle.dumps(h))
    assert clone._svc is None and h._svc is not None
    assert clone.engine_factory.args[0] == h.engine_factory.args[0]
    h.close()


def test_fleet_stats_request_reports_ticks_and_launches(params):
    _, tparams = params
    assert FLEET_STATS.dtype == np.int32 and FLEET_STATS[0] < 0
    gw = ServiceGateway("mpklink_opt", device="cpu",
                        transport_kwargs={"timeout": 120.0})
    register_engine_fleet(gw, "infer", _factory(tparams), replicas=1,
                          transport_kwargs={"timeout": 120.0})
    gw.start()
    try:
        cli = gw.connect("c0")
        out = cli.call("infer", encode_prompt([5, 6, 7], 3))
        assert H.host(out).view(np.int32).size == 3
        rep = gw.fleet("infer")._replicas[0]
        doc = json.loads(H.host(rep.session.request(FLEET_STATS)).tobytes())
        # 3 prompt tokens fed + 3 generated, one a tick (the first
        # generated token comes from the last prompt token's tick)
        assert doc["ticks"] == 3 + 3 - 1
        assert set(doc["launches"]) >= {"decode_attention", "guard_copy"}
        assert all(v == 0 for v in doc["launches"].values())   # the CPU
        assert all(v == 0 for v in rep.session.child_launches().values())
        assert doc["card_bytes"] == 0                           # the CPU
        cli.close()
    finally:
        gw.close()
