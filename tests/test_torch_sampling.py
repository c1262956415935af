"""Non-greedy sampling in the port's ``ServingEngine`` (the reference's
``greedy=False``). JAX's PRNG stream is not reproduced in torch, so the
draws are held to the categorical they come from, not token for token:
over fixed logits, the frequencies of 20,000 draws match the softmax
(chi-square, p > 1e-3); the same seed gives the same tokens, another seed
other tokens; and ``greedy=True`` (the default) is the argmax, as before.
Reduced llama3.2-1b on the CPU."""
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import get_reduced
from repro_torch.models.model import init_params
from repro_torch.runtime import Request, ServingEngine

CFG = get_reduced("llama3.2-1b")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _engine(params, **kw):
    return ServingEngine(CFG, params, max_batch=4, max_seq=32, device="cpu",
                         **kw)


def _run(eng, prompts, max_new=8):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    done = eng.run_until_drained()
    return {r.rid: r.generated for r in done}


PROMPTS = [[5, 9, 2], [7, 7, 1, 3], [11], [4, 8, 15, 16]]


def test_draws_follow_the_softmax(params):
    eng = _engine(params, greedy=False, seed=1234)
    logits = torch.full((CFG.vocab_size,), -40.0)
    hot = torch.tensor([3, 17, 40, 99, 128, 255])
    logits[hot] = torch.tensor([0.0, 1.0, -0.5, 2.0, 0.3, 1.5])
    n = 20_000
    draws = eng.sample(logits.expand(n, -1)).numpy()
    assert draws.shape == (n,)
    probs = torch.softmax(logits.double(), -1).numpy()
    observed = np.array([(draws == int(t)).sum() for t in hot]
                        + [np.isin(draws, hot.numpy(), invert=True).sum()])
    expected = np.append(probs[hot.numpy()], 1.0 - probs[hot.numpy()].sum()) * n
    assert observed[-1] == 0                 # the cold tokens: e^-40
    chi2 = stats.chisquare(observed[:-1], expected[:-1] * n / expected[:-1].sum())
    assert chi2.pvalue > 1e-3, (observed, expected)


def test_same_seed_same_tokens_other_seed_other_tokens(params):
    a = _run(_engine(params, greedy=False, seed=7), PROMPTS)
    b = _run(_engine(params, greedy=False, seed=7), PROMPTS)
    c = _run(_engine(params, greedy=False, seed=8), PROMPTS)
    assert a == b
    assert a != c
    assert all(0 <= t < CFG.vocab_size for toks in a.values() for t in toks)
    assert all(len(toks) == 8 for toks in a.values())


def test_greedy_is_unchanged(params):
    default = _run(_engine(params), PROMPTS)
    greedy = _run(_engine(params, greedy=True, seed=99), PROMPTS)
    assert default == greedy
    eng = _engine(params)
    last = torch.randn(5, CFG.vocab_size, generator=torch.Generator().manual_seed(3))
    assert torch.equal(eng.sample(last), last.argmax(-1))
    # sampling is not greedy: at temperature 1 the draws leave the argmax
    sampled = _run(_engine(params, greedy=False, seed=7), PROMPTS)
    assert sampled != default
