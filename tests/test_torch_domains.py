"""The MPKLink control plane of both packages: ``tests/test_core.py``'s
domain, PKRU, signature and CA cases run through ``repro.core`` and
``repro_torch.core`` alike, and the same operations give the same domain
tags, key nonces, PKRU words, signatures and session seeds in both (the
port's copies are held to the reference's, so frames cross-parse)."""
import pytest

from repro.core import ca as jca
from repro.core import domains as jdomains
from repro.core import signature as jsig

from repro_torch.core import ca as tca
from repro_torch.core import domains as tdomains
from repro_torch.core import signature as tsig

PACKAGES = {"port": (tdomains, tca, tsig), "reference": (jdomains, jca, jsig)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# -- domains / PKRU ----------------------------------------------------------

def test_domain_allocation_and_exhaustion(pkg):
    d, _, _ = pkg
    reg = d.KeyRegistry(max_keys=4)
    doms = [reg.allocate_domain(f"d{i}") for i in range(4)]
    assert len({x.did for x in doms}) == 4
    with pytest.raises(ResourceWarning):
        reg.allocate_domain("overflow")          # pkey_alloc ENOSPC analogue
    reg.free_domain(doms[1])
    assert reg.allocate_domain("again").did == doms[1].did


def test_rights_enforced(pkg):
    d, _, _ = pkg
    reg = d.KeyRegistry()
    dom = reg.allocate_domain("c")
    ro = reg.issue_key(dom, d.READ)
    reg.check(ro, d.READ)
    with pytest.raises(d.AccessViolation):
        reg.check(ro, d.WRITE)
    with pytest.raises(d.AccessViolation):
        reg.check(ro, d.RW)


def test_revocation_and_epoch(pkg):
    d, _, _ = pkg
    reg = d.KeyRegistry()
    dom = reg.allocate_domain("c")
    k1 = reg.issue_key(dom, d.RW)
    k2 = reg.issue_key(dom, d.RW)
    reg.check(k1, d.RW)
    reg.revoke(k1)
    with pytest.raises(d.AccessViolation):
        reg.check(k1, d.READ)                       # revoked
    with pytest.raises(d.AccessViolation):
        reg.check(k2, d.READ)                       # stale epoch after revoke
    k3 = reg.issue_key(dom, d.RW)
    reg.check(k3, d.RW)                             # fresh key at new epoch
    assert d.mac_seed(dom, 0) != d.mac_seed(dom, reg.epoch(dom))


def test_retire_keeps_the_epoch(pkg):
    d, _, _ = pkg
    reg = d.KeyRegistry()
    dom = reg.allocate_domain("c")
    k1, k2 = reg.issue_key(dom), reg.issue_key(dom)
    reg.retire(k1)
    with pytest.raises(d.AccessViolation):
        reg.check(k1, d.READ)
    reg.check(k2, d.RW)
    assert reg.epoch(dom) == 0


def test_foreign_registry_key_rejected(pkg):
    d, _, _ = pkg
    reg_a, reg_b = d.KeyRegistry(seed=1), d.KeyRegistry(seed=2)
    dom_b = reg_b.allocate_domain("b")
    key_b = reg_b.issue_key(dom_b)
    with pytest.raises(d.AccessViolation):
        reg_a.check(key_b, d.READ)


def test_pkru_word_layout(pkg):
    d, _, _ = pkg
    reg = d.KeyRegistry()
    d0 = reg.allocate_domain("d0")
    d1 = reg.allocate_domain("d1")
    k0 = reg.issue_key(d0, d.RW)
    k1 = reg.issue_key(d1, d.READ)
    word = reg.pkru_word((k0, k1))
    assert (word >> 0) & 0b11 == 0b00             # RW
    assert (word >> 2) & 0b11 == 0b10             # read-only: write-disable
    assert (word >> 4) & 0b11 == 0b11             # unallocated: no access


def test_same_operations_give_the_same_words():
    """Tags, nonces, epochs, PKRU words and MAC seeds agree across the two
    packages for one script of operations."""
    out = []
    for d, _, _ in PACKAGES.values():
        reg = d.KeyRegistry(max_keys=16, seed=7)
        doms = [reg.allocate_domain(f"chan:{i}") for i in range(5)]
        keys = [reg.issue_key(x, [d.READ, d.WRITE, d.RW][i % 3])
                for i, x in enumerate(doms)]
        reg.revoke(keys[2])
        rec = ([x.tag for x in doms], [k.nonce for k in keys],
               [reg.epoch(x) for x in doms],
               [reg.pkru_word(tuple(keys[:i])) for i in range(6)],
               [d.mac_seed(x, reg.epoch(x)) for x in doms])
        out.append(rec)
    assert out[0] == out[1]


# -- signatures / CA -----------------------------------------------------------

def test_sign_verify(pkg):
    _, _, sig = pkg
    kp = sig.KeyPair.generate("svc")
    s = sig.sign(kp.private, b"hello")
    assert sig.verify(kp.public, b"hello", s)
    assert not sig.verify(kp.public, b"tampered", s)
    other = sig.KeyPair.generate("other")
    assert not sig.verify(other.public, b"hello", s)


def test_dh_session_symmetry(pkg):
    _, _, sig = pkg
    a = sig.KeyPair.generate("a")
    b = sig.KeyPair.generate("b")
    assert sig.session_key(a.private, b.public) == sig.session_key(b.private, a.public)


def test_signatures_and_sessions_match_across_packages():
    for seed in ("svc-a", "svc-b", "mpklink-ca"):
        ours, theirs = tsig.KeyPair.generate(seed), jsig.KeyPair.generate(seed)
        assert (ours.private, ours.public) == (theirs.private, theirs.public)
    a, b = tsig.KeyPair.generate("a"), jsig.KeyPair.generate("b")
    assert tsig.sign(a.private, b"m") == jsig.sign(a.private, b"m")
    assert tsig.session_key(a.private, b.public) == jsig.session_key(a.private, b.public)
    assert jsig.verify(a.public, b"m", tsig.sign(a.private, b"m"))


def test_ca_grant_flow(pkg):
    d, ca, _ = pkg
    auth = ca.CertificateAuthority()
    ca.enroll(auth, "svc-a")
    ca.enroll(auth, "svc-b")
    dom, ka, kb = auth.grant_channel("svc-a", "svc-b")
    auth.registry.check(ka, d.RW)
    auth.registry.check(kb, d.RW)


def test_ca_rejects_unregistered_and_revoked(pkg):
    d, ca, _ = pkg
    auth = ca.CertificateAuthority()
    ca.enroll(auth, "svc-a")
    with pytest.raises(d.AccessViolation):
        auth.grant_channel("svc-a", "ghost")
    ca.enroll(auth, "svc-b")
    auth.revoke_service("svc-b")
    with pytest.raises(d.AccessViolation):
        auth.grant_channel("svc-a", "svc-b")
    with pytest.raises(d.AccessViolation):
        ca.enroll(auth, "svc-b")                # a ban is not one reconnect deep


def test_ca_rejects_bad_proof(pkg):
    d, ca, sig = pkg
    auth = ca.CertificateAuthority()
    kp = sig.KeyPair.generate("mallory")
    bad_proof = sig.sign(kp.private, b"not the registration message")
    with pytest.raises(d.AccessViolation):
        auth.register("mallory", kp.public, bad_proof)


def test_ca_refuses_an_alias_of_a_certified_key(pkg):
    d, ca, sig = pkg
    auth = ca.CertificateAuthority()
    kp, _ = ca.enroll(auth, "svc-a")
    proof = sig.sign(kp.private, f"register:alias:{kp.public}".encode())
    with pytest.raises(d.AccessViolation, match="alias"):
        auth.register("alias", kp.public, proof)


def test_session_seeds_match_across_packages():
    """The channel's MAC seed (domain tag ⊕ epoch mix ⊕ DH session key) is
    the same word in both packages for the same registry seed and names."""
    seeds = []
    for d, ca, _ in PACKAGES.values():
        reg = d.KeyRegistry(max_keys=16, seed=7)
        auth = ca.CertificateAuthority(reg)
        ca.enroll(auth, "svc-server")
        kp, _ = ca.enroll(auth, "client")
        dom, _, _ = auth.grant_channel("client", "svc-server", d.RW)
        seeds.append(d.mac_seed(dom, reg.epoch(dom))
                     ^ auth.session_seed(kp.private, "svc-server"))
    assert seeds[0] == seeds[1]
