"""The port's proofs and proof server against the JAX package's.

* ``ops/sha256_tree``: the port's ``host_levels`` and
  ``proofs_from_levels`` against the JAX ones and ``crypto/merkle``
  (the JAX package's) on the SHA block-edge leaf lengths and n = 1-33,
  64, 65, 129; ``tree_proofs(device="cpu")`` (the kernel's plain version,
  a few calls) the same.  Tolerance: byte equality of ``total``,
  ``index``, ``leaf_hash`` and every aunt.
* ``tree_levels`` routing: the CPU's tiers and counters, and the card's
  rule (a malformed or failed pass raises ``BackendError``; nothing on the
  host answers for the card).
* ``proofserve/service``: one scripted sequence (pause, a backlog, resume,
  cache hits and an eviction, a shed at capacity, the header and valset
  hashers, a missing height, ``close`` draining, submit after close) on
  the JAX ``ProofServer`` (its gate closed, so its host path runs and no
  executable is read) and on the port's: equal results and equal stats
  snapshots, key for key.
* ``prove_tx``: coalesced; shed, timeout and stopped server answered by
  the serial build; and the port's own rule: a ``BackendError`` from a
  build reaches the caller and ``serial_fallbacks`` stays 0.
"""

import hashlib
import subprocess
import sys

import pytest

from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.ops import sha256_tree as jtree
from cometbft_tpu.proofserve import service as jsvc
from cometbft_tpu.proofserve import stats as jstats
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto.backend_health import BackendError, BackendOutputError
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import sha256_tree as ttree
from cometbft_tpu_torch.proofserve import plane as tplane
from cometbft_tpu_torch.proofserve import service as tsvc
from cometbft_tpu_torch.proofserve import stats as tstats

# SHA-256 block-edge leaf lengths (the JAX package's tests/test_proofserve.py)
EDGE_LENS = (0, 1, 31, 32, 54, 55, 56, 63, 64, 65, 118, 119, 120)
SIZES = list(range(1, 34)) + [64, 65, 129]


def leaves(n, lens=EDGE_LENS):
    return [(hashlib.sha256(b"leaf-%d" % i).digest() * 4)[: lens[i % len(lens)]]
            for i in range(n)]


def fields(proofs):
    return [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in proofs]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Both gates closed (the JAX plane's host path, no executable read),
    zeroed counters, fresh breakers, no process-wide servers."""
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for mod in (tstats, jstats, tbh, tds):
        mod.reset()
    yield
    tsvc.reset_server()
    jsvc.reset_server()
    for mod in (tstats, jstats, tbh, tds):
        mod.reset()


# -- proofs ------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_host_levels_and_proofs_equal_jax_and_merkle(n):
    items = leaves(n)
    levels = ttree.host_levels(items)
    assert levels == jtree.host_levels(items)
    root, want = jmerkle.proofs_from_byte_slices(items)
    assert levels[-1] == [root]
    got = ttree.proofs_from_levels(levels)
    assert fields(got) == fields(want) == fields(jtree.proofs_from_levels(levels))
    assert all(p.verify(root, it) for p, it in zip(got, items))


@pytest.mark.parametrize("n", [1, 2, len(EDGE_LENS), 33])
def test_tree_proofs_plain_version_equals_merkle(n):
    """The kernel's plain version (``device="cpu"``): every level equal to
    the host's, every proof to ``crypto/merkle``'s."""
    items = leaves(n)
    assert ttree.device_levels(items, "cpu") == jtree.host_levels(items)
    root, proofs = ttree.tree_proofs(items, device="cpu")
    want_root, want = jmerkle.proofs_from_byte_slices(items)
    assert root == want_root and fields(proofs) == fields(want)
    assert tds.tier_counts(ttree.MERKLE)["torch"] == (1, n)
    snap = tstats.snapshot()
    assert (snap["trees_device"], snap["tree_leaves"], snap["tree_lanes"]) == (
        1, n, max(8, 1 << (n - 1).bit_length()))


def test_empty_set_and_the_gate():
    assert ttree.tree_proofs([]) == (ttree.EMPTY_HASH, [])
    assert tplane.tree_proofs([]) == jmerkle.proofs_from_byte_slices([])
    with pytest.raises(ValueError):
        ttree.tree_levels([])
    items = leaves(40)
    # the gate closed: the host answers, counted as the JAX package counts
    root, proofs = tplane.tree_proofs(items)
    assert fields(proofs) == fields(jmerkle.proofs_from_byte_slices(items)[1])
    assert tstats.snapshot()["trees_host"] == 1
    assert tds.tier_counts(ttree.MERKLE)["host"] == (1, 40)
    # under the min-batch gate the plane calls merkle itself: no tree pass
    tplane.tree_proofs(items[:31])
    assert tstats.snapshot()["trees_host"] == 1


def test_oversize_set_goes_to_the_host():
    items = [b"x" * (64 * 1024 + 1)] + leaves(3)
    root, proofs = ttree.tree_proofs(items, device="cpu")
    assert fields(proofs) == fields(jmerkle.proofs_from_byte_slices(items)[1])
    snap = tstats.snapshot()
    assert (snap["oversize_host"], snap["trees_host"]) == (1, 1)
    assert tds.tier_counts(ttree.MERKLE_OVERSIZE)["host"] == (1, 4)


def test_malformed_levels_on_the_cpu_are_answered_by_the_host(monkeypatch):
    items = leaves(5)
    monkeypatch.setattr(ttree, "device_levels", lambda it, dev=None: [[b"\0" * 32]])
    root, proofs = ttree.tree_proofs(items, device="cpu")
    assert fields(proofs) == fields(jmerkle.proofs_from_byte_slices(items)[1])
    assert tstats.snapshot()["device_fallbacks"] == 1
    assert tbh.registry().breaker(ttree.BREAKER).stats()["failures_total"] == 1


@pytest.mark.parametrize("fault", ["raise", "short row"])
def test_a_failed_pass_raises_on_a_card(monkeypatch, fault):
    """The card's rule (``device=None`` is the card; the gate opened by
    patching): a pass the kernel did not serve raises ``BackendError``,
    and no host build answers in its place."""
    items = leaves(6)

    def bad(it, dev=None):
        if fault == "raise":
            raise RuntimeError("sha256_tree launch failed: CUDA error 719")
        levels = jtree.host_levels(it)
        levels[0][2] = levels[0][2][:31]
        return levels

    monkeypatch.setattr(ttree, "device_active", lambda: True)
    monkeypatch.setattr(ttree, "device_levels", bad)
    with pytest.raises(BackendError) as e:
        ttree.tree_proofs(items)
    if fault == "short row":
        assert isinstance(e.value.__cause__, BackendOutputError)
    assert tstats.snapshot()["device_fallbacks"] == 0
    assert tds.tier_counts(ttree.MERKLE).get("host", (0, 0)) == (0, 0)


# -- the proof server ----------------------------------------------------------


def scripted(svc, stats):
    """One fixed sequence on a ``ProofServer`` of ``svc``; returns what
    every query gave (proofs as their fields) and the stats snapshot."""
    chain = {h: [b"tx-%d-%d" % (h, i) for i in range(40)] for h in range(1, 5)}
    hdr = {h: hashlib.sha256(b"header-%d" % h).digest() for h in range(1, 5)}
    vs = {h: hashlib.sha256(b"valset-%d" % h).digest() for h in range(1, 5)}
    server = svc.ProofServer(chain.get, hdr.get, vs.get, flush_us=1000,
                             queue_cap=4, cache_cap=2)
    out = []

    def show(val):
        if isinstance(val, tuple):
            return val[0], fields(val[1])
        return val

    server.pause()
    futs = [server.submit("tx", 1), server.submit("tx", 1), server.submit("tx", 2),
            server.submit("header", 1)]
    out.append(server.pending())
    with pytest.raises(svc.QueueFullError):
        server.submit("valset", 1)
    server.resume()
    out += [show(f.result(timeout=10)) for f in futs]
    hit = server.submit("tx", 2)  # cached: answered without a queue slot
    out += [hit.done(), show(hit.result(timeout=0))]
    out.append(show(server.submit("valset", 3).result(timeout=10)))
    out.append(show(server.submit("tx", 99).result(timeout=10)))  # missing
    out.append(server.cached("tx", 99))
    out.append(show(server.submit("tx", 3).result(timeout=10)))  # evicts tx 2
    out += [server.cached("tx", 1), server.cached("tx", 2), server.cached("tx", 3)]
    server.pause()
    drained = [server.submit("tx", 4), server.submit("header", 4)]
    server.close()
    out += [show(f.result(timeout=0)) for f in drained]
    with pytest.raises(RuntimeError):
        server.submit("tx", 1)
    return out, stats.snapshot()


def test_server_equals_the_jax_server():
    jout, jsnap = scripted(jsvc, jstats)
    tout, tsnap = scripted(tsvc, tstats)
    assert tout == jout
    assert tsnap == jsnap
    assert tsnap["flushes"] == {"deadline": 3, "full": 1, "shutdown": 1}
    assert tsnap["tree_builds"]["tx"] == 5 and tsnap["trees_host"] == 4
    assert tsnap["shed"]["valset"] == 1 and tsnap["cache_hits"]["tx"] == 1


def test_prove_tx_coalesced_shed_timeout_and_stopped():
    chain = {h: [b"tx-%d-%d" % (h, i) for i in range(40)] for h in range(1, 4)}
    root, proofs = jmerkle.proofs_from_byte_slices(chain[3])
    want = (root, fields([proofs[5]]))

    def ask(**kw):
        got = tsvc.prove_tx(chain.get, 3, 5, **kw)
        return got[0], fields([got[1]])

    assert not tsvc.server_active() and ask() == want  # no server: serial
    tsvc.configure(chain.get, lambda h: None, lambda h: None)
    assert tsvc.server_active() and ask() == want  # coalesced
    assert tstats.snapshot()["tree_builds"]["tx"] == 1
    assert tsvc.prove_tx(chain.get, 99, 0) is None
    assert tsvc.prove_tx(chain.get, 3, 40) is None
    server = tsvc.configure(chain.get, lambda h: None, lambda h: None, queue_cap=1)
    server.pause()  # a fresh cache: height 3 is queued again
    queued = server.submit("tx", 1)  # fills the queue
    assert ask() == want  # shed -> serial
    assert tstats.snapshot()["serial_fallbacks"] == 1
    server.resume()
    queued.result(timeout=10)
    server.pause()
    assert ask(timeout_s=0.01) == want  # timeout -> serial (queue 1 again)
    server.close()  # stopped, still configured
    assert tsvc.server_active()
    with pytest.raises(tsvc.ServerStoppedError):
        server.submit("tx", 3)
    assert ask() == want  # stopped -> serial
    snap = tstats.snapshot()
    assert snap["serial_fallbacks"] == 3 and snap["shed"]["tx"] == 1


def test_a_build_backend_error_reaches_prove_tx(monkeypatch):
    """The port's rule: a tree pass that fails on a card raises
    ``BackendError`` through the server's future to the caller of
    ``prove_tx``; no serial build answers it."""
    chain = {1: [b"tx-%d" % i for i in range(40)]}
    monkeypatch.setattr(ttree, "device_active", lambda: True)

    def failed(it, dev=None):
        raise RuntimeError("sha256_tree launch failed: CUDA error 719")

    monkeypatch.setattr(ttree, "device_levels", failed)
    tsvc.configure(chain.get, lambda h: None, lambda h: None)
    with pytest.raises(BackendError):
        tsvc.prove_tx(chain.get, 1, 0)
    snap = tstats.snapshot()
    assert snap["serial_fallbacks"] == 0 and snap["tree_builds"]["tx"] == 0
    assert snap["cache_misses"] == 1 and not tsvc.get_server().cached("tx", 1)
    assert tbh.registry().breaker(ttree.BREAKER).stats()["failures_total"] == 1


def test_proofserve_imports_no_torch():
    code = ("import sys, cometbft_tpu_torch.proofserve as p; "
            "assert p.ProofServer and 'torch' not in sys.modules, "
            "[m for m in sys.modules if m.startswith('torch')][:3]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def test_faulty_backend_on_merkle_device(monkeypatch):
    """``FaultyBackend`` (raise) on the ``merkle_device`` breaker: on the
    CPU the host answers below the plain version; on the card (the gate
    opened by patching) ``prove_tx`` raises ``BackendError`` and no serial
    answer appears."""
    from cometbft_tpu_torch.ops import supervisor as tsup

    items = leaves(40)
    tsup.set_fault_injector(tsup.FaultyBackend("raise", backends=(ttree.BREAKER,)))
    try:
        root, proofs = ttree.tree_proofs(items, device="cpu")
        assert fields(proofs) == fields(jmerkle.proofs_from_byte_slices(items)[1])
        assert tstats.snapshot()["device_fallbacks"] == 1
        monkeypatch.setattr(ttree, "device_active", lambda: True)
        tsvc.configure({1: items}.get, lambda h: None, lambda h: None)
        with pytest.raises(BackendError):
            tsvc.prove_tx({1: items}.get, 1, 3)
    finally:
        tsup.clear_fault_injector()
    assert tstats.snapshot()["serial_fallbacks"] == 0
    assert tbh.registry().breaker(ttree.BREAKER).stats()["failures_total"] == 2
