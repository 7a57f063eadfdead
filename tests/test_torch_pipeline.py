"""The in-flight verify seam of the port (``ops/verify.py``:
``verify_batches_overlapped``, ``dispatch_segments``/``fetch_segments``,
``verify_pipelined``) and the split light path (``types/validation.py``:
``prepare_commit_light``/``finish_commit_light``).

On the CPU the same functions run the plain version: their bits must
equal the oracle's (which ``verify_batch`` is held to in
``test_torch_verify.py``), the K-in-flight order and the chunking are
checked with a recording stand-in, and the light path must give the JAX
package's entries, messages and errors.  Tests marked ``cuda`` run the
seam on the card: real streams, events and page-locked buffers.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.types import validation as jval
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.ops import cuda_verify as tcv
from cometbft_tpu_torch.ops import verify as tov
from cometbft_tpu_torch.types import validation as tval

from test_torch_commit import CHAIN, HEIGHT, _describe, _jax_commit
from test_torch_verify import edge_set, oracle, random_mix


def _work():
    """Three segments: mixed verdicts, an empty one, the edge set."""
    p1, m1, s1 = random_mix(5, seed=12)
    p2, m2, s2 = edge_set()
    return [(p1, m1, s1), ([], [], []), (p2[:6], m2[:6], s2[:6])]


def _want(work):
    return [oracle(*seg) for seg in work]


def test_overlapped_matches_oracle():
    work = _work()
    got = tov.verify_batches_overlapped(work, device="cpu")
    want = _want(work)
    assert [len(g) for g in got] == [5, 0, 6]
    for g, w in zip(got, want):
        assert g.dtype == bool
        np.testing.assert_array_equal(g, w)
    assert any(w.any() for w in want) and not all(w.all() for w in want)


def test_pipelined_matches_oracle():
    w = _work()
    pubs, msgs, sigs = (w[0][k] + w[2][k] for k in range(3))
    got = tov.verify_pipelined(pubs, msgs, sigs, device="cpu")
    np.testing.assert_array_equal(got, oracle(pubs, msgs, sigs))
    assert tov.verify_pipelined([], [], [], device="cpu").shape == (0,)


class _Recorder:
    """Stands in for ``_dispatch``/``_fetch``: records their order and
    answers each batch with a bit pattern of its own."""

    def __init__(self, monkeypatch):
        self.log = []
        monkeypatch.setattr(tov, "_dispatch", self.dispatch)
        monkeypatch.setattr(tov, "_fetch", self.fetch)

    def dispatch(self, pubs, msgs, sigs, dev):
        k = sum(1 for e in self.log if e[0] == "d")
        self.log.append(("d", k, len(pubs)))
        return k, len(pubs)

    def fetch(self, flight):
        k, n = flight
        self.log.append(("f", k, n))
        return (np.arange(n) + k) % 2 == 0

    def most_in_flight(self):
        out = live = 0
        for kind, _, _ in self.log:
            live += 1 if kind == "d" else -1
            out = max(out, live)
        return out


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_overlapped_keeps_k_in_flight(monkeypatch, inflight):
    rec = _Recorder(monkeypatch)
    work = [([b"p"] * n, [b"m"] * n, [b"s"] * n) for n in (3, 1, 4, 2, 5)]
    out = tov.verify_batches_overlapped(work, device="cpu", inflight=inflight)
    assert rec.most_in_flight() == inflight
    assert [e[1] for e in rec.log if e[0] == "f"] == list(range(5))  # in order
    if inflight == 2:
        assert [e[:2] for e in rec.log[:4]] == [("d", 0), ("d", 1), ("f", 0), ("d", 2)]
    for k, (o, n) in enumerate(zip(out, (3, 1, 4, 2, 5))):
        np.testing.assert_array_equal(o, (np.arange(n) + k) % 2 == 0)


@pytest.mark.parametrize("n,chunks", [(10_240, [10_240]), (100, [64, 36]),
                                      (20, [20]), (300, [256, 44])])
def test_pipelined_chunks_as_one_lane(monkeypatch, n, chunks):
    """One card is the JAX package's one mesh lane: the chunk is the
    largest bucket the batch fills, so a 10,240 batch is one chunk."""
    rec = _Recorder(monkeypatch)
    out = tov.verify_pipelined([b"p"] * n, [b"m"] * n, [b"s"] * n, device="cpu")
    assert [e[2] for e in rec.log if e[0] == "d"] == chunks
    assert rec.most_in_flight() == min(2, len(chunks))
    want = np.concatenate([(np.arange(c) + k) % 2 == 0 for k, c in enumerate(chunks)])
    np.testing.assert_array_equal(out, want)


def test_segments_past_the_largest_bucket_go_overlapped(monkeypatch):
    calls = []
    monkeypatch.setattr(tov, "_BUCKETS", [4, 8])
    monkeypatch.setattr(
        tov, "verify_batches_overlapped",
        lambda work, device=None: calls.append([len(p) for p, _, _ in work])
        or [np.ones(len(p), bool) for p, _, _ in work],
    )
    work = [([b"a"] * 5, [b"m"] * 5, [b"s"] * 5), ([b"b"] * 4,) * 3]
    out = tov.verify_segments(work, device="cpu")
    assert calls == [[5, 4]] and [len(o) for o in out] == [5, 4]


def test_dispatch_rejects_a_lane_and_empty_work_needs_no_verify():
    """A lane pins a flush at a mesh ordinal (``parallel/elastic``); with no
    mesh configured the single-card chain takes it, so the handle is the
    chain's, not a lane's, and its verdicts are the oracle's (on the
    supervisor's runner seam: no plain verify)."""
    from cometbft_tpu_torch.ops import supervisor
    from cometbft_tpu_torch.parallel import elastic

    assert not elastic.active()
    work = _work()
    supervisor.set_device_runner(
        lambda backend, p, m, s, lanes: np.array(oracle(p, m, s) + [False] * (lanes - len(p))))
    try:
        h = tov.dispatch_segments(work, lane=0, device="cpu")
        assert h.sup.kind == "deferred" and h.sup.lane is None
        got = tov.fetch_segments(h)
    finally:
        supervisor.clear_device_runner()
    assert [list(g) for g in got] == [list(w) for w in _want(work)]
    h = tov.dispatch_segments([([], [], []), ([], [], [])], device="cpu")
    assert [o.shape for o in tov.fetch_segments(h)] == [(0,), (0,)]
    assert tov.verify_batches_overlapped([([], [], [])], device="cpu")[0].shape == (0,)


def test_seam_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (
        lambda: tov.dispatch_segments(_work()),
        lambda: tov.verify_batches_overlapped(_work()),
        lambda: tov.verify_pipelined(*_work()[0]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# -- the split light path against the JAX package -----------------------------

CASES = {
    "valid": dict(nil=(5,)),
    "bad_sig": dict(bad=(3, 9)),
    "not_enough_power": dict(absent=tuple(range(0, 16, 2)) + (1, 3)),
}


@pytest.fixture(scope="module")
def commits():
    out = {}
    for name, kw in CASES.items():
        vals, commit, block_id = _jax_commit(**kw)
        out[name] = (
            (vals, commit, block_id),
            (
                convert.validator_set_from(vals),
                convert.commit_from(commit),
                convert.block_id_from(block_id),
            ),
        )
    return out


def _finish(pkg, prepared, bits):
    try:
        pkg.finish_commit_light(prepared, bits)
    except pkg.CommitVerificationError as e:
        return _describe(e)
    return None


@pytest.mark.parametrize("count_all", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_and_finish_match_jax(commits, case, count_all):
    (jv, jc, jb), (tv, tc, tb) = commits[case]
    jp = jval.prepare_commit_light(CHAIN, jv, jb, HEIGHT, jc, count_all)
    tp = tval.prepare_commit_light(CHAIN, tv, tb, HEIGHT, tc, count_all)
    assert [e[0] for e in tp.entries] == [e[0] for e in jp.entries]
    assert tp.msgs == jp.msgs and tp.sigs == jp.sigs and tp.pubs == jp.pubs
    assert (tp.tallied, tp.voting_power_needed, tp.count_all) == (
        jp.tallied, jp.voting_power_needed, jp.count_all)
    bits = oracle(tp.pubs, tp.msgs, tp.sigs)  # as the kernel would answer
    assert _finish(tval, tp, bits) == _finish(jval, jp, bits)
    got = _finish(tval, tp, bits)
    if case == "bad_sig":
        assert got[0] == "InvalidSignatureError" and got[2] == 3
    if case == "not_enough_power":
        assert got[0] == "NotEnoughPowerError"
    if case == "valid":
        assert got is None


def test_prepare_raises_what_verify_raises(commits):
    (jv, jc, jb), (tv, tc, tb) = commits["valid"]
    want = got = None
    try:
        jval.prepare_commit_light(CHAIN, jv, jb, HEIGHT + 1, jc)
    except jval.CommitVerificationError as e:
        want = _describe(e)
    try:
        tval.prepare_commit_light(CHAIN, tv, tb, HEIGHT + 1, tc)
    except tval.CommitVerificationError as e:
        got = _describe(e)
    assert got == want and got[0] == "CommitVerificationError"


def test_light_window_through_the_seam(commits):
    """Two commits, one handle: prepare -> dispatch -> fetch -> finish
    passes the good commit and names index 3 of the bad one.  The handle
    is a real supervised flight on the CPU (packed at dispatch, the plain
    version at fetch), served by the torch tier."""
    window = [commits["valid"][1], commits["bad_sig"][1]]
    prepared = [
        tval.prepare_commit_light(CHAIN, v, b, HEIGHT, c) for v, c, b in window
    ]
    h = tov.dispatch_segments([(p.pubs, p.msgs, p.sigs) for p in prepared],
                              device="cpu")
    assert h.sup.kind == "chip" and h.tier is None
    bits = tov.fetch_segments(h)
    assert h.tier == "torch"
    for p, b in zip(prepared, bits):
        np.testing.assert_array_equal(b, oracle(p.pubs, p.msgs, p.sigs))
    tval.finish_commit_light(prepared[0], bits[0])
    with pytest.raises(tval.InvalidSignatureError) as e:
        tval.finish_commit_light(prepared[1], bits[1])
    assert e.value.index == 3


def test_fused_verify_eligible(commits, monkeypatch):
    _, (tv, _, _) = commits["valid"]
    other = SimpleNamespace(
        validators=[SimpleNamespace(pub_key=SimpleNamespace(type_="secp256k1"))]
    )
    monkeypatch.setattr(tbatch, "default_backend", lambda: "gpu")
    assert tval.fused_verify_eligible([tv])
    assert not tval.fused_verify_eligible([tv, other])
    monkeypatch.setattr(tbatch, "default_backend", lambda: "cpu")
    assert not tval.fused_verify_eligible([tv])
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.fused_verify_eligible([tv])


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_seam_matches_verify_batch(card):
    work = _work()
    tcv.reset_launches()
    handles = [tov.dispatch_segments([seg]) for seg in work]
    flights = [h.sup.flight if h.sup else h.flight for h in handles]
    assert all(f.host is None or f.host["a_bytes"].is_pinned() for f in flights)
    got = [tov.fetch_segments(h)[0] for h in handles]
    assert tcv.launches == 2  # the empty segment launches nothing
    over = tov.verify_batches_overlapped(work)
    piped = tov.verify_pipelined(*work[0])
    for g, o, seg in zip(got, over, work):
        want = tov.verify_batch(*seg)
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(o, want)
        np.testing.assert_array_equal(g, oracle(*seg))
    np.testing.assert_array_equal(piped, got[0])


@pytest.mark.cuda
def test_card_failed_launch_raises_at_fetch(card, monkeypatch):
    # the raw path; under the supervisor it raises BackendError
    # (test_torch_supervisor.py)
    monkeypatch.setenv("COMETBFT_TPU_SUPERVISOR", "0")
    monkeypatch.setattr(tcv, "_launcher", lambda: lambda *a: 700)
    h = tov.dispatch_segments([_work()[0]])
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tov.fetch_segments(h)
