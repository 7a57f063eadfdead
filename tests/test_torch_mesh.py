"""The port's elastic mesh (``cometbft_tpu_torch/parallel/{elastic,mesh}``)
against the JAX package's, event for event, on the CPU.

Both packages configure four virtual ordinals with the host oracle at
``parallel/elastic``'s mesh runner seam (``set_mesh_runner(
host_oracle_runner)``), their breakers on one fake clock, and the same
script runs through each: the fault matrix (every mode on every ordinal),
a wedged shard, an uneven batch with a dead device, shrink then restore, a
probe-down exclusion (also before ``configure``), all ordinals dead, the
kill switch, the min-batch cutoff, a pinned lane, the width gauge and
``/metrics``, the scheduler's target and the warm-boot shrink matrix (the
cases of the JAX package's ``tests/test_mesh.py``).  What each records is
compared with exact equality: the verdicts, the ``mesh_dev*`` breakers'
stats, the journal events (``mesh.reconfig``, ``device_probe``) and
anomalies the tracing sinks see, every span (stage and attributes, the
JAX tier names mapped through ``torch_sim.TIER``), membership and the
mesh counters of ``ops/dispatch_stats``.  Where the single-card chain
answers, both run it on the supervisor's device-runner seam (the oracle),
the port on ``device="cpu"``: the JAX side never reaches an XLA program
or ``.exec_cache/``.

Then the port alone: its real per-shard path (the kernel's plain version
on each of four CPU ordinals, no runner) and, on a card (``cuda``-marked,
skipped here), the sharded commit of ``chip_smoke.py``'s mesh phase and
the fault modes on the kernel.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_sim
from cometbft_tpu_torch.crypto import ed25519_ref as ref

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
WIDTH = 4
MODS = ("parallel.elastic", "crypto.backend_health", "libs.tracing", "ops.device_health",
        "ops.dispatch_stats", "ops.supervisor", "ops.warmboot", "libs.metrics",
        "verifysched", "ops.verify")


def _ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(pkg=pkg, **{m.split(".")[-1]: importlib.import_module(f"{pkg}.{m}")
                                       for m in MODS})


def _oracle(ordinal, pubs, msgs, sigs, lanes):
    out = np.zeros(int(lanes), dtype=bool)
    out[: len(pubs)] = [ref.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    return out


def _device_runner(backend, pubs, msgs, sigs, lanes):
    return _oracle(0, pubs, msgs, sigs, lanes)


def mixed_batch(seed: int, n: int):
    """The JAX test's batch: forged, degenerate and short-key lanes among
    valid ones, with the oracle's verdicts."""
    rng = random.Random(seed)
    pubs, msgs, sigs = [], [], []
    expected = np.zeros(n, dtype=bool)
    for i in range(n):
        s = bytes([(seed + i) % 255 + 1]) * 32
        pub = ref.pubkey_from_seed(s)
        msg = b"elastic-%d-%d" % (seed, i)
        sig = ref.sign(s, msg)
        roll = rng.random()
        if roll < 0.2:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        elif roll < 0.3:
            sig = bytes(64)
        elif roll < 0.35:
            pub = pub[:16]
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
        expected[i] = len(pub) == 32 and len(sig) == 64 and ref.verify_zip215(pub, msg, sig)
    return pubs, msgs, sigs, expected


class Side:
    """One package's modules, its fake clock and what its sinks saw."""

    def __init__(self, pkg: str):
        self.m = _ns(pkg)
        self.dev = {"device": "cpu"} if pkg == PKGS[1] else {}
        self.clock = [100.0]
        self.events: list = []
        self.anomalies: list = []
        self._prev: dict = {}

    def reset(self, configure: bool = True) -> None:
        m = self.m
        m.elastic.clear()
        m.backend_health.reset()
        m.backend_health.registry().set_clock(lambda: self.clock[0])
        m.device_health.reset()
        m.tracing.reset_tracer()
        m.dispatch_stats.reset()
        m.supervisor.clear_device_runner()
        m.supervisor.clear_fault_injector()
        self.events.clear()
        self.anomalies.clear()
        for kind, fn in (("event", lambda k, a: self.events.append((k, dict(a)))),
                         ("anomaly", lambda k, a, t: self.anomalies.append((k, dict(a))))):
            self._prev.setdefault(kind, m.tracing.set_sink(kind, fn))
        if configure:
            self.configure()

    def configure(self) -> None:
        self.m.elastic.configure(range(WIDTH))
        self.m.elastic.set_mesh_runner(_oracle)
        self.m.backend_health.registry().set_clock(lambda: self.clock[0])

    def close(self) -> None:
        m = self.m
        m.elastic.clear()
        m.supervisor.clear_device_runner()
        m.supervisor.clear_fault_injector()
        for kind, fn in self._prev.items():
            m.tracing.set_sink(kind, fn)
        m.backend_health.reset()
        m.device_health.reset()
        m.tracing.reset_tracer()
        m.dispatch_stats.reset()

    def verify(self, batch):
        return self.m.elastic.verify_elastic(*batch[:3], **self.dev)

    def supervised(self, batch):
        return self.m.supervisor.verify_supervised(*batch[:3], **self.dev)

    def state(self) -> dict:
        """Everything the mesh recorded, for comparison."""
        m = self.m
        reg = m.backend_health.registry()
        snap = m.dispatch_stats.snapshot()
        spans = [(s["stage"], {k: v for k, v in s["attrs"].items()
                               if not k.endswith("_s") and k != "error_msg"})
                 for s in m.tracing.get_tracer().tail(0)]
        return torch_sim.map_tiers({
            "breakers": {f"mesh_dev{o}": reg.breaker(f"mesh_dev{o}").stats()
                         for o in range(WIDTH)},
            "healthy": m.elastic.healthy_ordinals(),
            "width": m.elastic.healthy_width(),
            "mesh": {k: snap[k] for k in ("mesh_width", "mesh_shrinks", "mesh_restores",
                                          "dispatches", "lanes_total", "lanes_used",
                                          "lane_dispatches", "inflight_depth")},
            "shards": {k: v["count"] for k, v in snap["shard_hist"].items()},
            "events": list(self.events),
            "anomalies": list(self.anomalies),
            "spans": spans,
            "counts": {k: v for k, v in m.backend_health.snapshot().items()
                       if k != "breakers"},
        })


@pytest.fixture
def sides(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.delenv("COMETBFT_TPU_MESH_SUPERVISOR", raising=False)
    monkeypatch.delenv("COMETBFT_TPU_MESH_MIN_BATCH", raising=False)
    monkeypatch.delenv("COMETBFT_TPU_MESH", raising=False)
    out = [Side(pkg) for pkg in PKGS]
    for s in out:
        s.reset()
    yield out
    for s in out:
        s.close()


def run_both(sides, script) -> list:
    """``script(side)`` in each package; returns the port's result after
    asserting both results and both recorded states equal."""
    got = [script(s) for s in sides]
    states = [s.state() for s in sides]
    assert torch_sim.map_tiers(got[0]) == got[1]
    for k in states[0]:
        assert states[1][k] == states[0][k], k
    return got[1]


def _bits(x) -> list:
    return [bool(b) for b in x]


def test_fault_matrix_every_mode_every_ordinal(sides):
    batch = mixed_batch(7, 23)

    def script(s):
        out = []
        for mode in ("raise", "wrong_shape", "flap"):
            for ordinal in range(WIDTH):
                s.m.backend_health.reset()
                s.m.backend_health.registry().set_clock(lambda: s.clock[0])
                s.m.elastic.set_fault_injector(s.m.elastic.FaultyDevice(
                    mode, ordinals=(ordinal,), fail_n=2, pass_n=1))
                bits = s.verify(batch)
                st = s.m.backend_health.registry().breaker(f"mesh_dev{ordinal}").stats()
                out.append((mode, ordinal, _bits(bits), st["failures_total"], st["state"]))
                s.m.elastic.clear_fault_injector()
        return out

    got = run_both(sides, script)
    for mode, ordinal, bits, failures, _ in got:
        assert bits == _bits(batch[3]), (mode, ordinal)
        assert failures >= 1, (mode, ordinal)


def test_hang_mode_shard_watchdog_fires(sides, monkeypatch):
    # a deadline far above a healthy shard's oracle verify, even on a
    # loaded host, and a wedge far above the deadline
    monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "500")
    batch = mixed_batch(11, 17)

    def script(s):
        out = []
        for ordinal in range(WIDTH):
            s.m.backend_health.reset()
            s.m.backend_health.registry().set_clock(lambda: s.clock[0])
            s.m.elastic.set_fault_injector(
                s.m.elastic.FaultyDevice("hang", ordinals=(ordinal,), hang_s=2.0))
            out.append(_bits(s.verify(batch)))
            s.m.elastic.clear_fault_injector()
        return out

    got = run_both(sides, script)
    assert all(bits == _bits(batch[3]) for bits in got)
    fires = [a for a in sides[1].anomalies if a[0] == "shard_watchdog_fire"]
    assert [a[1]["ordinal"] for a in fires] == list(range(WIDTH))


def test_uneven_batch_with_dead_device(sides):
    batch = mixed_batch(13, 19)

    def script(s):
        s.m.backend_health.registry().breaker("mesh_dev3").trip("pre-dead")
        return _bits(s.verify(batch))

    assert run_both(sides, script) == _bits(batch[3])
    st = sides[1].state()
    assert st["mesh"]["mesh_width"] == WIDTH - 1
    assert sorted(a["device"] for stage, a in st["spans"] if stage == "mesh.shard") == [0, 1, 2]


def test_shrink_then_restore_round_trip(sides):
    batch = mixed_batch(17, 21)

    def script(s):
        out = []
        s.m.elastic.set_fault_injector(s.m.elastic.FaultyDevice("raise", ordinals=(1,)))
        out.append((_bits(s.verify(batch)), s.m.dispatch_stats.mesh_width()))
        s.clock[0] += 5.0  # still dead: one failed probe, never a batch
        out.append((_bits(s.verify(batch)), s.m.dispatch_stats.mesh_width()))
        s.m.elastic.clear_fault_injector()
        s.clock[0] += 10.0  # healed: the next probe re-admits it
        out.append((_bits(s.verify(batch)), s.m.dispatch_stats.mesh_width()))
        return out

    got = run_both(sides, script)
    assert [w for _, w in got] == [WIDTH - 1, WIDTH - 1, WIDTH]
    assert all(bits == _bits(batch[3]) for bits, _ in got)
    st = sides[1].state()
    assert st["mesh"]["mesh_shrinks"] == 1 and st["mesh"]["mesh_restores"] == 1
    assert st["breakers"]["mesh_dev1"]["state"] == "closed"
    assert st["breakers"]["mesh_dev1"]["repromotions"] == 1
    assert [e[1]["reason"] for e in st["events"] if e[0] == "mesh.reconfig"] == [
        "configure", "shard-failure", "probe-pass"]


def test_probe_down_proactive_exclusion(sides):
    batch = mixed_batch(19, 9)

    def script(s):
        changed = s.m.device_health.record_probe(False, source="chipwatch", ordinal=2)
        bits = _bits(s.verify(batch))
        again = s.m.device_health.record_probe(False, source="chipwatch", ordinal=2)
        return changed, bits, again, s.m.device_health.snapshot()["ordinals"]

    changed, bits, again, ordinals = run_both(sides, script)
    assert changed and not again and bits == _bits(batch[3])
    assert ordinals == {"2": False}
    st = sides[1].state()
    assert st["breakers"]["mesh_dev2"]["state"] == "open"
    assert st["mesh"]["mesh_width"] == WIDTH - 1
    assert [a for a in st["anomalies"] if a[0] == "mesh_shrink"] == [
        ("mesh_shrink", {"ordinal": 2, "reason": "probe-down"})]


def test_probe_down_before_configure_still_excludes(sides):
    batch = mixed_batch(43, 11)

    def script(s):
        s.reset(configure=False)
        s.m.device_health.record_probe(False, source="chipwatch", ordinal=1)
        s.configure()
        st = s.m.backend_health.registry().breaker("mesh_dev1").stats()["state"]
        return st, _bits(s.verify(batch)), s.m.dispatch_stats.mesh_width()

    assert list(run_both(sides, script)) == ["open", _bits(batch[3]), WIDTH - 1]


def test_all_ordinals_dead_falls_to_single_card_chain(sides):
    batch = mixed_batch(23, 13)

    def script(s):
        for o in range(1, WIDTH):
            s.m.backend_health.registry().breaker(f"mesh_dev{o}").trip("dead")
        s.m.supervisor.set_device_runner(_device_runner)
        return _bits(s.verify(batch))

    assert run_both(sides, script) == _bits(batch[3])
    stages = [stage for stage, _ in sides[1].state()["spans"]]
    assert "mesh.shard" not in stages and "verify.batch" in stages


def test_kill_switch_bitwise_parity(sides, monkeypatch):
    batch = mixed_batch(29, 15)
    monkeypatch.setenv("COMETBFT_TPU_MESH_MIN_BATCH", "1")

    def script(s):
        s.m.supervisor.set_device_runner(_device_runner)
        with_mesh = _bits(s.supervised(batch))
        monkeypatch.setenv("COMETBFT_TPU_MESH_SUPERVISOR", "0")
        try:
            return with_mesh, s.m.elastic.active(), _bits(s.supervised(batch))
        finally:
            monkeypatch.delenv("COMETBFT_TPU_MESH_SUPERVISOR")

    with_mesh, active, without = run_both(sides, script)
    assert with_mesh == without == _bits(batch[3]) and not active


def test_min_batch_cutoff_keeps_small_batches_single_card(sides, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_MESH_MIN_BATCH", "16")
    small, big = mixed_batch(37, 8), mixed_batch(41, 16)

    def script(s):
        s.m.supervisor.set_device_runner(_device_runner)
        a = _bits(s.supervised(small))
        shards_small = sum(1 for x in s.m.tracing.get_tracer().tail(0)
                           if x["stage"] == "mesh.shard")
        b = _bits(s.supervised(big))
        return a, shards_small, b

    a, shards_small, b = run_both(sides, script)
    assert a == _bits(small[3]) and b == _bits(big[3]) and shards_small == 0
    assert sum(1 for st, _ in sides[1].state()["spans"] if st == "mesh.shard") == WIDTH


def test_pinned_lane_degrades_alone(sides):
    """``dispatch_segments(lane=...)``: a healthy lane serves its flush; a
    dead lane is noted (breaker, shrink, journal) and its flush
    re-verified on the single-card chain."""
    batch = mixed_batch(47, 10)

    def script(s):
        s.m.supervisor.set_device_runner(_device_runner)
        work = [tuple(batch[:3])]
        h = s.m.verify.dispatch_segments(work, lane=1, **s.dev)
        ok = _bits(s.m.verify.fetch_segments(h)[0])
        s.m.elastic.set_fault_injector(s.m.elastic.FaultyDevice("raise", ordinals=(3,)))
        h = s.m.verify.dispatch_segments(work, lane=3, **s.dev)
        bad = _bits(s.m.verify.fetch_segments(h)[0])
        return ok, bad, s.m.elastic.healthy_ordinals()

    ok, bad, healthy = run_both(sides, script)
    assert ok == bad == _bits(batch[3]) and healthy == [0, 1, 2]
    assert sides[1].state()["mesh"]["lane_dispatches"] == {"1": 1, "3": 1}


def test_width_gauge_and_metrics_exposition(sides):
    batch = mixed_batch(31, 8)

    def script(s):
        bits = _bits(s.verify(batch))
        text = s.m.metrics.NodeMetrics().registry.expose()
        mesh = [ln for ln in text.splitlines()
                if "crypto_mesh_" in ln or "shard_dispatch_seconds_count" in ln]
        return bits, mesh

    bits, mesh = run_both(sides, script)
    assert bits == _bits(batch[3])
    assert "cometbft_crypto_mesh_width 4" in mesh
    assert any(ln.startswith("cometbft_crypto_mesh_shrinks") for ln in mesh)


def test_sched_bucket_target_follows_live_width(sides):
    def script(s):
        sched = s.m.verifysched.VerifyScheduler(**s.dev)
        out = [sched._bucket_target()]
        s.m.backend_health.registry().breaker("mesh_dev0").trip("dead")
        out.append(sched._bucket_target())
        s.m.elastic.clear()
        out.append(sched._bucket_target())
        return out

    assert run_both(sides, script) == [128, 64, 32]
    from cometbft_tpu_torch.verifysched import service

    assert service.inflight_target() == service.INFLIGHT


def test_warmboot_mesh_shrink_matrix(sides, monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_WARMBOOT_MESH_SHRINK", raising=False)

    def script(s):
        out = [s.m.warmboot.mesh_shrink_matrix()]
        monkeypatch.setenv("COMETBFT_TPU_WARMBOOT_MESH_SHRINK", "1")
        out.append(s.m.warmboot.mesh_shrink_matrix())
        monkeypatch.setenv("COMETBFT_TPU_MESH_SUPERVISOR", "0")
        out.append(s.m.warmboot.mesh_shrink_matrix())
        monkeypatch.delenv("COMETBFT_TPU_MESH_SUPERVISOR")
        monkeypatch.delenv("COMETBFT_TPU_WARMBOOT_MESH_SHRINK")
        return out

    got = run_both(sides, script)
    assert got == [[], [(WIDTH, 32), (WIDTH - 1, 32)], []]
    # the port's pass runs the matrix through its seam (no family built)
    from cometbft_tpu_torch.ops import warmboot

    warmed = []
    monkeypatch.setattr(warmboot, "_warm_family", lambda family: {})
    monkeypatch.setattr(warmboot, "_warm_mesh", lambda w, lanes: (
        warmed.append((w, lanes)), {f"mesh{w}-{lanes}": {"status": "checked"}})[-1])
    monkeypatch.setenv("COMETBFT_TPU_WARMBOOT_MESH_SHRINK", "1")
    report = warmboot.run()
    assert warmed == got[1]
    assert report["statuses"]["mesh4-32"] == report["statuses"]["mesh3-32"] == "checked"


# -- the port alone: the real per-shard path ------------------------------------


def test_real_shards_on_cpu_ordinals(monkeypatch):
    """No runner: each of four CPU ordinals verifies its shard with the
    kernel's plain version (one ``mesh.shard`` span, one histogram sample
    each); the bits equal the oracle's, and ``verify_batch_sharded``'s
    host-summed count equals their sum."""
    from cometbft_tpu_torch.crypto import backend_health
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import dispatch_stats
    from cometbft_tpu_torch.parallel import elastic
    from cometbft_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setenv("COMETBFT_TPU_MESH_MIN_BATCH", "1")
    pubs, msgs, sigs, expected = mixed_batch(53, 2 * WIDTH + 3)
    m = pmesh.make_mesh(["cpu"] * WIDTH)
    assert len(set(m.ordinals)) == WIDTH
    elastic.clear()
    backend_health.reset()
    tracing.reset_tracer()
    dispatch_stats.reset()
    try:
        elastic.configure(m.ordinals)
        bits = elastic.verify_elastic(pubs, msgs, sigs, device="cpu")
        assert _bits(bits) == _bits(expected)
        shards = [s for s in tracing.get_tracer().tail(0) if s["stage"] == "mesh.shard"]
        assert [s["attrs"]["device"] for s in shards] == sorted(m.ordinals)
        assert {s["attrs"]["tier"] for s in shards} == {"torch"}
        assert sum(s["attrs"]["ok"] for s in shards) == int(expected.sum())
        snap = dispatch_stats.snapshot()
        assert sorted(snap["shard_hist"]) == sorted(str(o) for o in m.ordinals)
        assert snap["tier_dispatches"]["ed25519"]["torch"] == 1
    finally:
        elastic.clear()
        backend_health.reset()
        tracing.reset_tracer()
        dispatch_stats.reset()


def test_stable_ordinals_and_virtual_repeats():
    from cometbft_tpu_torch.parallel import mesh as pmesh

    a = pmesh.register_devices(["cpu", "cpu", "cpu"])
    assert len(set(a)) == 3
    assert pmesh.register_devices(["cpu", "cpu"]) == a[:2]  # first-seen, stable
    assert pmesh.stable_ordinal("cpu", 2) == a[2]
    assert pmesh.device_for_ordinal(a[1]) == torch.device("cpu")
    m = pmesh.mesh_of(a)
    arrays = {"s_ok": np.ones(5, bool), "a_bytes": np.ones((5, 32), np.uint8)}
    padded = pmesh.pad_to_mesh(arrays, m)
    assert padded["s_ok"].tolist() == [True] * 5 + [False]
    assert padded["a_bytes"].shape == (6, 32) and not padded["a_bytes"][5].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            pmesh.make_mesh()


def test_one_card_or_none_keeps_the_mesh_off(monkeypatch):
    """``_maybe_enable_mesh`` configures nothing without two CUDA devices
    (or ``COMETBFT_TPU_MESH=1`` on a card); ``COMETBFT_TPU_MESH=0`` vetoes."""
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.parallel import elastic

    elastic.clear()
    try:
        for env, cards, want in ((None, 0, None), ("1", 0, None), (None, 1, None),
                                 ("0", 2, None), (None, 2, (0, 1)), ("1", 1, (0, 1, 2, 3))):
            if env is None:
                monkeypatch.delenv("COMETBFT_TPU_MESH", raising=False)
            else:
                monkeypatch.setenv("COMETBFT_TPU_MESH", env)
            monkeypatch.setattr(torch.cuda, "is_available", lambda c=cards: c > 0)
            monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
            ov.reset_mesh_probe()
            registered = []
            import cometbft_tpu_torch.parallel.mesh as pmesh

            monkeypatch.setattr(pmesh, "register_devices", lambda ds: (
                registered.append(list(ds)), list(range(len(ds))))[-1])
            ov._maybe_enable_mesh()
            assert (elastic._ORDINALS if elastic.configured() else None) == want, (env, cards)
            elastic.clear()
    finally:
        ov.reset_mesh_probe()
        elastic.clear()


# -- on a card ------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, WIDTH])
def test_sharded_commit_on_the_card(card, width):
    """``dryrun_multichip``'s counterpart: an uneven 2W+3 batch with two
    invalid lanes and a 10,240-signature commit with bad (0, 5000, 10239)
    through ``verify_batch_sharded``, at W = the card count and at four
    virtual ordinals of cuda:0: the bits equal one launch's and the plain
    version's, the host-summed count their sum, W launches and W spans."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh() if width is None else pmesh.make_mesh([card] * width)
    w = m.size
    seed = b"\x11" * 32
    pub = ref.pubkey_from_seed(seed)
    for n, bad in ((2 * w + 3, (1, 2 * w + 2)), (10_240, (0, 5000, 10_239))):
        msgs = [b"mesh-commit-%d" % i for i in range(n)]
        sigs = [ref.sign(seed, x) for x in msgs]
        for i in bad:
            sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
        tracing.reset_tracer()
        before = cv.launches
        bits, n_ok = pmesh.verify_batch_sharded([pub] * n, msgs, sigs, m, count=True)
        assert cv.launches - before == w
        shards = [s for s in tracing.get_tracer().tail(0) if s["stage"] == "mesh.shard"]
        assert len(shards) == w
        arrays, _, structural = ov.prepare_batch([pub] * n, msgs, sigs)
        t = ov.batch_to_device(arrays, card)
        one = (cv.verify_core_cuda(**t).cpu().numpy() & structural)[:n]
        plain = (ov.verify_core(**t).cpu().numpy() & structural)[:n]
        assert (bits == one).all() and (bits == plain).all()
        assert [i for i in range(n) if not bits[i]] == list(bad)
        assert n_ok == int(bits.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["raise", "hang", "wrong_shape", "flap"])
def test_fault_modes_on_the_kernel(card, mode, monkeypatch):
    """Each mode on ordinal 2 of four virtual ordinals, no runner: the
    mesh shrinks 4->3, mesh_dev2 opens, a half-open probe restores it;
    every verdict equals the plain version's and no batch is served by
    ``torch`` or ``host``."""
    from cometbft_tpu_torch.crypto import backend_health
    from cometbft_tpu_torch.ops import dispatch_stats
    from cometbft_tpu_torch.parallel import elastic
    from cometbft_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setenv("COMETBFT_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "2000")
    clock = [100.0]
    m = pmesh.make_mesh([card] * WIDTH)
    elastic.clear()
    backend_health.reset()
    backend_health.registry().set_clock(lambda: clock[0])
    dispatch_stats.reset()
    pubs, msgs, sigs, expected = mixed_batch(59, 64)
    try:
        elastic.configure(m.ordinals)
        o2 = m.ordinals[2]
        elastic.set_fault_injector(elastic.FaultyDevice(mode, ordinals=(o2,), hang_s=3.0,
                                                        fail_n=1, pass_n=3))
        assert (elastic.verify_elastic(pubs, msgs, sigs) == expected).all()
        assert dispatch_stats.mesh_width() == WIDTH - 1
        assert backend_health.registry().breaker(f"mesh_dev{o2}").state == "open"
        elastic.clear_fault_injector()
        clock[0] += 10.0
        assert (elastic.verify_elastic(pubs, msgs, sigs) == expected).all()
        assert dispatch_stats.mesh_width() == WIDTH
        tiers = dispatch_stats.tier_counts()
        assert tiers["torch"] == (0, 0) and tiers["host"] == (0, 0) and tiers["cuda"][0] == 2
    finally:
        elastic.clear()
        backend_health.reset()
