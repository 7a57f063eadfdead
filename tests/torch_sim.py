"""Glue of the whole-network differentials: either package's
``sim/cluster.SimCluster`` and ``sim/scenarios.run_scenario`` by name, the
chain digest both must agree on, the txs a cluster is fed, and the one
table that maps the JAX package's tier names onto the port's.

``run_script`` drives a seeded four-validator ``SimCluster`` through one
of the differential scripts (``clean``, ``crash``, ``lossy``, ``join``),
its flight recorder reset on the virtual clock as ``run_scenario`` does,
each live mempool offered ``txs_per_height`` KVStore txs (from a numpy
seed) for every height up to one past the network's top, on a repeating
virtual-time timer.  ``run_pair`` runs one named scenario in both packages
(the port on ``device="cpu"``) and ``assert_same_runs`` holds the two
results to each other: traces line for line, commit hashes at every
height, ``summary()``, every stats block and every journal record, with
the JAX package's tier names mapped through ``TIER`` and nothing else.

The module imports neither package at the top: the jax-free subprocess of
``tests/test_torch_import_audit.py`` loads it.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import re
import signal
import threading
from pathlib import Path

import numpy as np

JAX = "cometbft_tpu"
PORT = "cometbft_tpu_torch"
CHAIN_ID = "sim-chain"
N_VALS = 4
TX_SEED = 7
FEED_INTERVAL = 0.5  # virtual seconds between mempool feeds

# The JAX package's tier names -> the port's (``cuda``, ``torch``,
# ``host``): its XLA verify is the port's plain PyTorch version, its
# host tiers (``numpy``, ``pure``) are the port's one ``host`` tier.
TIER = {"pallas": "cuda", "xla": "torch", "numpy": "host", "pure": "host"}
_TIER_WORD = re.compile(r"\b(%s)\b" % "|".join(TIER))


def sim(pkg: str):
    return importlib.import_module(f"{pkg}.sim")


def txs_at(height: int, n: int) -> list:
    """``n`` KVStore txs (``key=value``) offered before ``height``."""
    rng = np.random.default_rng(TX_SEED * 1000 + height)
    return [b"k%d-%d=%s" % (height, i, rng.bytes(12).hex().encode())
            for i in range(n)]


@contextlib.contextmanager
def wall_bound(seconds: int):
    """Fail the enclosed block with ``TimeoutError`` after ``seconds`` of
    wall time (SIGALRM: the main thread only)."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s wall bound")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


# -- the differential scripts -------------------------------------------------


def cluster(pkg: str, root, seed: int = 0, txs_per_height: int = 0,
            device=None, links=None):
    """``N_VALS`` validators of ``pkg``'s ``SimCluster`` (raising on a
    violation), every link's ``LinkConfig`` updated by ``links``, the
    flight recorder reset on the virtual clock, fed ``txs_per_height``
    txs a height.  ``device`` goes to the port's cluster."""
    kw = {"device": device} if pkg == PORT else {}
    c = sim(pkg).SimCluster(N_VALS, Path(root), seed=seed,
                            raise_on_violation=True, **kw)
    for cfg in c.net.links.values():
        cfg.update(**(links or {}))
    c.tracer = importlib.import_module(f"{pkg}.libs.tracing").get_tracer()
    c.tracer.reset()
    c.tracer.set_clock(c.clock.now)
    if txs_per_height:
        fed = [0]

        def feed() -> None:
            top = max(n.block_store.height() for n in c.live_nodes())
            while fed[0] <= top:
                h = fed[0] + 1
                txs = txs_at(h, txs_per_height)
                for node in c.live_nodes():
                    for tx in txs:
                        try:
                            node.mempool.check_tx(tx)
                        except Exception:  # noqa: BLE001 — in cache, full
                            pass
                c._log("feed h=%d txs=%d" % (h, len(txs)))
                fed[0] = h
            c.clock.call_later(FEED_INTERVAL, feed, label="feed")

        c.clock.call_later(0.0, feed, label="feed")
    return c


def stop(c) -> None:
    """Stop the cluster and give the flight recorder its wall clock back."""
    c.stop()
    c.tracer.set_clock(None)


def run_script(pkg: str, root, script: str = "clean", seed: int = 42,
               heights: int = 5, txs_per_height: int = 16, device=None):
    """One of the differential scripts, run to ``heights`` on every node:
    ``clean``; ``crash`` (node 1 crashes once the network has height 3,
    the others run two heights on, then it restarts from its stores);
    ``lossy`` (every link drops 5% and reorders 20% of messages); ``join``
    (node 3 crashes once the network has height 2, the others run to
    height 8, past the KVStore snapshot at 5, then node 3 joins through
    statesync as a fresh machine)."""
    links = {"drop_rate": 0.05, "reorder_rate": 0.2} if script == "lossy" else None
    c = cluster(pkg, root, seed=seed, txs_per_height=txs_per_height,
                device=device, links=links)
    if script == "join":
        assert c.run(2), c.heights()
        c.crash(3)
        c.members.discard(3)
        assert c.run(8), c.heights()
        assert c.join(3), c.trace[-3:]
    if script == "crash":
        assert c.run(3), c.heights()
        c.crash(1)
        c.members.discard(1)
        assert c.run(5), c.heights()
        c.members.add(1)
        c.restart(1)
    assert c.run(heights), c.heights()
    return c


def chain(c, upto: int) -> dict:
    """What must agree across packages, per live node: each height's block
    hash and the app hash after it, from the node's base (a statesync
    joiner holds no earlier block), and the WAL's #ENDHEIGHT set."""
    out = {}
    for node in c.live_nodes():
        blocks, apps = [], []
        for h in range(max(node.block_store.base(), 1), upto + 1):
            meta = node.block_store.load_block_meta(h)
            blocks.append(meta.block_id.hash.hex())
            nxt = node.block_store.load_block_meta(h + 1)
            apps.append(nxt.header.app_hash.hex() if nxt is not None
                        else node.state_store.load().app_hash.hex())
        ends, _ = node.cs.wal.scan_end_heights(0)
        out[node.index] = {"blocks": blocks, "apps": apps,
                           "ends": sorted(e for e in ends if e <= upto)}
    return out


# -- the scenario differentials ------------------------------------------------


def map_line(line: str) -> str:
    """A string with the JAX tier names, as words, mapped."""
    return _TIER_WORD.sub(lambda m: TIER[m.group(1)], line)


def map_tiers(obj):
    """``obj`` with every JAX tier name (as a word of a dict key or a
    string) replaced by the port's; the numbers of two keys that map to
    one name are summed."""
    if isinstance(obj, dict):
        out: dict = {}
        for k, v in obj.items():
            k2 = map_line(k) if isinstance(k, str) else k
            v2 = map_tiers(v)
            if k2 in out and isinstance(v2, (int, float)):
                out[k2] += v2
            else:
                out[k2] = v2
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tiers(v) for v in obj)
    if isinstance(obj, str):
        return map_line(obj)
    return obj


@contextlib.contextmanager
def own_threads_only(pkgs=(JAX, PORT)):
    """While the block runs, the black-box sinks a ``SimCluster`` installs
    (``libs/tracing.set_sink``) take no record from a thread that was alive
    before the block began, other than the caller's: such a thread is
    another test's (a node it did not join, still verifying), and the
    cluster would route its spans into whichever node's journal is active
    (``SimCluster.active_node``).  The scenario's own threads (the caller,
    the scheduler's, the watchdog's, every thread started during the run)
    record as before, in both packages alike."""
    foreign = set(threading.enumerate()) - {threading.current_thread()}
    saved = []
    for pkg in pkgs:
        tr = importlib.import_module(f"{pkg}.libs.tracing")
        real = tr.set_sink

        def set_sink(kind, fn, real=real):
            owner = getattr(fn, "__self__", None)
            if fn is not None and type(owner).__name__ == "SimCluster":
                inner = fn

                def fn(*a):
                    if threading.current_thread() not in foreign:
                        inner(*a)
            return real(kind, fn)

        tr.set_sink = set_sink
        saved.append((tr, real))
    try:
        yield
    finally:
        for tr, real in saved:
            tr.set_sink = real


def run_pair(name: str, seed: int, root, **kw):
    """``run_scenario(name, seed)`` in the JAX package and in the port on
    the CPU, each under its own directory of ``root``, clusters kept, the
    journals holding the scenario's own records (``own_threads_only``)."""
    out = []
    with own_threads_only():
        for pkg in (JAX, PORT):
            dev = {"device": "cpu"} if pkg == PORT else {}
            out.append(sim(pkg).run_scenario(
                name, seed, root=Path(root) / pkg, raise_on_violation=True,
                keep_cluster=True, **dev, **kw))
    return out


def _relative(obj, root: str):
    """``obj`` with the run's root directory cut out of its strings: each
    package runs under its own, the one difference by construction."""
    if isinstance(obj, dict):
        return {k: _relative(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_relative(v, root) for v in obj)
    return obj.replace(root, "<root>") if isinstance(obj, str) else obj


def _records(pkg: str, root) -> dict:
    """Every node's decoded black-box journal under ``root``."""
    bb = importlib.import_module(f"{pkg}.libs.blackbox")
    out = {}
    for d in sorted(Path(root).glob("node*/blackbox")):
        recs = bb.decode_dir(str(d))[0]
        out[str(d.relative_to(root))] = _relative(recs, str(root))
    return out


def _dumps(root) -> dict:
    """Each anomaly dump's lines."""
    return {f.name: [json.loads(ln) for ln in f.read_text().splitlines()]
            for f in sorted((Path(root) / "flight").glob("*.jsonl"))}


# the verify scheduler's counters beyond ``summary()``'s that follow the
# run's flushes: the items drained, the unique ones shipped, their lanes
_FLUSH_KEYS = ("flush_items", "flush_misses", "flush_lanes")


def _own_transport(block: dict) -> dict:
    """A run's transport counters without its serial frames: the simulator
    opens no ``SecretConnection``, so a serially sealed or opened frame in
    the process-wide counter is another test's connection still alive in
    the worker (its pings), in either package.  Nothing left: no block."""
    if not block:
        return {}
    out = json.loads(json.dumps(block))
    serial = out["frames"]["serial"]
    out["frames"]["serial"] = 0
    out["frames_total"] -= serial
    return out if out["frames_total"] or out["handshakes"]["pool"] or out[
        "handshakes"]["sync"] else {}


def assert_same_runs(j, p, root) -> None:
    """The JAX result ``j`` and the port's ``p`` of one scenario and seed,
    run under ``root`` by ``run_pair``: equal after ``map_tiers``, the
    scheduler's flushes, the spans recorded and every journal and dump
    record included."""
    assert j.reached and p.reached, (j.heights, p.heights)
    assert not j.violations and not p.violations
    assert p.trace == [map_line(ln) for ln in j.trace]
    top = max(j.heights)
    assert [p.cluster.commit_hash(h) for h in range(1, top + 1)] == [
        j.cluster.commit_hash(h) for h in range(1, top + 1)]
    assert {k: p.sched.get(k) for k in _FLUSH_KEYS} == {
        k: j.sched.get(k) for k in _FLUSH_KEYS}
    js, ps = map_tiers(j.summary()), p.summary()
    for row in (js, ps):
        own = _own_transport(row.pop("transport", {}))
        if own:
            row["transport"] = own
        # a journal's byte counts follow the lengths of the tier names in
        # its records, which are compared one by one below
        for k in ("bytes", "disk_bytes"):
            row.get("blackbox", {}).pop(k, None)
    assert ps == js, {k: (ps.get(k), js.get(k)) for k in set(ps) | set(js)
                      if ps.get(k) != js.get(k)}
    for block in ("backend", "evidence", "storage", "bsync"):
        assert getattr(p, block) == map_tiers(getattr(j, block)), block
    assert _own_transport(p.transport) == map_tiers(_own_transport(j.transport))
    assert p.rotations == j.rotations and p.fail_stopped == j.fail_stopped
    assert _relative(p.postmortems, str(Path(root) / PORT)) == map_tiers(
        _relative(j.postmortems, str(Path(root) / JAX)))
    assert _records(PORT, Path(root) / PORT) == map_tiers(
        _records(JAX, Path(root) / JAX))
    assert _dumps(Path(root) / PORT) == map_tiers(_dumps(Path(root) / JAX))


def reset_caches() -> None:
    """Empty both packages' signature caches: a verdict cached by an
    earlier test would spare one package a dispatch the other makes."""
    for pkg in (JAX, PORT):
        importlib.import_module(f"{pkg}.crypto.sigcache").reset_cache()
