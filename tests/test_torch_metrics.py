"""The port's Prometheus metrics (``cometbft_tpu_torch/libs/metrics.py``),
its pprof server (``node/pprof.py``) and the card's health gauge
(``ops/device_health.py``) against the JAX package's.

Both packages' stats modules are reset and fed the same counter states,
the same gauges set and the same histograms observed: the two
``NodeMetrics`` registries render the same Prometheus text, the mesh and
shard families (``MESH_FAMILIES``, fed through ``parallel/elastic``'s
counters in ``ops/dispatch_stats``) included, less what the port names
differently on purpose:

  * ``TIER_LABELS``: the AEAD passes' host tiers, ``numpy`` and ``pure``
    in the JAX package, one ``host`` pass in the port;
  * ``HELP``: the warm-boot build counter's help text (nvcc, not XLA).

Then ``MetricsServer`` and ``PprofServer`` answer over HTTP on port 0, and
``device_health`` folds a status file into the gauge as the JAX module
does.
"""

from __future__ import annotations

import importlib
import json
import urllib.request

import pytest

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
MESH_FAMILIES = ("cometbft_crypto_shard_dispatch_seconds", "cometbft_crypto_mesh_width",
                 "cometbft_crypto_mesh_shrinks", "cometbft_crypto_mesh_restores")
TIER_LABELS = {'cometbft_transport_aead_dispatches{tier="numpy"}': None,
               'cometbft_transport_aead_dispatches{tier="pure"}': None,
               'cometbft_transport_aead_dispatches{tier="host"}': None}
HELP = ("# HELP cometbft_crypto_warmboot_compiles ",)
STATS = ("ops.dispatch_stats", "verifysched.stats", "txingest.stats", "blocksync.stats",
         "proofserve.stats", "ops.warm_stats", "libs.storage_stats", "evidence.stats",
         "p2p.transport_stats", "crypto.backend_health", "ops.device_health")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _reset(pkg: str) -> None:
    for name in STATS:
        _m(pkg, name).reset()
    _m(pkg, "crypto.sigcache").reset_cache()
    _m(pkg, "libs.tracing").reset_tracer()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_CHIP_STATUS", raising=False)
    for pkg in PKGS:
        _reset(pkg)
    yield
    for pkg in PKGS:
        _reset(pkg)


def _feed(pkg: str):
    """The same counter states in ``pkg``'s stats modules, and a
    ``NodeMetrics`` with the same gauges and histograms."""
    ds, ss = _m(pkg, "ops.dispatch_stats"), _m(pkg, "verifysched.stats")
    ds.record_dispatch(256, 200)
    ds.record_dispatch(32, 3)
    ds.record_dispatch_time("cuda", 256, 0.004)
    ds.record_fused(3)
    ds.record_verify_latency(0.0123)
    ds.record_lane_dispatch("cuda", 256, 200)
    ds.record_lane_dispatch("2", 32, 9)
    ds.record_shard_time("cuda", 2, 64, 0.0031)
    ds.record_mesh_width(3)
    ds.record_mesh_shrink()
    ds.record_mesh_restore()
    for prio in (0, 1, 3):
        ss.record_submit(prio)
    ss.record_shed(3)
    ss.record_dedup(2)
    ss.record_shed_fallback(3, 0.002)
    ist = _m(pkg, "txingest.stats")
    ist.record_enqueue(5)
    ist.record_flush(5, 256)
    ist.record_reject(102)
    ist.record_error("too_large")
    bs = _m(pkg, "blocksync.stats")
    bs.record_request(4)
    bs.record_timeout()
    bs.record_gauges(3, 2)
    ps = _m(pkg, "proofserve.stats")
    ps.record_query("tx")
    ps.record_flush("size", 4, 2)
    ps.record_tree(64, 64, True)
    st = _m(pkg, "libs.storage_stats")
    st.record_op("wal", "append")
    st.record_retry("blackbox")
    _m(pkg, "evidence.stats").record("committed", 2)
    tp = _m(pkg, "p2p.transport_stats")
    tp.record_frames("batched", 8)
    tp.record_batch("seal")
    tp.record_dispatch("device", 8, 16)
    tp.record_hs_dispatch(True, 4, 8)
    bh = _m(pkg, "crypto.backend_health")
    bh.registry().breaker("secp_device").record_failure(RuntimeError("x"))
    bh.registry().record_demotion("secp_device")
    _m(pkg, "libs.tracing").record_anomaly("queue_shed", cls="bulk")
    m = _m(pkg, "libs.metrics").NodeMetrics()
    m.height.set(7)
    m.rounds.set(1)
    m.validators.set(4)
    m.peers.set(3)
    m.block_interval.observe(1.25)
    m.block_interval.observe(0.5)
    return m


def _text(pkg: str) -> "list[str]":
    lines = _feed(pkg).registry.expose().splitlines()
    out = []
    for ln in lines:
        name = ln.split(" ", 3)[2] if ln.startswith("#") else ln.split("{")[0].split(" ")[0]
        if ln.rsplit(" ", 1)[0] in TIER_LABELS or ln.startswith(HELP):
            continue
        out.append(ln)
    return out


def test_same_counter_states_render_the_same_prometheus_text():
    got = {pkg: _text(pkg) for pkg in PKGS}
    assert got[PKGS[1]] == got[PKGS[0]]
    text = "\n".join(got[PKGS[1]])
    assert "cometbft_consensus_height 7" in text
    assert "cometbft_device_up -1" in text
    assert 'cometbft_crypto_dispatch_seconds_count{shape="cuda-256"} 1' in text
    assert "cometbft_consensus_block_interval_seconds_count 2" in text
    assert "cometbft_crypto_mesh_width 3" in text
    assert 'cometbft_crypto_shard_dispatch_seconds_count{device="2"} 1' in text


def test_node_metrics_families_are_the_jax_ones_less_the_mesh():
    """Since the mesh's port the families are the JAX ones whole: the mesh
    leaves none out."""
    names = {}
    for pkg in PKGS:
        m = _m(pkg, "libs.metrics").NodeMetrics()
        names[pkg] = {ln.split(" ")[2] for ln in m.registry.expose().splitlines()
                      if ln.startswith("# TYPE ")}
    assert names[PKGS[1]] == names[PKGS[0]]
    assert set(MESH_FAMILIES) <= names[PKGS[1]]
    port = _m(PKGS[1], "libs.metrics").NodeMetrics().registry.expose()
    assert 'cometbft_transport_aead_dispatches{tier="host"} 0' in port


def _get(url: str) -> "tuple[int, bytes]":
    with urllib.request.urlopen(url, timeout=20) as resp:
        return resp.status, resp.read()


def test_metrics_and_pprof_servers_answer_on_port_0():
    from cometbft_tpu_torch.libs.metrics import MetricsServer, NodeMetrics
    from cometbft_tpu_torch.node.pprof import PprofServer

    import tracemalloc

    tracing_before = tracemalloc.is_tracing()
    m = NodeMetrics()
    m.height.set(3)
    ms = MetricsServer(m.registry, "tcp://127.0.0.1:0")
    pp = PprofServer("tcp://127.0.0.1:0")
    ms.start()
    pp.start()
    try:
        status, body = _get(f"http://127.0.0.1:{ms.bound_port}/metrics")
        assert status == 200 and b"cometbft_consensus_height 3" in body
        port = pp.bound_port
        status, body = _get(f"http://127.0.0.1:{port}/debug/pprof/goroutine")
        assert status == 200 and b"MainThread" in body
        status, body = _get(f"http://127.0.0.1:{port}/debug/pprof/")
        assert status == 200 and b"goroutine" in body
        status, body = _get(f"http://127.0.0.1:{port}/debug/pprof/profile?seconds=0.2")
        assert status == 200
    finally:
        ms.stop()
        pp.stop()
        if not tracing_before:  # the pprof server starts tracemalloc
            tracemalloc.stop()


def test_device_health_folds_a_status_file_as_jax(tmp_path, monkeypatch):
    path = tmp_path / "status.json"
    monkeypatch.setenv("COMETBFT_TPU_CHIP_STATUS", str(path))
    snaps = {pkg: [] for pkg in PKGS}
    for i, doc in enumerate(({"up": True, "platform": "gpu", "init_s": 1.5, "t": 10.0},
                             {"up": False, "t": 20.0, "ordinals": {"0": False}},
                             "{torn")):
        path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
        import os

        os.utime(path, (100.0 + i, 100.0 + i))
        for pkg in PKGS:
            dh = _m(pkg, "ops.device_health")
            snap = dh.snapshot()
            snaps[pkg].append({k: v for k, v in snap.items() if k != "_file_mtime"})
    assert snaps[PKGS[1]] == snaps[PKGS[0]]
    assert [s["up_code"] for s in snaps[PKGS[1]]] == [1, 0, 0]
    assert snaps[PKGS[1]][1]["ordinals"] == {"0": False}
