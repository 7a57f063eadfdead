"""CLI entry point (reference: cmd/cometbft/main.go:15-35 + commands/).

Commands: init, start, show-node-id, show-validator, gen-validator,
unsafe-reset-all, version, testnet, rollback, inspect, light, confix,
compact-db, debug kill/dump, reindex-event, sim, trace, postmortem.
``python -m cometbft_tpu_torch.cmd --home <dir> <command>``.

The port's copy of the JAX package's ``cmd/main.py``.  ``start``,
``light`` and ``sim`` run on the card; with no card they raise unless
``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` asks for the CPU
(``types/validation.require_device``).  ``sim`` runs every scenario of
the JAX package (``sim/scenarios``), the three elastic-mesh ones over
virtual ordinals.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time

from cometbft_tpu_torch.config import config as cfgmod
from cometbft_tpu_torch.version import __version__


def _load_config(home: str):
    path = os.path.join(home, "config", "config.toml")
    if os.path.exists(path):
        cfg = cfgmod.load_config(home)
    else:
        cfg = cfgmod.default_config()
    cfg.base.home = home
    return cfg



def _run_until_signal(cleanup_fn) -> int:
    """Block until SIGINT/SIGTERM, then run cleanup (shared by the daemon
    commands: start, inspect, light)."""
    import signal
    import time as _time

    stop = {"flag": False}

    def _sig(*_a):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop["flag"]:
            _time.sleep(0.2)
    finally:
        cleanup_fn()
    return 0


def cmd_init(args) -> int:
    """Reference: commands/init.go — write config, genesis, node key, privval."""
    from cometbft_tpu_torch.node.nodekey import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.basic import Timestamp
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    home = args.home
    cfg = cfgmod.default_config()
    cfg.base.home = home
    cfgmod.write_config(cfg)

    pv = FilePV.load_or_generate(
        os.path.join(home, cfg.base.priv_validator_key_file),
        os.path.join(home, cfg.base.priv_validator_state_file),
    )
    NodeKey.load_or_generate(os.path.join(home, cfg.base.node_key_file))

    genesis_path = os.path.join(home, cfg.base.genesis_file)
    if not os.path.exists(genesis_path):
        chain_id = args.chain_id or f"test-chain-{int(time.time()) % 100000}"
        gdoc = GenesisDoc(
            chain_id=chain_id,
            genesis_time=Timestamp.now(),
            validators=[GenesisValidator(pv.pub_key(), 10)],
        )
        os.makedirs(os.path.dirname(genesis_path), exist_ok=True)
        with open(genesis_path, "w") as f:
            f.write(gdoc.to_json())
        print(f"Generated genesis file {genesis_path}")
    print(f"Initialized node in {home}")
    return 0


def cmd_start(args) -> int:
    """Reference: commands/run_node.go."""
    from cometbft_tpu_torch.node.node import Node

    cfg = _load_config(args.home)
    if args.proxy_app:
        cfg.base.proxy_app = args.proxy_app
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    err = cfg.validate_basic()
    if err:
        print(f"invalid config: {err}", file=sys.stderr)
        return 1
    node = Node(cfg)
    node.start()

    stop = []

    def on_signal(signum, frame):
        stop.append(signum)

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        node.stop()
    return 0


def cmd_show_node_id(args) -> int:
    from cometbft_tpu_torch.node.nodekey import NodeKey

    cfg = _load_config(args.home)
    nk = NodeKey.load_or_generate(
        os.path.join(args.home, cfg.base.node_key_file)
    )
    print(nk.node_id)
    return 0


def cmd_show_validator(args) -> int:
    import base64

    from cometbft_tpu_torch.privval.file_pv import FilePV

    cfg = _load_config(args.home)
    pv = FilePV.load_or_generate(
        os.path.join(args.home, cfg.base.priv_validator_key_file),
        os.path.join(args.home, cfg.base.priv_validator_state_file),
    )
    print(
        json.dumps(
            {
                "type": "tendermint/PubKeyEd25519",
                "value": base64.b64encode(pv.pub_key().bytes()).decode(),
            }
        )
    )
    return 0


def cmd_gen_validator(args) -> int:
    import base64

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    priv = Ed25519PrivKey.generate()
    print(
        json.dumps(
            {
                "address": priv.pub_key().address().hex().upper(),
                "pub_key": {
                    "type": "tendermint/PubKeyEd25519",
                    "value": base64.b64encode(priv.pub_key().bytes()).decode(),
                },
                "priv_key": {
                    "type": "tendermint/PrivKeyEd25519",
                    "value": base64.b64encode(priv.bytes()).decode(),
                },
            },
            indent=2,
        )
    )
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """Reference: commands/reset.go — wipe data dir, keep config + keys,
    reset privval state."""
    cfg = _load_config(args.home)
    data_dir = os.path.join(args.home, cfg.base.db_dir)
    if os.path.isdir(data_dir):
        shutil.rmtree(data_dir)
        os.makedirs(data_dir)
        print(f"Removed all data in {data_dir}")
    pv_state = os.path.join(args.home, cfg.base.priv_validator_state_file)
    os.makedirs(os.path.dirname(pv_state), exist_ok=True)
    with open(pv_state, "w") as f:
        json.dump({"height": 0, "round": 0, "step": 0}, f)
    print("Reset private validator state")
    return 0


def cmd_testnet(args) -> int:
    """Reference: commands/testnet.go — generate N validator home dirs
    sharing one genesis."""
    from cometbft_tpu_torch.node.nodekey import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.basic import Timestamp
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    n = args.v
    out = args.o
    chain_id = args.chain_id or f"testnet-{int(time.time()) % 100000}"
    pvs = []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        cfg = cfgmod.default_config()
        cfg.base.home = home
        cfg.rpc.laddr = f"tcp://127.0.0.1:{26657 + 10 * i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{26656 + 10 * i}"
        cfgmod.write_config(cfg)
        pv = FilePV.load_or_generate(
            os.path.join(home, cfg.base.priv_validator_key_file),
            os.path.join(home, cfg.base.priv_validator_state_file),
        )
        NodeKey.load_or_generate(os.path.join(home, cfg.base.node_key_file))
        pvs.append(pv)

    gdoc = GenesisDoc(
        chain_id=chain_id,
        genesis_time=Timestamp.now(),
        validators=[GenesisValidator(pv.pub_key(), 10) for pv in pvs],
    )
    for i in range(n):
        path = os.path.join(out, f"node{i}", "config", "genesis.json")
        with open(path, "w") as f:
            f.write(gdoc.to_json())
    print(f"Successfully initialized {n} node directories in {out}")
    return 0


def cmd_rollback(args) -> int:
    """Reference: commands/rollback.go — roll state back one height."""
    from cometbft_tpu_torch.node.rollback import rollback_state

    cfg = _load_config(args.home)
    height, app_hash = rollback_state(cfg, remove_block=args.hard)
    print(f"Rolled back state to height {height} and hash {app_hash.hex()}")
    return 0


def cmd_version(args) -> int:
    print(__version__)
    return 0


def cmd_sim(args) -> int:
    """Deterministic simulation: run a fault scenario on virtual time and
    report whether the cluster reached the target height with the
    agreement/validity/WAL invariants intact.  Same seed ⇒ byte-identical
    event trace (``sim/``).  On the card; ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``
    asks for the CPU."""
    from cometbft_tpu_torch.sim import SCENARIOS, run_scenario

    if args.list:
        for name, sc in SCENARIOS.items():
            print(f"{name:20s} {sc.description}")
        return 0
    if args.scenario not in SCENARIOS:
        print(
            f"unknown scenario {args.scenario!r}; --list shows the options",
            file=sys.stderr,
        )
        return 1
    result = run_scenario(
        args.scenario,
        args.seed,
        n_vals=args.validators or None,
        target_height=args.height or None,
        max_time=args.max_time or None,
    )
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write("\n".join(result.trace) + "\n")
        print(f"wrote {len(result.trace)} trace lines to {args.trace_out}")
    summary = result.summary()
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(
            "scenario=%s seed=%d reached=%s heights=%s virtual_time=%.1fs "
            "events=%d commits_verified=%d"
            % (
                summary["scenario"],
                summary["seed"],
                summary["reached"],
                summary["heights"],
                summary["virtual_time"],
                summary["events"],
                summary["commits_verified"],
            )
        )
        for v in summary["violations"]:
            print(f"INVARIANT VIOLATION: {v}")
    return 0 if summary["reached"] and summary["invariants_ok"] else 1


def cmd_trace(args) -> int:
    """Snapshot the verify-pipeline flight recorder + pipeline health as
    one JSON document (docs/observability.md).  ``--rpc`` queries a
    running node's ``/debug/verify_trace`` endpoint; ``--local`` renders
    this process's own recorder (mostly useful under test harnesses that
    import the node in-process)."""
    if args.local:
        from cometbft_tpu_torch.libs import tracing

        doc = tracing.trace_document(
            max_spans=args.spans, rounds=args.rounds
        )
    else:
        import urllib.request

        addr = args.rpc
        if addr.startswith("tcp://"):
            addr = "http://" + addr[len("tcp://"):]
        if not addr.startswith(("http://", "https://")):
            addr = "http://" + addr
        url = (
            f"{addr.rstrip('/')}/debug_verify_trace"
            f"?spans={args.spans}&rounds={args.rounds}"
        )
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                reply = json.loads(resp.read())
        except (OSError, ValueError) as e:
            # ValueError covers a non-JSON body (proxy error page,
            # truncated response) — a diagnostic CLI must not traceback
            print(f"cannot reach {url}: {e}", file=sys.stderr)
            return 1
        if "error" in reply:
            print(f"rpc error: {reply['error']}", file=sys.stderr)
            return 1
        doc = reply.get("result", {})
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    # human summary: health first, then the stage latency table
    t = doc.get("tracing", {})
    print(
        "flight recorder: %s spans=%s dropped=%s anomalies=%s dumps=%s"
        % (
            "on" if t.get("enabled") else "OFF",
            t.get("spans_recorded"),
            t.get("spans_dropped"),
            t.get("anomalies_total"),
            t.get("dump_count"),
        )
    )
    for kind, n in sorted((t.get("anomalies") or {}).items()):
        print(f"  anomaly {kind}: {n}")
    backend = doc.get("backend", {})
    for name, br in sorted((backend.get("breakers") or {}).items()):
        print(
            "breaker %-12s %-9s opens=%s last_error=%s"
            % (name, br.get("state"), br.get("opens"), br.get("last_error") or "-")
        )
    dev = doc.get("device", {})
    if dev and dev.get("up") is not None:
        print(
            "device: %s platform=%s probes=%s transitions=%s source=%s"
            % (
                "UP" if dev.get("up") else "DOWN",
                dev.get("platform") or "?",
                dev.get("probes"),
                dev.get("transitions"),
                dev.get("source"),
            )
        )
    disp = doc.get("dispatch", {})
    if disp.get("mesh_width"):
        print(
            "mesh: width=%s shrinks=%s restores=%s"
            % (
                disp.get("mesh_width"),
                disp.get("mesh_shrinks"),
                disp.get("mesh_restores"),
            )
        )
    bb = doc.get("blackbox", {})
    if bb and "records" in bb:
        print(
            "blackbox: records=%s bytes=%s dropped=%s segments=%s"
            % (
                bb.get("records"),
                bb.get("bytes"),
                bb.get("dropped"),
                bb.get("segments"),
            )
        )
    sig = doc.get("sigcache", {})
    if sig:
        print(
            "sigcache: hit_rate=%.2f size=%s/%s"
            % (sig.get("hit_rate", 0.0), sig.get("size"), sig.get("capacity"))
        )
    sched = doc.get("sched", {})
    if sched:
        print(
            "sched: queue_depth=%s shed=%s dedup=%s"
            % (
                sched.get("queue_depth"),
                sched.get("shed_total"),
                sched.get("dedup_hits"),
            )
        )
    warm = doc.get("warmboot", {})
    if warm:
        print(
            "warmboot: runs=%s shapes=%s compiles=%s exec_hits=%s"
            % (
                warm.get("warm_runs"),
                warm.get("shapes_warmed"),
                warm.get("compiles"),
                warm.get("exec_hits"),
            )
        )
    stages = doc.get("stages", {})
    if stages:
        print(f"{'stage':24s} {'count':>7s} {'p50ms':>9s} {'p99ms':>9s} {'maxms':>9s}")
        for stage, row in sorted(stages.items()):
            print(
                "%-24s %7d %9.3f %9.3f %9.3f"
                % (
                    stage,
                    row["count"],
                    row["p50_ms"],
                    row["p99_ms"],
                    row["max_ms"],
                )
            )
    rounds = doc.get("rounds") or {}
    if rounds.get("rounds_seen"):
        print(
            "rounds: seen=%s commits linked=%s unlinked=%s standalone=%s"
            % (
                rounds.get("rounds_seen"),
                rounds.get("commits_linked"),
                rounds.get("commits_unlinked"),
                rounds.get("commits_standalone"),
            )
        )
        for step, s in sorted((rounds.get("steps") or {}).items()):
            print(
                "  step %-22s n=%-5d p50=%8.3fms p99=%8.3fms"
                % (step, s.get("count", 0), s.get("p50_ms", 0.0),
                   s.get("p99_ms", 0.0))
            )
        for k, q in sorted((rounds.get("quorum") or {}).items()):
            if q.get("count"):
                print(
                    "  quorum %-20s n=%-5d p50=%8.3fms p99=%8.3fms"
                    % (k, q["count"], q.get("p50_ms", 0.0),
                       q.get("p99_ms", 0.0))
                )
        for g in rounds.get("rounds") or []:
            committed = sum(
                1 for nd in g["nodes"] if nd.get("committed")
            )
            print(
                "  round h=%-5s r=%-3s origin=%-4s trace=%-6s nodes=%d "
                "committed=%d verify_commits=%d"
                % (
                    g["h"], g["r"],
                    "?" if g["origin"] is None else g["origin"],
                    "?" if g["trace"] is None else g["trace"],
                    len(g["nodes"]), committed, g["commits"],
                )
            )
    return 0


def cmd_postmortem(args) -> int:
    """Reconstruct a dead node's final timeline from its black-box
    journal (docs/observability.md "Black box"): last committed height,
    the in-flight consensus round (step spans, quorum arrivals), open
    spans at death, the last verify-dispatch attribution triple, recent
    anomalies and last-known breaker states.  A torn final record is a
    normal crash artifact; corruption is skipped and counted, never
    raised.  ``--json`` prints the full report (sort_keys-stable, so two
    same-seed sim crashes byte-compare)."""
    from cometbft_tpu_torch.libs import blackbox

    target = blackbox.resolve_dir(args.dir)
    if target is None:
        print(f"no black-box journal under {args.dir}", file=sys.stderr)
        return 1
    report = blackbox.postmortem_report(target, recent=args.recent)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    j = report["journal"]
    print(
        "journal: %d records in %d segment(s), %d bytes%s%s"
        % (
            j["records"],
            j["segments"],
            j["bytes"],
            ", %d corrupt skipped" % j["corrupt_skipped"]
            if j["corrupt_skipped"]
            else "",
            ", torn tail" if j["torn_tail"] else "",
        )
    )
    print(
        "shutdown: %s"
        % ("CLEAN" if report["clean_close"] else "UNCLEAN (no sentinel)")
    )
    print("last committed height: %s" % report["last_committed_height"])
    inf = report["in_flight"]
    if inf:
        print(
            "in-flight round at death: h=%s r=%s node=%s (opened t=%s)"
            % (inf["h"], inf["r"], inf["node"], inf["t0"])
        )
        for step, dur in sorted(inf["steps"].items()):
            print("  step %-24s %s ms" % (step, dur))
        for k, ms in sorted(inf["quorum"].items()):
            print("  quorum %-22s %s ms" % (k, ms))
    else:
        print("in-flight round at death: none recorded")
    ld = report["last_dispatch"]
    if ld:
        print(
            "last dispatch: tier=%s lanes=%s n=%s ordinal=%s%s"
            % (
                ld["tier"],
                ld["lanes"],
                ld["n"],
                ld["dispatch"],
                " mesh=%s" % ld["mesh"] if ld.get("mesh") else "",
            )
        )
    mesh = report.get("mesh") or {}
    if mesh.get("width") is not None:
        print("mesh width at death: %s" % mesh["width"])
        for ev in mesh.get("events") or ():
            a = ev.get("attrs") or {}
            print(
                "  mesh reconfig t=%s width=%s reason=%s%s%s"
                % (
                    ev.get("t"),
                    a.get("width"),
                    a.get("reason"),
                    " excluded=%s" % a["excluded"] if "excluded" in a else "",
                    " restored=%s" % a["restored"] if "restored" in a else "",
                )
            )
    for sp in report["open_spans"]:
        print(
            "open span at death: %s (span=%s t0=%s) %s"
            % (sp["stage"], sp["span"], sp["t0"], sp["attrs"])
        )
    for kind, n in sorted(report["anomaly_counts"].items()):
        print("anomaly %s: %d" % (kind, n))
    for backend, st in sorted(report["breakers"].items()):
        print(
            "breaker %-12s %-7s%s"
            % (
                backend,
                st["state"],
                " last_error=%s" % st["error"] if st.get("error") else "",
            )
        )
    for ev in report["device_events"]:
        a = ev.get("attrs") or {}
        print(
            "device probe t=%s up=%s platform=%s"
            % (ev.get("t"), a.get("up"), a.get("platform"))
        )
    return 0


def cmd_inspect(args) -> int:
    """Reference: internal/inspect — read-only RPC over the data dir."""
    from cometbft_tpu_torch.node.inspect import InspectNode

    cfg = _load_config(args.home)
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    node = InspectNode(cfg).serve()
    print(
        f"Inspect server listening on {cfg.rpc.laddr} "
        f"(store height {node.block_store.height()})"
    )
    return _run_until_signal(node.close)


def cmd_light(args) -> int:
    """Reference: cmd light — run a light-client RPC proxy daemon."""
    from cometbft_tpu_torch.light import (
        SKIPPING,
        HTTPProvider,
        LightClient,
        LightStore,
        TrustOptions,
    )
    from cometbft_tpu_torch.light.proxy import LightProxy
    from cometbft_tpu_torch.store.kv import SqliteKV

    primary = HTTPProvider(args.chain_id, args.primary)
    witnesses = [
        HTTPProvider(args.chain_id, w) for w in (args.witnesses or "").split(",") if w
    ]
    if bool(args.trust_height) != bool(args.trust_hash):
        print("error: --trust-height and --trust-hash must be given together")
        return 1
    if args.trust_height:
        opts = TrustOptions(
            period_s=args.trust_period,
            height=args.trust_height,
            hash=bytes.fromhex(args.trust_hash),
        )
    else:
        lb = primary.light_block(0)
        opts = TrustOptions(
            period_s=args.trust_period, height=lb.height, hash=lb.hash()
        )
        print(f"WARNING: trusting the primary's latest header blindly "
              f"(height {lb.height}); pass --trust-height/--trust-hash")
    os.makedirs(os.path.join(args.home, "light"), exist_ok=True)
    store = LightStore(
        SqliteKV(os.path.join(args.home, "light", "trust.db"), surface="light")
    )
    client = LightClient(args.chain_id, opts, primary, witnesses, store)  # the card
    proxy = LightProxy(client, args.primary, laddr=args.laddr)
    proxy.start()
    print(f"Light client proxy listening on {args.laddr} "
          f"(trusted height {client.trusted_light_block().height})")
    return _run_until_signal(proxy.stop)


def cmd_confix(args) -> int:
    """Reference: internal/confix — migrate config.toml to this version."""
    from cometbft_tpu_torch.config.confix import upgrade

    report = upgrade(args.home, dry_run=args.dry_run)
    for key in report["carried"]:
        print(f"carried: {key}")
    for key in report["unknown"]:
        print(f"unknown (dropped): {key}")
    if report["backup"]:
        print(f"backup written to {report['backup']}")
    elif args.dry_run:
        print("dry run: no files written")
    return 0


def cmd_compact_db(args) -> int:
    """Reference: commands/compact.go — compact the embedded database."""
    from cometbft_tpu_torch.store.kv import SqliteKV

    cfg = _load_config(args.home)
    path = os.path.join(cfg.base.home, cfg.base.db_dir, "chain.db")
    if not os.path.exists(path):
        print(f"no database at {path}")
        return 1
    before = os.path.getsize(path)
    kv = SqliteKV(path, surface="state")
    kv.compact()
    kv.close()
    after = os.path.getsize(path)
    print(f"compacted {path}: {before} -> {after} bytes")
    return 0


def _debug_collect(cfg, home: str, out_dir: str) -> list[str]:
    """Collect debug artifacts from a running node into ``out_dir``.

    Reference: cmd/cometbft/commands/debug/{kill,dump,util}.go — status,
    net_info, dump_consensus_state, the config file, plus the pprof
    goroutine/heap dumps when the profiling server is enabled.
    """
    import shutil
    import urllib.request

    collected = []

    def fetch(base: str, route: str, fname: str):
        try:
            with urllib.request.urlopen(f"{base}/{route}", timeout=5) as resp:
                data = resp.read()
            with open(os.path.join(out_dir, fname), "wb") as f:
                f.write(data)
            collected.append(fname)
        except Exception as e:  # noqa: BLE001
            print(f"warning: could not fetch {route}: {e}")

    rpc = cfg.rpc.laddr.replace("tcp://", "http://")
    fetch(rpc, "status", "status.json")
    fetch(rpc, "net_info", "net_info.json")
    fetch(rpc, "dump_consensus_state", "consensus_state.json")

    cfg_path = os.path.join(home, "config", "config.toml")
    if os.path.exists(cfg_path):
        shutil.copy(cfg_path, os.path.join(out_dir, "config.toml"))
        collected.append("config.toml")

    # pprof artifacts when the profiling server is up
    if cfg.rpc.pprof_laddr:
        pprof = cfg.rpc.pprof_laddr.replace("tcp://", "http://")
        fetch(pprof, "debug/pprof/goroutine", "goroutine.txt")
        fetch(pprof, "debug/pprof/heap", "heap.txt")
    return collected


def cmd_debug_kill(args) -> int:
    """Reference: commands/debug/kill.go — collect debug artifacts into a
    zip, then SIGKILL the node process."""
    import signal
    import tempfile
    import zipfile

    cfg = _load_config(args.home)
    with tempfile.TemporaryDirectory() as tmp:
        files = _debug_collect(cfg, args.home, tmp)
        with zipfile.ZipFile(args.output, "w", zipfile.ZIP_DEFLATED) as z:
            for fname in files:
                z.write(os.path.join(tmp, fname), fname)
    print(f"wrote {len(files)} artifacts to {args.output}")
    try:
        os.kill(args.pid, signal.SIGKILL)
        print(f"killed process {args.pid}")
    except ProcessLookupError:
        print(f"no such process: {args.pid}")
        return 1
    return 0


def cmd_debug_dump(args) -> int:
    """Reference: commands/debug/dump.go — periodically collect debug
    artifacts into timestamped zips under the output directory."""
    import time as _time
    import zipfile

    cfg = _load_config(args.home)
    os.makedirs(args.output_dir, exist_ok=True)
    iterations = args.iterations
    while True:
        # millisecond resolution: sub-second --frequency must not
        # overwrite the previous iteration's archive
        stamp = "%s%03d" % (
            _time.strftime("%Y%m%d%H%M%S"),
            int(_time.time() * 1000) % 1000,
        )
        tmp = os.path.join(args.output_dir, f".collect-{stamp}")
        os.makedirs(tmp, exist_ok=True)
        files = _debug_collect(cfg, args.home, tmp)
        out = os.path.join(args.output_dir, f"{stamp}.zip")
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            for fname in files:
                z.write(os.path.join(tmp, fname), fname)
        for fname in files:
            os.unlink(os.path.join(tmp, fname))
        os.rmdir(tmp)
        print(f"wrote {out} ({len(files)} artifacts)")
        if iterations is not None:
            iterations -= 1
            if iterations <= 0:
                return 0
        _time.sleep(args.frequency)


def cmd_reindex_event(args) -> int:
    """Reference: commands/reindex_event.go — replay stored blocks and
    finalize-block responses through the configured indexer sinks.

    The node must NOT be running (the stores are opened directly)."""
    from cometbft_tpu_torch.state.execution import fbr_from_json
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV

    cfg = _load_config(args.home)
    db_path = os.path.join(cfg.base.home, cfg.base.db_dir, "chain.db")
    if not os.path.exists(db_path):
        print(f"no database at {db_path}")
        return 1
    db = SqliteKV(db_path, surface="state")
    index_db = sink = None
    try:
        block_store = BlockStore(db)
        state_store = StateStore(db)

        base, height = block_store.base(), block_store.height()
        if height == 0:
            print("no blocks stored; nothing to reindex")
            return 1
        start = args.start_height or max(base, 1)
        end = args.end_height or height
        if start < base or end > height or start > end:
            print(
                f"height range [{start}, {end}] outside stored "
                f"[{base}, {height}]"
            )
            return 1

        if cfg.tx_index.indexer == "kv":
            from cometbft_tpu_torch.indexer import KVBlockIndexer, KVTxIndexer

            # the live node reads tx_index.db (degradable surface) —
            # rebuilt rows written into chain.db would stay invisible
            # until a later boot's legacy drain
            index_db = SqliteKV(
                os.path.join(cfg.base.home, cfg.base.db_dir, "tx_index.db"),
                surface="indexer",
            )
            tx_indexer = KVTxIndexer(index_db)
            block_indexer = KVBlockIndexer(index_db)
        elif cfg.tx_index.indexer == "psql":
            from cometbft_tpu_torch.indexer.psql import (
                PsqlBlockIndexerAdapter,
                PsqlEventSink,
                PsqlTxIndexerAdapter,
            )
            from cometbft_tpu_torch.types.genesis import GenesisDoc

            gpath = os.path.join(cfg.base.home, cfg.base.genesis_file)
            with open(gpath) as f:
                chain_id = GenesisDoc.from_json(f.read()).chain_id
            sink = PsqlEventSink(cfg.tx_index.psql_conn, chain_id)
            tx_indexer = PsqlTxIndexerAdapter(sink)
            block_indexer = PsqlBlockIndexerAdapter(sink)
        else:
            print("reindex requires a non-null indexer")
            return 1

        n_blocks = n_txs = 0
        for h in range(start, end + 1):
            block = block_store.load_block(h)
            raw = state_store.load_finalize_block_response(h)
            if block is None or raw is None:
                print(f"warning: missing block or results at height {h}")
                continue
            res = fbr_from_json(raw)
            block_indexer.index(h, res.events)
            for i, tx in enumerate(block.data.txs):
                if i < len(res.tx_results):
                    tx_indexer.index(h, i, tx, res.tx_results[i])
                    n_txs += 1
            n_blocks += 1
        print(f"reindexed {n_blocks} blocks, {n_txs} txs in [{start}, {end}]")
        return 0
    finally:
        if sink is not None:
            sink.stop()
        if index_db is not None:
            index_db.close()
        db.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cometbft_tpu_torch",
        description="BFT consensus node, PyTorch and CUDA port",
    )
    p.add_argument(
        "--home",
        default=os.environ.get("CMTHOME", os.path.expanduser("~/.cometbft_tpu")),
        help="node home directory",
    )
    sub = p.add_subparsers(dest="command")

    sp = sub.add_parser("init", help="initialize a node home directory")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--proxy_app", default="")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("show-node-id", help="show the p2p node ID")
    sp.set_defaults(fn=cmd_show_node_id)

    sp = sub.add_parser("show-validator", help="show validator pubkey")
    sp.set_defaults(fn=cmd_show_validator)

    sp = sub.add_parser("gen-validator", help="generate a validator keypair")
    sp.set_defaults(fn=cmd_gen_validator)

    sp = sub.add_parser("unsafe-reset-all", help="wipe blockchain data")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("testnet", help="generate testnet home dirs")
    sp.add_argument("--v", type=int, default=4, help="number of validators")
    sp.add_argument("--o", default="./mytestnet", help="output directory")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("rollback", help="roll back one block")
    sp.add_argument("--hard", action="store_true", help="also remove the block")
    sp.set_defaults(fn=cmd_rollback)

    sp = sub.add_parser("inspect", help="read-only RPC over the data dir")
    sp.add_argument("--rpc-laddr", default="", help="override rpc listen addr")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("light", help="run a light-client RPC proxy")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="primary node RPC URL")
    sp.add_argument("--witnesses", default="", help="comma-separated witness RPC URLs")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--trust-height", type=int, default=0)
    sp.add_argument("--trust-hash", default="")
    sp.add_argument("--trust-period", type=int, default=168 * 3600)
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser("confix", help="migrate config.toml to this version")
    sp.add_argument("--dry-run", action="store_true")
    sp.set_defaults(fn=cmd_confix)

    sp = sub.add_parser("compact-db", help="compact the embedded database")
    sp.set_defaults(fn=cmd_compact_db)

    # debug kill/dump (reference: commands/debug/debug.go)
    sp = sub.add_parser("debug", help="debug utilities for a running node")
    dsub = sp.add_subparsers(dest="debug_command", required=True)
    dk = dsub.add_parser(
        "kill", help="collect debug artifacts into a zip, then kill the node"
    )
    dk.add_argument("pid", type=int, help="node process id")
    dk.add_argument("output", help="output zip path")
    dk.set_defaults(fn=cmd_debug_kill)
    dd = dsub.add_parser(
        "dump", help="periodically collect debug artifacts into a directory"
    )
    dd.add_argument("output_dir", help="directory for timestamped zips")
    dd.add_argument(
        "--frequency", type=float, default=30.0, help="seconds between dumps"
    )
    dd.add_argument(
        "--iterations",
        type=int,
        default=None,
        help="stop after N dumps (default: run until interrupted)",
    )
    dd.set_defaults(fn=cmd_debug_dump)

    sp = sub.add_parser(
        "reindex-event",
        help="re-run the indexers over stored blocks (node must be stopped)",
    )
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)

    sp = sub.add_parser(
        "sim",
        help="run a deterministic fault-injection scenario on virtual time",
    )
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument(
        "--scenario", default="baseline", help="scenario name (--list)"
    )
    sp.add_argument("--validators", type=int, default=0)
    sp.add_argument("--height", type=int, default=0, help="target height")
    sp.add_argument("--max-time", type=float, default=0.0, help="virtual-second budget")
    sp.add_argument("--trace-out", default="", help="write the event trace here")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--list", action="store_true", help="list scenarios")
    sp.set_defaults(fn=cmd_sim)

    sp = sub.add_parser(
        "trace",
        help="snapshot the verify-pipeline flight recorder + health "
        "(docs/observability.md)",
    )
    sp.add_argument(
        "--rpc", default="tcp://127.0.0.1:26657",
        help="node RPC address to query (default tcp://127.0.0.1:26657)",
    )
    sp.add_argument(
        "--local", action="store_true",
        help="render this process's own recorder instead of querying RPC",
    )
    sp.add_argument(
        "--spans", type=int, default=256,
        help="ring-tail spans to include (default 256)",
    )
    sp.add_argument(
        "--rounds", type=int, default=8,
        help="last-K merged consensus-round timelines to include "
             "(default 8; 0 skips the section)",
    )
    sp.add_argument("--json", action="store_true", help="raw JSON document")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "postmortem",
        help="reconstruct a dead node's final timeline from its black-box "
        "journal (docs/observability.md)",
    )
    sp.add_argument(
        "dir",
        help="journal directory (or a node home / data dir containing one)",
    )
    sp.add_argument(
        "--recent", type=int, default=16,
        help="recent anomalies/events to include (default 16)",
    )
    sp.add_argument(
        "--json", action="store_true",
        help="full report as sort_keys-stable JSON",
    )
    sp.set_defaults(fn=cmd_postmortem)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    # SIGUSR1 dumps every thread's stack to stderr (the Go runtime's
    # SIGQUIT goroutine-dump analog) — first tool when a node wedges
    if hasattr(signal, "SIGUSR1"):
        import faulthandler

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
