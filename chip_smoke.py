#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``cometbft_tpu_torch``).

Drives the port's main path once on one NVIDIA card, at the size its users
run: a 10,240-validator commit (equal power, distinct keys, per-validator
timestamps, canonical sign bytes) verified through ``verify_commit`` and
``verify_commit_light`` with the default backend, which sends every
signature through the hand-written Hopper kernel
(``cometbft_tpu_torch/csrc/ed25519_verify.cu``).

Phases, in order; any failure raises and the script exits non-zero.  The
main-path phases (5-8) must be served by the cuda tier alone: a batch
served by the torch or host tier, or one that raised, fails the run.
  1. device — the card's name and power limit;
  2. build  — g++ builds the host library (``csrc/host_prep.cpp``) and
              nvcc every kernel, all from the repository's sources;
  3. host   — the host library on the commit: C++ ``prepare_batch`` ==
              the Python ``_pack_plain`` on the mixed lanes, C++ sign bytes
              == the per-index Python encoder for every signature and for
              the light subset, ``sha512`` == ``hashlib`` at 0-300 bytes;
  4. kernel — the kernel against its plain PyTorch version on the card
              (10,240 mixed lanes, bit for bit) and both against the
              pure-Python oracle on a 256-lane sample; the small batches
              of SMALL_N (partial quads, warps and blocks) against both;
  5. slice  — the commit through the entry points (``verify_commit`` ->
              the batch verifier -> ``verifysched.verify_segment_sync``
              (one direct supervised launch for a commit's segment; a
              scheduler flush for a few triples) -> the supervisor -> the
              kernel), behind the signature cache: cold commits (cache
              cleared before each), one warm commit that launches nothing, the bad commit's negative
              verdicts cached without poisoning the good commit; launch
              counts read around it, bad signatures at 0, 5000 and 10239
              rejected exactly, no ``jax`` in ``sys.modules``;
  6. times  — kernel, plain version, host prep and sign bytes in C++ and
              in Python, cold and warm commit wall, the cold wall with and
              without the verify scheduler and the supervisor (their kill
              switches, alternating samples), the remainder of the wall
              that no part names, the top host functions of one cold
              commit under cProfile (raw, and with the layers: every
              thread), the kernel's occupancy and bound;
  7. inflight — a path of its own: a light-client window of four commits
              through ``prepare_commit_light`` -> ``dispatch_segments``
              (two in flight on the verify stream) -> ``fetch_segments``
              -> ``finish_commit_light``, and ``verify_batches_overlapped``
              against a sequential ``verify_batch`` loop;
  8. gossip — the node's consensus path: the commit's 10,240 precommits
              and the bad commit's 3 tampered ones, as ``Vote`` objects,
              verified one at a time by 64 peer threads through
              ``Vote.verify`` -> the verify scheduler -> the supervisor ->
              the kernel; verdicts, lanes per launch, latency, and the
              commit after its gossip at 0 launches;
  9. supervisor — the per-tier counters of phases 5-8 (cuda only); the
              supervisor on the card under ``FaultyBackend`` on the cuda
              tier (raise, hang, wrong_shape, flap) through the batch
              verifier: every batch either served by cuda with the
              oracle's verdicts or raising ``BackendError`` — no tier
              below the kernel answers, nothing of a failed batch is
              cached — with the outcome and the breaker of each batch
              printed; bisect quarantine of one poisoned input
              (``PoisonedInputError`` naming it, the cuda breaker closed);
              a clean commit served by cuda again;
 10. profile — the measurement kernels (``ops/profile.py``), counted as a
              path of their own: the verify kernel built to stop after
              decompression, the table and the Straus walk, timed at the
              commit's width (the decompress stage's ok bits held against
              the plain ``_decompress_pair``), and chains of K field
              multiplies, squares and adds (``csrc/fe_chain.cu``) on one
              full wave of the card, held against the plain PyTorch field
              code and Python integers, giving the measured rate of field
              products per SM per clock.

Usage, from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Set-up signs 10,240 votes with the pure-Python oracle (~1.6 ms each on one
host core, ~17 s in all): the cost of making the data, not of verifying it.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import cProfile
import contextlib
import hashlib
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

N_VALIDATORS = 10_240
SEED = 20261016
CHAIN_ID = "chip-smoke-chain"
HEIGHT = 100
KERNEL_RUNS = 30
BACK_TO_BACK = 5  # calls per sample of the extra back-to-back reading
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # Hopper: 4 partitions x 16 INT32 lanes
# main-path launches, each verify behind a cleared signature cache unless
# said otherwise: self-check 1 + first verify_commit 1 + 5 cold samples +
# warm sample 0 + 5 cold light samples + bad commit 1 + the good commit
# after it 1 (its 3 triples that the bad commit changed, one scheduler
# flush) + batch-verifier bits 1.  A segment of a commit fills the
# scheduler's flush target, so it is one direct supervised launch.
MAIN_PATH_LAUNCHES = 15
COMMIT_RUNS = 5  # cold verify_commit / verify_commit_light samples
HOST_RUNS = 5  # samples of each host step (C++); Python's take 3
WINDOW = 4  # commits in the light-client window of the inflight phase
INFLIGHT = 2  # handles in flight
OVERLAP_PAIRS = 3  # overlapped / sequential samples, alternating
# batch sizes that leave quads, warps or blocks partly filled
SMALL_N = (1, 2, 3, 5, 8, 9, 33, 127, 129)
STAGE_RUNS = 10
CHAIN_K = 400  # chain length, as the Pallas chain script
CHAIN_RUNS = 10
# the kill switches of the two layers above the kernel, for the A/B of the
# times phase
LAYER_SWITCHES = ("COMETBFT_TPU_VERIFY_SCHED", "COMETBFT_TPU_SUPERVISOR")
AB_PAIRS = 5  # cold verify_commit samples with and without the layers
PEERS = 64  # gossiping peer threads of the gossip phase
FAULT_LANES = 256  # the fault matrix's batch, cut from the commit
FAULT_BAD = (0, 128, 255)  # its tampered lanes
FAULT_BATCHES = 3  # batches per fault mode
HANG_DEADLINE_MS = 500
HANG_S = 2.0
POISON = 17  # the input of the fault batch that kills the kernel


class SmokeError(AssertionError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise SmokeError(msg)


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int) -> float:
    """Median host wall time of ``fn`` over ``runs`` calls, in ms."""
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def cuda_ms(torch, fn, runs: int, warmup: int, per: int = 1) -> float:
    """Median device time of one ``fn`` over ``runs`` samples, CUDA events.
    A sample times ``per`` calls back to back and divides.  With ``per`` = 1,
    the method of every ``ms`` this script reports, a sample also counts the
    card's wait for the host to launch the call (Python, ctypes); with
    ``per`` > 1 that wait hides behind the previous call's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / per)
    return statistics.median(ts)


def bound(products: int, nbytes: int, sms: int, max_clock_mhz: float):
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``products`` 32x32->64-bit products on the data sheet's INT32 lanes at
    the max SM clock, or for ``nbytes`` moved once at the data sheet's HBM
    rate, whichever is longer."""
    ops_ms = products / (sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6) * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def profile_phase(torch, dev, t, tg, n, sms, max_clock_mhz, tag) -> dict:
    """Phase 10.  ``t``: the mixed lanes, ``tg``: the valid commit's lanes,
    both on ``dev``.  Returns the op-chain kernel's entry of the kernels
    line."""
    import numpy as np

    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import profile as pf

    pf.reset_launches()
    cv.reset_launches()
    # stage builds at the commit's width, then the full kernel, in turn
    plain_oks = pf.decompress_oks(t["a_bytes"], t["r_bytes"])
    for k in pf.STAGES:
        got = pf.verify_stage(k, **t)
        check(torch.equal(got, plain_oks),
              f"stage {k}: ok bits != plain _decompress_pair on "
              f"{int((got != plain_oks).sum())} of {n} lanes")
    stage_ms = {}
    for k, stage in pf.STAGES.items():
        stage_ms[stage] = cuda_ms(torch, lambda: pf.verify_stage(k, **tg),
                                  STAGE_RUNS, 2)
    stage_ms["full"] = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg),
                               STAGE_RUNS, 2)
    plain_ms = cuda_ms(
        torch, lambda: pf.decompress_oks(tg["a_bytes"], tg["r_bytes"]), 1, 0)
    prev, parts = 0.0, []
    for stage, ms in stage_ms.items():
        parts.append(f"{stage} {ms} ms (+{ms - prev})")
        prev = ms
    print(f"profile: verify kernel stopped after each stage, {n} valid lanes, "
          f"median of {STAGE_RUNS} samples of one call: "
          f"{'; '.join(parts)}; stage ok bits == plain "
          f"_decompress_pair on {n} mixed lanes, which takes {plain_ms} ms {tag}")

    # op chains on one full wave of the card
    occ = pf.chain_occupancy("mul")
    lanes = sms * occ["blocks_per_sm"] * occ["threads"]
    rng = np.random.default_rng(SEED + 2)
    worst, mul, rate = 0, {}, {}
    for i, op in enumerate(pf.CHAIN_OPS):
        x = pf.chain_input(lanes, SEED + 10 + i).to(dev)
        got = pf.fe_chain(x, op, CHAIN_K)
        plain = pf.fe_chain_plain(x, op, CHAIN_K)
        err = int((got.long() - plain.long()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"fe_chain {op}: kernel != plain (max_abs_err {err})")
        xs, gs = x.cpu().numpy(), got.cpu().numpy()
        for j in sorted(rng.choice(lanes, min(64, lanes), replace=False).tolist()):
            want = pf.chain_reference(pf.int_of_limbs10(xs[j]), op, CHAIN_K)
            check(pf.int_of_limbs10(gs[j]) == want, f"fe_chain {op}: lane {j}")
        ms = cuda_ms(torch, lambda: pf.fe_chain(x, op, CHAIN_K), CHAIN_RUNS, 2)
        plain_ms = cuda_ms(torch, lambda: pf.fe_chain_plain(x, op, CHAIN_K), 1, 0)
        ops = lanes * CHAIN_K
        per_sm_clk = ops / (ms * 1e-3 * sms * max_clock_mhz * 1e6)
        rate[op] = per_sm_clk
        prods = pf.PRODUCTS_PER_OP[op] * per_sm_clk
        print(f"profile: fe_chain {op}: {lanes} lanes x {CHAIN_K} ops in {ms} ms "
              f"({ms * 1e6 / ops:.5f} ns per op per lane; {per_sm_clk:.4f} ops "
              f"= {prods:.2f} 32x32->64-bit products per SM per clock at "
              f"{max_clock_mhz:.0f} MHz, data sheet {INT32_LANES_PER_SM} INT32 "
              f"lanes); plain PyTorch version {plain_ms} ms; == plain "
              f"(max_abs_err {err}) and == Python integers on {min(64, lanes)} lanes; "
              f"{occ['regs']} registers, {occ['local_bytes']} bytes local, "
              f"{occ['blocks_per_sm']} blocks of {occ['threads']} per SM {tag}")
        if op == "mul":
            mul = {"ms": ms, "plain_ms": plain_ms,
                   "bound": bound(ops * pf.PRODUCTS_PER_OP[op], lanes * 80, sms,
                                  max_clock_mhz)}
    # each stage against the data sheet and against the measured chain rates
    work = {**pf.STAGE_WORK, 4: (cv.FIELD_MULS_PER_SIG, cv.FIELD_SQUARES_PER_SIG)}
    for k, (muls, squares) in work.items():
        stage = pf.STAGES.get(k, "full")
        clocks = n * (muls / rate["mul"] + squares / rate["square"]) / sms
        chain_ms = clocks / (max_clock_mhz * 1e6) * 1e3
        bound_ms, _ = bound(n * cv.wide_products(muls, squares),
                            n * cv.BYTES_PER_SIG, sms, max_clock_mhz)
        print(f"profile: {stage} ({muls} multiplies, {squares} squares per "
              f"signature): bound {bound_ms} ms (data sheet); {chain_ms} ms at "
              f"the chain rates; measured {stage_ms[stage]} ms, "
              f"{chain_ms / stage_ms[stage]:.1%} of the chain rates {tag}")
    counts = dict(pf.launches, **{cv.NAME: cv.launches})
    for name, c in counts.items():
        check(c > 0, f"profile: {name} was not launched")
    print(f"profile: launches in this phase {counts}; the fe_chain entry of "
          f"the kernels line is the multiply chain (ms, plain_ms, bound_ms), "
          f"its max_abs_err the largest of the three chains")
    return {
        "name": pf.CHAIN, "route": "cuda", "source": pf.CHAIN_SOURCE,
        "replaces": pf.CHAIN_REPLACES, "launches": pf.launches[pf.CHAIN],
        "max_abs_err": worst, "ms": mul["ms"], "plain_ms": mul["plain_ms"],
        "bound_ms": mul["bound"][0],
        "bound_by": mul["bound"][1],
        "library_ms": None,
    }


def make_commit(n: int):
    """Seeded validator set of ``n`` equal-power keys and a commit signed by
    all of them.  Returns (vals, commit, block_id, sign_bytes)."""
    import numpy as np

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types.basic import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        PartSetHeader,
        Timestamp,
    )
    from cometbft_tpu_torch.types.block import Commit
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.types.vote import CommitSig

    rng = np.random.default_rng(SEED)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]
    by_addr = {}
    vals = []
    for p in privs:
        pub = p.pub_key()
        by_addr[pub.address()] = p
        vals.append(Validator(pub, 1))
    vals = ValidatorSet(vals)
    block_id = BlockID(
        hashlib.sha256(rng.bytes(32)).digest(),
        PartSetHeader(4, hashlib.sha256(rng.bytes(32)).digest()),
    )
    base_ns = 1_760_000_000 * 10**9
    sigs = []
    for i, v in enumerate(vals.validators):
        ns = base_ns + 1_000_003 * i  # each validator signs at its own time
        ts = Timestamp(ns // 10**9, ns % 10**9)
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, b""))
    commit = Commit(HEIGHT, 0, block_id, sigs)
    sign_bytes = commit.all_vote_sign_bytes(CHAIN_ID)
    for v, cs, sb in zip(vals.validators, commit.signatures, sign_bytes):
        cs.signature = by_addr[v.address].sign(sb)
    return vals, commit, block_id, sign_bytes


def mixed_triples(ref, pubs, msgs, sigs):
    """The commit's triples damaged by lane (index mod 16): 0-9 valid,
    10 tampered R, 11 tampered message, 12 s >= L, 13 ZIP-215 edges,
    14 wrong lengths, 15 s = 0."""
    P, L = ref.P, ref.L
    enc = lambda v: v.to_bytes(32, "little")
    ident, negzero = enc(1), enc(1 | 1 << 255)
    edges = [
        (enc(P + 1), enc(P + 1) + bytes(32)),  # identity key as P+1: accept
        (enc(P - 1), ident + bytes(32)),  # order-2 A
        (negzero, negzero + bytes(32)),  # "-0" A and R
        (bytes(32), enc(P - 1) + bytes(32)),  # order-4 A, order-2 R
        (enc(2), ident + bytes(32)),  # non-square x^2: reject
        (enc((1 << 255) - 1), ident + bytes(32)),  # y >= p
    ]
    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    for i in range(len(pubs)):
        kind = i % 16
        if kind == 10:
            sigs[i] = bytes([sigs[i][0] ^ 0x20]) + sigs[i][1:]
        elif kind == 11:
            msgs[i] = msgs[i] + b"\x00"
        elif kind == 12:
            s = int.from_bytes(sigs[i][32:], "little")
            sigs[i] = sigs[i][:32] + enc(s + L)
        elif kind == 13:
            pubs[i], sigs[i] = edges[(i // 16) % len(edges)]
        elif kind == 14:
            if (i // 16) % 2:
                pubs[i] = pubs[i][:31]
            else:
                sigs[i] = sigs[i][:63]
        elif kind == 15:
            sigs[i] = sigs[i][:32] + bytes(32)
    return pubs, msgs, sigs


def host_phase(ov, native, commit, light_idx, mixed) -> None:
    """Phase 3: the host library against the Python references."""
    import numpy as np

    mp, mm, ms = mixed
    n = len(mp)
    got, _, structural = ov.prepare_batch(mp, mm, ms)
    plain, plain_struct = ov._pack_plain(mp, mm, ms, got["s_ok"].shape[0])
    check(np.array_equal(structural, plain_struct), "host: structural != plain")
    for k in plain:
        check(got[k].dtype == plain[k].dtype and
              got[k].tobytes() == plain[k].tobytes(),
              f"host: C++ prepare_batch {k} != _pack_plain")
    sb = commit.all_vote_sign_bytes(CHAIN_ID)
    for i in range(n):
        check(sb[i] == commit.vote_sign_bytes(CHAIN_ID, i),
              f"host: sign bytes of {i} != the Python encoder")
    light = commit.all_vote_sign_bytes(CHAIN_ID, light_idx)
    for i, b in zip(light_idx, light):
        check(b == commit.vote_sign_bytes(CHAIN_ID, i),
              f"host: light sign bytes of {i} != the Python encoder")
    data = np.random.default_rng(SEED + 3).bytes(300)
    for k in range(301):
        check(native.sha512(data[:k]) == hashlib.sha512(data[:k]).digest(),
              f"host: sha512 of {k} bytes != hashlib")
    print(f"host: C++ prepare_batch == _pack_plain on all five arrays of "
          f"{n} mixed lanes; C++ sign bytes == the per-index Python encoder "
          f"for all {n} signatures and the light subset ({len(light_idx)}); "
          f"sha512 == hashlib at 0-300 bytes")


def top_host_functions(fn, k: int = 5) -> tuple[str, str]:
    """Run ``fn`` once under cProfile; the ``k`` functions with the most
    cumulative time and the ``k`` with the most own time, one string
    each (ms).  From Python 3.12 cProfile records every thread (it runs
    on ``sys.monitoring``), so the supervisor's watchdog workers and the
    scheduler's threads are in it too."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats  # {(file, line, name): (cc, nc, tt, ct, _)}
    rows = [(f"{name} ({file.rsplit('/', 1)[-1]}:{line})", tt, ct)
            for (file, line, name), (_, _, tt, ct, _) in stats.items()
            if name != "disable"]
    fmt = lambda rows, i: "; ".join(f"{r[0]} {r[i] * 1e3:.2f}" for r in rows)
    by_cum = sorted(rows, key=lambda r: -r[2])[:k]
    by_own = sorted(rows, key=lambda r: -r[1])[:k]
    return fmt(by_cum, 2), fmt(by_own, 1)


def inflight_phase(torch, ov, cv, val, vals, block_id, window, triples, tag):
    """Phase 7: a light-client window through the in-flight seam, and the
    overlapped path against a sequential loop.  Returns the launches of
    the window's run."""
    import numpy as np

    cv.reset_launches()
    prepared = [val.prepare_commit_light(CHAIN_ID, vals, block_id, HEIGHT, c)
                for c in window]
    verdicts, bits, pending = [], [], []

    def finish_oldest() -> None:
        p, h = pending.pop(0)
        b = ov.fetch_segments(h)[0]
        bits.append(b)
        try:
            val.finish_commit_light(p, b)
            verdicts.append(None)
        except val.InvalidSignatureError as e:
            verdicts.append(e.index)

    for p in prepared:
        while len(pending) >= INFLIGHT:
            finish_oldest()
        pending.append((p, ov.dispatch_segments([(p.pubs, p.msgs, p.sigs)])))
    while pending:
        finish_oldest()
    launches = cv.launches
    check(launches == len(window), f"inflight: {launches} launches for "
          f"{len(window)} commits")
    want = [None if i % 2 == 0 else 0 for i in range(len(window))]
    check(verdicts == want, f"inflight: verdicts {verdicts}, want {want}")
    for p, b in zip(prepared, bits):
        check(np.array_equal(b, ov.verify_batch(p.pubs, p.msgs, p.sigs)),
              "inflight: window bits != per-commit verify_batch")
    print(f"inflight: light-client window of {len(window)} commits "
          f"(good, bad, good, bad; {len(prepared[0].pubs)} signatures each) "
          f"through prepare_commit_light -> dispatch_segments ({INFLIGHT} "
          f"in flight) -> fetch_segments -> finish_commit_light: verdicts "
          f"{verdicts} (None = passed, 0 = InvalidSignatureError(0)); "
          f"{launches} kernel launches; bits == per-commit verify_batch")

    work = [triples] * WINDOW
    over, seq = [], []
    cv.reset_launches()
    for i in range(OVERLAP_PAIRS):
        for kind in (("over", "seq") if i % 2 == 0 else ("seq", "over")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "over":
                got = ov.verify_batches_overlapped(work, inflight=INFLIGHT)
                over.append((time.perf_counter() - t0) * 1e3 / len(work))
            else:
                got = [ov.verify_batch(*w) for w in work]
                seq.append((time.perf_counter() - t0) * 1e3 / len(work))
            check(all(g.all() and len(g) == len(triples[0]) for g in got),
                  f"inflight: {kind} rejected a valid lane")
    check(cv.launches == 2 * OVERLAP_PAIRS * len(work),
          f"inflight: {cv.launches} launches in the overlapped runs")
    print(f"inflight: verify_batches_overlapped over {len(work)} copies of the "
          f"commit's {len(triples[0])} triples (the same triples each time: "
          f"the overlapped path does not consult the signature cache, so "
          f"every batch is packed and launched in full): "
          f"{statistics.median(over)} ms per batch overlapped ({INFLIGHT} in "
          f"flight) against {statistics.median(seq)} ms per batch for a "
          f"sequential verify_batch loop (medians of {OVERLAP_PAIRS} "
          f"alternating samples; all {over} / {seq}) {tag}")
    return launches


@contextlib.contextmanager
def environ(values: dict):
    """Environment variables set for a block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_tiers(ds, where: str) -> dict:
    """Every batch of the main path so far served by the cuda tier: the
    torch and host tiers at 0 batches and 0 signatures."""
    counts = ds.tier_counts()
    check(counts["torch"] == (0, 0) and counts["host"] == (0, 0),
          f"{where}: batches served below the cuda tier: {counts}")
    check(counts["cuda"][0] > 0, f"{where}: no batch served by the cuda tier")
    return counts


def gossip_phase(cv, ds, val, vals, commit, bad_commit, block_id, sign_bytes,
                 bad, ref, tag) -> None:
    """Phase 8: the node's consensus path.  The commit's precommits and the
    bad commit's three tampered ones arrive as gossip; PEERS threads call
    ``Vote.verify`` one vote at a time, through the verify scheduler.
    Then the commit built from them verifies with 0 launches."""
    import threading

    import numpy as np

    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.verifysched import stats as sstats

    n = len(commit.signatures)

    def vote(i, cs):
        return Vote(PRECOMMIT_TYPE, commit.height, commit.round_, block_id,
                    cs.timestamp, cs.validator_address, i, cs.signature)

    votes = [vote(i, cs) for i, cs in enumerate(commit.signatures)]
    votes += [vote(i, bad_commit.signatures[i]) for i in bad]
    want = [True] * n + [False] * len(bad)
    rng = np.random.default_rng(SEED + 4)
    sample = sorted(rng.choice(n, min(256, n), replace=False).tolist()) + list(
        range(n, len(votes)))
    for i in sample:
        v = votes[i]
        sb = v.sign_bytes(CHAIN_ID)
        check(sb == sign_bytes[v.validator_index],
              f"gossip: vote {i} sign bytes != the commit's")
        pub = vals.validators[v.validator_index].pub_key.bytes()
        check(ref.verify_zip215(pub, sb, v.signature) == want[i],
              f"gossip: vote {i}: oracle disagrees with the expected verdict")
    pks = [vals.validators[v.validator_index].pub_key for v in votes]

    sigcache.get_cache().clear()
    sstats.reset()
    before = ds.snapshot()
    got = [None] * len(votes)
    lat = [0.0] * len(votes)
    barrier = threading.Barrier(PEERS)

    def peer(t: int) -> None:
        barrier.wait()
        for i in range(t, len(votes), PEERS):
            t0 = time.perf_counter()
            got[i] = votes[i].verify(CHAIN_ID, pks[i])
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=peer, args=(t,)) for t in range(PEERS)]
    cv.reset_launches()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = cv.launches
    check(not any(th.is_alive() for th in threads), "gossip: a peer hung")
    after = ds.snapshot()
    snap = sstats.snapshot()
    check(got == want, "gossip: verdicts != the oracle's at "
          f"{[i for i, (g, w) in enumerate(zip(got, want)) if g != w][:10]}")
    check_tiers(ds, "gossip")
    flushes = sum(snap["flushes"].values())
    verified = snap["flush_misses"]
    sizes = {k: v - before["buckets"].get(k, 0) for k, v in after["buckets"].items()}
    max_flush = max(k for k, v in sizes.items() if v > 0)
    check(launches > 0 and verified == len(votes),
          f"gossip: {launches} launches for {verified} verified votes")
    mean = verified / launches
    check(mean >= 4, f"gossip: {mean:.2f} lanes per launch")
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    print(f"gossip: {len(votes)} votes ({n} precommits of the commit, "
          f"{len(bad)} tampered at {list(bad)}) verified by {PEERS} peer "
          f"threads through Vote.verify -> the verify scheduler: verdicts == "
          f"oracle (the {len(bad)} tampered rejected; oracle run on "
          f"{len(sample)} of them); {flushes} flushes "
          f"({snap['flushes']}), {launches} kernel launches, {mean:.2f} mean "
          f"and {max_flush} max lanes per flush; vote-verify latency p50 "
          f"{p50} ms, p99 {p99} ms; wall {wall_ms} ms; all on the cuda tier {tag}")
    cv.reset_launches()
    val.verify_commit(CHAIN_ID, vals, block_id, commit.height, commit)
    check(cv.launches == 0,
          f"gossip: the commit after its gossip made {cv.launches} launches")
    print("gossip: verify_commit of the commit built from the gossiped "
          "precommits: 0 launches (every triple a cache hit through "
          "byte-identical sign bytes)")


def supervisor_phase(cv, ov, ds, cbatch, val, vals, block_id, commit, pubs,
                     sign_bytes, sigs, ref, tag) -> None:
    """Phase 9: the supervisor on the card, under injected faults
    (``FaultyBackend`` on the cuda tier): a batch is served by the kernel
    or raises ``BackendError``, never answered below it and never cached;
    then bisect quarantine, then a clean commit served by the kernel."""
    import threading

    from cometbft_tpu_torch.crypto import backend_health as bh
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.ops import supervisor as sup

    counts = check_tiers(ds, "main path")
    print(f"supervisor: tiers after the main-path phases (batches, "
          f"signatures): {counts}; torch and host at 0")

    p, m, s = (list(x[:FAULT_LANES]) for x in (pubs, sign_bytes, sigs))
    keys = [v.pub_key for v in vals.validators[:FAULT_LANES]]
    for i in FAULT_BAD:
        s[i] = s[i][:-1] + bytes([s[i][-1] ^ 1])
    want = [ref.verify_zip215(*t) for t in zip(p, m, s)]
    check(sum(want) == FAULT_LANES - len(FAULT_BAD), "fault batch oracle")
    cache = sigcache.get_cache()
    threads = threading.active_count()
    # hang last: its abandoned workers (the injected sleep) finish in the
    # background
    for mode in ("raise", "wrong_shape", "flap", "hang"):
        bh.reset()
        before = ds.tier_counts()
        shim = sup.FaultyBackend(mode, backends=("cuda",), hang_s=HANG_S,
                                 fail_n=2, pass_n=1)
        sup.set_fault_injector(shim)
        outcomes = []
        try:
            deadline = ({"COMETBFT_TPU_DISPATCH_TIMEOUT_MS": str(HANG_DEADLINE_MS)}
                        if mode == "hang" else {})
            with environ(deadline):
                for _ in range(FAULT_BATCHES):
                    cache.clear()
                    bv = cbatch.create_batch_verifier(keys[0])
                    for t in zip(keys, m, s):
                        bv.add(*t)
                    t0 = time.perf_counter()
                    try:
                        _, bits = bv.verify()
                    except bh.BackendError as e:
                        ms_ = (time.perf_counter() - t0) * 1e3
                        check(all(cache.get(*t) is None for t in zip(p, m, s)),
                              f"supervisor {mode}: a failed batch was cached")
                        got = f"{type(e).__name__} in {ms_:.1f} ms"
                    else:
                        ms_ = (time.perf_counter() - t0) * 1e3
                        check(bits == want and sup.last_tier() == "cuda",
                              f"supervisor {mode}: bits != oracle or served "
                              f"by {sup.last_tier()}")
                        got = f"served by cuda, verdicts == oracle, in {ms_:.1f} ms"
                    outcomes.append(f"{got}, cuda breaker "
                                    f"{bh.registry().breaker('cuda').state}")
        finally:
            sup.clear_fault_injector()
        after = ds.tier_counts()
        check(after["torch"] == before["torch"] and after["host"] == before["host"],
              f"supervisor {mode}: a tier below the kernel served: {after}")
        raised = sum("Error" in o for o in outcomes)
        check(mode == "flap" or raised == FAULT_BATCHES,
              f"supervisor {mode}: {outcomes}")
        snap = bh.snapshot()
        print(f"supervisor: fault {mode} on the cuda tier ({FAULT_LANES} lanes "
              f"of the commit through the batch verifier, {len(FAULT_BAD)} bad; "
              + (f"deadline {HANG_DEADLINE_MS} ms, hang {HANG_S} s; "
                 if mode == "hang" else "")
              + f"{shim.faults} of {shim.calls} dispatches faulted): "
              f"{'; '.join(outcomes)}; demotions {snap['demotions']}, watchdog "
              f"fires {snap['watchdog_fires']}, host signatures "
              f"{snap['fallback_signatures']}; torch and host served nothing, "
              f"no failed batch cached {tag}")
    # abandoned watchdog workers (hang) finish before anything is timed
    deadline = time.perf_counter() + 120
    while threading.active_count() > threads and time.perf_counter() < deadline:
        time.sleep(0.1)

    bh.reset()
    poison = p[POISON]

    def poisoned(backend, bp, bm, bs):
        if backend == "cuda" and poison in bp:
            raise RuntimeError("injected: this input kills the kernel")

    sup.set_fault_injector(poisoned)
    cv.reset_launches()
    try:
        ov.verify_batch(p, m, s)
    except sup.PoisonedInputError as e:
        index = e.index
    else:
        raise SmokeError("supervisor bisect: a batch with a poisoned input "
                         "verified")
    finally:
        sup.clear_fault_injector()
    snap = bh.snapshot()
    check(index == POISON and snap["quarantined"] == 1 and
          snap["demotions"] == 0 and snap["fallback_signatures"] == 0 and
          bh.registry().breaker("cuda").state == bh.CLOSED,
          f"supervisor bisect: index {index}, {snap}")
    print(f"supervisor: bisect quarantine of input {POISON} of {FAULT_LANES}: "
          f"PoisonedInputError naming exactly it (no tier below the kernel "
          f"verifies it), cuda breaker closed, {cv.launches} kernel launches")

    bh.reset()
    cache.clear()
    before = ds.tier_counts()
    cv.reset_launches()
    val.verify_commit(CHAIN_ID, vals, block_id, commit.height, commit)
    after = ds.tier_counts()
    delta = {t: (after[t][0] - before[t][0], after[t][1] - before[t][1])
             for t in after}
    n = len(commit.signatures)
    check(cv.launches == 1 and delta["cuda"] == (1, n) and
          delta["torch"] == (0, 0) and delta["host"] == (0, 0),
          f"supervisor: the clean commit: {cv.launches} launches, {delta}")
    print(f"supervisor: injector cleared, registry reset: the next {n}-lane "
          f"commit served by cuda with 1 launch")


def main(n: int = N_VALIDATORS, device: str = "cuda") -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.ops import dispatch_stats as ds
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import validation as val

    def oracle(p, m, s):
        return len(p) == 32 and len(s) == 64 and ref.verify_zip215(p, m, s)

    bad = (0, n * 5000 // 10240, n - 1)  # (0, 5000, 10239) at full size

    # -- 1. device -----------------------------------------------------------
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {card} | {kind} x{count} | {sms} SMs, max SM clock "
          f"{max_clock_mhz:.0f} MHz | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    dev = torch.device(device)
    tag = f"[{card}]"

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, compiled "
          f"{sorted(built) or 'nothing (already built)'}")
    host_build_s = built.get(native.NAME)
    print(f"build: host library {native.SOURCE}: "
          + ("already built" if host_build_s is None
             else f"compiled by g++ in {host_build_s:.2f} s"))
    native.lib()  # loads it and binds its three functions
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"build: {name}: {line.strip()}")

    # -- set-up: keys, commit, signatures ------------------------------------
    t0 = time.perf_counter()
    vals, commit, block_id, sign_bytes = make_commit(n)
    pubs = [v.pub_key.bytes() for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    needed = vals.total_voting_power() * 2 // 3
    light_entries, _ = val._collect_entries(vals, commit, needed, False, False)
    light_idx = [i for i, _, _ in light_entries]
    check(len(light_entries) == needed + 1, f"light entries {len(light_entries)}")
    mp, mm, ms = mixed_triples(ref, pubs, sign_bytes, sigs)
    print(f"setup: {n} keys and signed votes in {time.perf_counter() - t0:.1f} s "
          f"(pure-Python signing; data set-up, not verification)")

    # -- 3. host library against the Python references -----------------------
    host_phase(ov, native, commit, light_idx, (mp, mm, ms))

    # -- 4. kernel against its plain version ---------------------------------
    arrays, got_n, structural = ov.prepare_batch(mp, mm, ms)
    check(got_n == n and arrays["s_ok"].shape == (n,), "prepare_batch padded")
    t = ov.batch_to_device(arrays, dev)
    kern = cv.verify_core_cuda(**t)
    torch.cuda.synchronize()
    plain = ov.verify_core(**t)
    torch.cuda.synchronize()
    max_abs_err = int((kern.int() - plain.int()).abs().max())
    check(torch.equal(kern, plain),
          f"kernel != plain on {int((kern != plain).sum())} of {n} lanes")
    bits = kern.cpu().numpy() & structural
    rng = np.random.default_rng(SEED + 1)
    sample = sorted(rng.choice(n, min(256, n), replace=False).tolist())
    for i in sample:
        want = oracle(mp[i], mm[i], ms[i])
        check(bool(bits[i]) == want, f"lane {i}: kernel {bits[i]}, oracle {want}")
    n_ok = int(bits.sum())
    check(0 < n_ok < n, f"{n_ok} of {n} mixed lanes accepted")
    for k in SMALL_N:
        sub = {key: v[:k].contiguous() for key, v in t.items()}
        kb = cv.verify_core_cuda(**sub)
        check(torch.equal(kb, ov.verify_core(**sub)), f"n={k}: kernel != plain")
        kb = kb.cpu().numpy() & structural[:k]
        for i in range(k):
            check(bool(kb[i]) == oracle(mp[i], mm[i], ms[i]), f"n={k}: lane {i}")
    print(f"kernel: {n} mixed lanes, kernel == plain version bit for bit "
          f"(max_abs_err {max_abs_err}), {n_ok} accepted; {len(sample)}-lane "
          f"sample == oracle; n = {', '.join(map(str, SMALL_N))} == plain "
          f"== oracle")

    # -- 5. the slice, through the entry points ------------------------------
    bad_commit = type(commit)(
        commit.height, commit.round_, commit.block_id,
        [type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp, cs.signature)
         for cs in commit.signatures],
    )
    for i in bad:
        s = bad_commit.signatures[i].signature
        bad_commit.signatures[i].signature = s[:-1] + bytes([s[-1] ^ 1])
    cache = sigcache.get_cache()
    check(cache.enabled() and cache.capacity >= n, "signature cache too small")
    full = lambda: val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    light = lambda: val.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT, commit)

    def cold_ms(fn) -> float:
        """One cold sample: the block-apply case, where no vote of the
        commit was verified before."""
        cache.clear()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    cv.reset_launches()
    ds.reset()
    first_ms = cold_ms(full)
    check(cbatch.default_backend() == "gpu", "default backend is not gpu")
    check(isinstance(cbatch.create_batch_verifier(vals.validators[0].pub_key),
                     cbatch.GpuBatchVerifier), "default verifier is not the GPU one")
    commit_samples = [cold_ms(full) for _ in range(COMMIT_RUNS)]
    before = cv.launches
    t0 = time.perf_counter()
    full()  # warm: every triple verified by the last sample
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(cv.launches == before, f"warm commit made {cv.launches - before} launches")
    light_samples = [cold_ms(light) for _ in range(COMMIT_RUNS)]
    cache.clear()
    try:
        val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, bad_commit)
    except val.InvalidSignatureError as e:
        check(e.index == bad[0], f"InvalidSignatureError({e.index})")
    else:
        raise SmokeError("a commit with bad signatures verified")
    for i in bad:
        got = cache.get(pubs[i], sign_bytes[i], bad_commit.signatures[i].signature)
        check(got is False, f"bad signature {i}: cached verdict {got}")
    misses, before = cache.stats()["misses"], cv.launches
    full()  # the good commit after the bad one: only its 3 changed triples miss
    check(cache.stats()["misses"] - misses == len(bad) and
          cv.launches - before == 1,
          "the bad commit's verdicts changed how the good commit verified")
    cache.clear()
    bv = cbatch.create_batch_verifier(vals.validators[0].pub_key)
    for v, sb, cs in zip(vals.validators, sign_bytes, bad_commit.signatures):
        bv.add(v.pub_key, sb, cs.signature)
    ok, bad_bits = bv.verify()
    false_at = [i for i, b in enumerate(bad_bits) if not b]
    check(not ok and false_at == list(bad), f"false bits at {false_at}")
    launches = cv.launches
    check(launches == MAIN_PATH_LAUNCHES, f"{launches} kernel launches")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    check(not leaked, f"imported {leaked}")
    tiers = check_tiers(ds, "slice")
    commit_ms = statistics.median(commit_samples)
    light_ms = statistics.median(light_samples)
    print(f"slice: verify_commit ({n} signatures) and verify_commit_light "
          f"({len(light_entries)} signatures) passed on backend gpu, cold "
          f"(signature cache cleared before each); a warm verify_commit made 0 "
          f"launches; bad indices {list(bad)} -> InvalidSignatureError({bad[0]}), "
          f"their negative verdicts cached, the good commit after it passed "
          f"with {len(bad)} misses and 1 launch; batch-verifier bits false "
          f"exactly at {list(bad)}; {launches} kernel launches; jax not imported; "
          f"served by tier (batches, signatures): {tiers}")

    # -- 6. times ------------------------------------------------------------
    good, _, _ = ov.prepare_batch(pubs, sign_bytes, sigs)
    tg = ov.batch_to_device(good, dev)
    check(bool(cv.verify_core_cuda(**tg).all()), "valid commit lanes rejected")
    kernel_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg), KERNEL_RUNS, 3)
    b2b_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg), KERNEL_RUNS, 3,
                     BACK_TO_BACK)
    plain_ms = cuda_ms(torch, lambda: ov.verify_core(**tg), 3, 1)
    prep_ms = median_ms(lambda: ov.prepare_batch(pubs, sign_bytes, sigs), HOST_RUNS)
    prep_py_ms = median_ms(lambda: ov._pack_plain(pubs, sign_bytes, sigs, n), 3)
    sb_ms = median_ms(lambda: commit.all_vote_sign_bytes(CHAIN_ID), HOST_RUNS)
    sb_py_ms = median_ms(
        lambda: [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(n)], 3)
    rest_ms = commit_ms - sb_ms - prep_ms - kernel_ms
    ab = {"layers": [], "raw": []}
    for i in range(AB_PAIRS):
        for side in (("layers", "raw") if i % 2 == 0 else ("raw", "layers")):
            with environ({k: "0" for k in LAYER_SWITCHES} if side == "raw" else {}):
                ab[side].append(cold_ms(full))
    ab_ms = {k: statistics.median(v) for k, v in ab.items()}
    cache.clear()
    with environ({k: "0" for k in LAYER_SWITCHES}):
        by_cum, by_own = top_host_functions(full)
    cache.clear()
    layers_cum, layers_own = top_host_functions(full)
    ops = n * cv.WIDE_PRODUCTS_PER_SIG
    bound_ms, bound_by = bound(ops, n * cv.BYTES_PER_SIG, sms, max_clock_mhz)
    print(f"time: kernel {kernel_ms} ms at {n} lanes (median of {KERNEL_RUNS} "
          f"samples of one call, CUDA events) = {n / kernel_ms * 1e3:.0f} "
          f"verifies/s {tag}")
    print(f"time: extra reading, not the kernels line's ms: kernel {b2b_ms} ms "
          f"per call at {n} lanes (median of {KERNEL_RUNS} samples of "
          f"{BACK_TO_BACK} back-to-back calls, CUDA events: the host's launch "
          f"time hidden behind the previous call) {tag}")
    print(f"time: plain PyTorch version {plain_ms} ms at {n} lanes {tag}")
    print(f"time: host prep (SHA-512 + packing, {n} signatures) C++ {prep_ms} "
          f"ms (median of {HOST_RUNS}), Python {prep_py_ms} ms (median of 3); "
          f"sign bytes C++ {sb_ms} ms (median of {HOST_RUNS}), Python "
          f"{sb_py_ms} ms (median of 3) {tag}")
    print(f"time: verify_commit cold wall {commit_ms} ms (median of "
          f"{COMMIT_RUNS}; all {commit_samples}) = {n / commit_ms * 1e3:.0f} "
          f"verifies/s end to end (first call, with the self-check, {first_ms} "
          f"ms); warm (every vote cached, 0 launches) {warm_ms} ms; "
          f"verify_commit_light cold wall {light_ms} ms (all {light_samples}) {tag}")
    print(f"time: remainder of the cold verify_commit wall that no part above "
          f"names: {rest_ms} ms = {commit_ms} - sign bytes {sb_ms} - host prep "
          f"{prep_ms} - kernel {kernel_ms} (entry collection, the signature "
          f"cache's keys and writeback, the verifier's lists, the "
          f"supervisor's watchdog thread, copies to the card) {tag}")
    print(f"time: cold verify_commit wall with the verify scheduler and the "
          f"supervisor {ab_ms['layers']} ms, without them "
          f"({'=0 '.join(LAYER_SWITCHES)}=0) {ab_ms['raw']} ms: the two layers "
          f"cost {ab_ms['layers'] - ab_ms['raw']} ms per commit (medians of "
          f"{AB_PAIRS} alternating pairs; all {ab}) {tag}")
    print(f"time: cProfile of one cold verify_commit on the raw path "
          f"({'=0 '.join(LAYER_SWITCHES)}=0), top 5 by cumulative ms: {by_cum}")
    print(f"time: cProfile of the same run, top 5 by own ms: {by_own}")
    print(f"time: cProfile of one cold verify_commit with the two layers "
          f"(Python {sys.version.split()[0]}, every thread), top 5 by "
          f"cumulative ms: {layers_cum}")
    print(f"time: cProfile of the same run, top 5 by own ms: {layers_own}")
    print(f"time: bound {bound_ms} ms by {bound_by}: {ops} 32x32->64-bit "
          f"products over {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
          f"{max_clock_mhz:.0f} MHz, or {n * cv.BYTES_PER_SIG} bytes at "
          f"{H100_HBM_BYTES_PER_S:.3g} B/s {tag}")
    print(f"time: kernel at {bound_ms / kernel_ms:.2%} of its bound {tag}")
    print("time: library_ms is null: no PyTorch library call computes Ed25519 "
          "signature verification")
    occ = cv.occupancy()
    grid = -(-n * cv.THREADS_PER_SIG // occ["threads"])
    resident = occ["blocks_per_sm"] * sms
    print(f"occupancy: {cv.NAME}: {cv.THREADS_PER_SIG} thread(s) per signature, "
          f"{occ['threads']} threads per block, {occ['regs']} registers and "
          f"{occ['local_bytes']} bytes of local memory per thread, "
          f"{occ['shared_bytes']} bytes of static shared memory per block; "
          f"{occ['blocks_per_sm']} blocks ({occ['blocks_per_sm'] * occ['threads'] // 32}"
          f" warps) resident per SM; {n} lanes -> {grid} blocks, "
          f"{min(grid, sms)} of {sms} SMs with work, up to "
          f"{-(-grid // sms) * occ['threads'] // 32} warps on one SM"
          f"{'' if grid <= resident else ' (more than one wave)'} {tag}")

    # -- 7. inflight: the light-client window and the overlapped path --------
    window = [commit if i % 2 == 0 else bad_commit for i in range(WINDOW)]
    inflight_phase(torch, ov, cv, val, vals, block_id, window,
                   (pubs, sign_bytes, sigs), tag)
    check_tiers(ds, "inflight")

    # -- 8. gossip: Vote.verify from 64 peers through the scheduler ----------
    gossip_phase(cv, ds, val, vals, commit, bad_commit, block_id, sign_bytes,
                 bad, ref, tag)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    check(not leaked, f"imported {leaked}")

    # -- 9. supervisor: tier counters, fault matrix, quarantine --------------
    supervisor_phase(cv, ov, ds, cbatch, val, vals, block_id, commit, pubs,
                     sign_bytes, sigs, ref, tag)
    verifysched.reset_scheduler()  # drains and joins its threads

    # -- 10. profile: stage builds and field-op chains -----------------------
    chain_entry = profile_phase(torch, dev, t, tg, n, sms, max_clock_mhz, tag)

    print("host: " + json.dumps({
        "name": native.NAME,
        "source": native.SOURCE,
        "replaces": "cometbft_tpu/native/csrc/cometbft_native.cpp:316 "
                    "(ed25519_pack), :360 (sha512), :438 (commit_sign_bytes)",
        "build_s": host_build_s,
        "prep_ms": prep_ms,
        "plain_prep_ms": prep_py_ms,
        "sign_bytes_ms": sb_ms,
        "plain_sign_bytes_ms": sb_py_ms,
    }))
    print(json.dumps({"kernels": [{
        "name": cv.NAME,
        "route": "cuda",
        "source": cv.SOURCE,
        "replaces": cv.REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, chain_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
