#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``cometbft_tpu_torch``).

Drives the port's main path once on one NVIDIA card, at the size its users
run: a 10,240-validator commit (equal power, distinct keys, per-validator
timestamps, canonical sign bytes) verified through ``verify_commit`` and
``verify_commit_light`` with the default backend, which sends every
signature through the hand-written Hopper kernel
(``cometbft_tpu_torch/csrc/ed25519_verify.cu``).

Phases, in order; any failure raises and the script exits non-zero:
  1. device — the card's name and power limit;
  2. build  — nvcc builds every kernel from the repository's sources;
  3. kernel — the kernel against its plain PyTorch version on the card
              (10,240 mixed lanes, bit for bit) and both against the
              pure-Python oracle on a 256-lane sample; the small batches
              of SMALL_N (partial quads, warps and blocks) against both;
  4. slice  — the commit through the entry points, launch counts read
              around it, bad signatures at 0, 5000 and 10239 rejected
              exactly, no ``jax`` in ``sys.modules``;
  5. times  — kernel, plain version, host prep, sign bytes, commit wall,
              the kernel's occupancy and its fraction of the bound;
  6. profile — the measurement kernels (``ops/profile.py``), counted as a
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

import hashlib
import json
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
# main-path launches: self-check 1 + verify_commit 1+5 + light 5 + bad
# commit 1 + batch-verifier bits 1
MAIN_PATH_LAUNCHES = 14
# batch sizes that leave quads, warps or blocks partly filled
SMALL_N = (1, 2, 3, 5, 8, 9, 33, 127, 129)
STAGE_RUNS = 10
CHAIN_K = 400  # chain length, as the Pallas chain script
CHAIN_RUNS = 10


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
    """Phase 6.  ``t``: the mixed lanes, ``tg``: the valid commit's lanes,
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


def main(n: int = N_VALIDATORS, device: str = "cuda") -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_verify as cv
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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, compiled "
          f"{sorted(built) or 'nothing (already built)'}")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"build: {name}: {line.strip()}")

    # -- set-up: keys, commit, signatures ------------------------------------
    t0 = time.perf_counter()
    vals, commit, block_id, sign_bytes = make_commit(n)
    pubs = [v.pub_key.bytes() for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    print(f"setup: {n} keys and signed votes in {time.perf_counter() - t0:.1f} s "
          f"(pure-Python signing; data set-up, not verification)")

    # -- 3. kernel against its plain version ---------------------------------
    mp, mm, ms = mixed_triples(ref, pubs, sign_bytes, sigs)
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

    # -- 4. the slice, through the entry points ------------------------------
    needed = vals.total_voting_power() * 2 // 3
    light_entries, _ = val._collect_entries(vals, commit, needed, False, False)
    check(len(light_entries) == needed + 1, f"light entries {len(light_entries)}")
    bad_commit = type(commit)(
        commit.height, commit.round_, commit.block_id,
        [type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp, cs.signature)
         for cs in commit.signatures],
    )
    for i in bad:
        s = bad_commit.signatures[i].signature
        bad_commit.signatures[i].signature = s[:-1] + bytes([s[-1] ^ 1])

    cv.reset_launches()
    t0 = time.perf_counter()
    val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    first_ms = (time.perf_counter() - t0) * 1e3
    check(cbatch.default_backend() == "gpu", "default backend is not gpu")
    check(isinstance(cbatch.create_batch_verifier(vals.validators[0].pub_key),
                     cbatch.GpuBatchVerifier), "default verifier is not the GPU one")
    commit_ms = median_ms(
        lambda: val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit), 5
    )
    light_ms = median_ms(
        lambda: val.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT, commit), 5
    )
    try:
        val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, bad_commit)
    except val.InvalidSignatureError as e:
        check(e.index == bad[0], f"InvalidSignatureError({e.index})")
    else:
        raise SmokeError("a commit with bad signatures verified")
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
    print(f"slice: verify_commit ({n} signatures) and verify_commit_light "
          f"({len(light_entries)} signatures) passed on backend gpu; bad "
          f"indices {list(bad)} -> InvalidSignatureError({bad[0]}) and exactly "
          f"those bits false; {launches} kernel launches; jax not imported")

    # -- 5. times ------------------------------------------------------------
    good, _, _ = ov.prepare_batch(pubs, sign_bytes, sigs)
    tg = ov.batch_to_device(good, dev)
    check(bool(cv.verify_core_cuda(**tg).all()), "valid commit lanes rejected")
    kernel_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg), KERNEL_RUNS, 3)
    b2b_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg), KERNEL_RUNS, 3,
                     BACK_TO_BACK)
    plain_ms = cuda_ms(torch, lambda: ov.verify_core(**tg), 3, 1)
    prep_ms = median_ms(lambda: ov.prepare_batch(pubs, sign_bytes, sigs), 3)
    sb_ms = median_ms(lambda: commit.all_vote_sign_bytes(CHAIN_ID), 3)
    ops = n * cv.WIDE_PRODUCTS_PER_SIG
    bound_ms, bound_by = bound(ops, n * cv.BYTES_PER_SIG, sms, max_clock_mhz)
    tag = f"[{card}]"
    print(f"time: kernel {kernel_ms} ms at {n} lanes (median of {KERNEL_RUNS} "
          f"samples of one call, CUDA events) = {n / kernel_ms * 1e3:.0f} "
          f"verifies/s {tag}")
    print(f"time: extra reading, not the kernels line's ms: kernel {b2b_ms} ms "
          f"per call at {n} lanes (median of {KERNEL_RUNS} samples of "
          f"{BACK_TO_BACK} back-to-back calls, CUDA events: the host's launch "
          f"time hidden behind the previous call) {tag}")
    print(f"time: plain PyTorch version {plain_ms} ms at {n} lanes {tag}")
    print(f"time: host prep (SHA-512 + packing) {prep_ms} ms; sign bytes "
          f"{sb_ms} ms {tag}")
    print(f"time: verify_commit wall {commit_ms} ms = {n / commit_ms * 1e3:.0f} "
          f"verifies/s end to end (first call, with the self-check, {first_ms} "
          f"ms); verify_commit_light wall {light_ms} ms {tag}")
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

    # -- 6. profile: stage builds and field-op chains ------------------------
    chain_entry = profile_phase(torch, dev, t, tg, n, sms, max_clock_mhz, tag)

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
