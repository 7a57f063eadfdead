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
  2. build  — g++ builds the host libraries (``csrc/host_prep.cpp``,
              ``csrc/bls12381.cpp``) and nvcc every kernel, all from the
              repository's sources;
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
              products per SM per clock;
 11. secp   — secp256k1 commit verification (BASELINE config 4), a path of
              its own: 10,240 validators with secp256k1 keys, signed with
              RFC 6979; the ECDSA kernel (``csrc/secp256k1_verify.cu``, a
              quad of four threads per signature over GLV-split scalars)
              against its plain PyTorch version on 10,240 mixed lanes (bad
              signatures, messages, keys, high-S, r or s out of range, bad
              prefixes, x off the curve or >= p, short keys and signatures)
              bit for bit and at SECP_SMALL_N (quads that cut a block:
              15, 16, 17), both against the pure-Python oracle on a
              256-lane sample holding every kind of bad lane, and on the
              edge lanes of ``cuda_secp.edge_lanes`` (u1 = 0, Q = G,
              Q = -G with u1 = u2, u1 or u2 = n - 1, the x >= n branch of
              the compare) against the plain version and their verdicts;
              then the commit through ``verify_commit``/``verify_commit_light``
              -> ``Secp256k1BatchVerifier`` (self-check, signature cache) ->
              the supervisor's single-tier call (breaker ``secp_device``) ->
              ``ops/secp_verify.verify_batch`` -> the kernel, cold and warm,
              the bad commit rejected at exactly 0, 5000 and 10239, every
              secp batch served by the cuda tier; times of the kernel, the
              plain version, host prep, the commit walls and the set-up;
              the parent commit's kernel (SECP_PARENT: one thread per
              signature, its source from ``git show`` or
              $COMETBFT_TPU_SECP_PARENT_SRC, built by nvcc into a temporary
              directory) timed in turns with this one on the same lanes;
              the bound from the work ECDSA verification needs on the
              timed lanes (``cuda_secp.needed_work``), and beside it the
              kernel's own tally; its occupancy (threads per signature,
              registers, local and shared bytes, blocks per SM, waves);
 12. light  — light-client header sync (BASELINE config 3), a path of its
              own: 1,000 equal-power validators, a trusted header at height
              1 and 16 adjacent headers, the set changed at height 9
              (``update_with_change_set``: 100 leave, 100 join, one changes
              power; header 8 names the new set), every commit signed by its
              whole set.  The SHA-256 tree kernel (``csrc/sha256_tree.cu``,
              one launch per tree) against its plain PyTorch version bit for
              bit, every level of both against ``crypto/merkle`` on the
              validator set, on sets of 1-129 leaves, at the edges of its
              chunks of C leaves, on the block-edge leaf lengths and on
              16,384 leaves; then the
              sync through ``light/verifier``: ``verify_adjacent_chain``
              cold and warm (every header's ``ValidatorSet.hash`` through the
              hashing plane -> ``ops/sha256_tree`` -> the tree kernel, the
              commits through ``verify_batches_overlapped`` -> the Ed25519
              kernel), the sequential ``verify_adjacent`` loop,
              ``verify_non_adjacent`` from 1 to 17, and four rejections with
              the JAX package's error classes (a forged signature, a wrong
              ``validators_hash``, an expired trusted header, a target the
              trusted set cannot vouch for), chain and sequential agreeing;
              before them, with the self-check undone, ``verify_adjacent``
              opens the gate itself so that its first set hash is the
              card's; every tree pass and signature batch served by
              ``cuda``, one tree launch per validator-set hash; times of the
              tree kernel at 1,000 and 16,384 leaves beside its critical
              path, its plain version, the host ``crypto/merkle`` and its
              bound; the tree of TREE_PARENT (a leaf kernel and a layer
              launch per level; its source from ``git show`` or
              $COMETBFT_TPU_TREE_PARENT_SRC) and builds of this source at
              each C of TREE_CHUNKS, each timed in turns with this kernel;
              the kernel's spills (none), instruction mix (``cuobjdump``)
              and occupancy; and times of the sync (per header, cold and
              warm) with where a header's time goes;
 13. bls    — BLS12-381 commit verification (BASELINE config 5), a path of
              its own: the G1 scalar-multiplication kernel
              (``csrc/bls_g1.cu``: a group of G threads per lane over a
              schedule of field-operation levels, Jacobian formulas, signed
              4-bit windows, a lazy PTX carry-chain field) against its plain
              PyTorch version as points (the kernel's bytes are another
              representative) on 10,240 seeded lanes (pubkeys of the host
              library, 128-bit scalars; the identity, the generator, a
              repeated point and the scalars 0, 1 and 2^128 - 1 among them),
              on 1-129 lanes (G - 1, G, G + 1 and a block's edge among
              them) and on edge lanes (the order-3 point (0, 2), which
              takes both H = 0 branches, the identity, the scalar edges at
              1, 7, 16 and 128 bits) also against the oracle; against the
              host library's ``bls_g1_scalar_mul`` on a 256-lane sample;
              its field operations on the card (``cuda_bls.fe_op_cuda``)
              against Python integers at the extreme operands; then a
              256-validator commit (keys from
              ``Bls12381PrivKey.from_secret``) through ``verify_commit`` and
              ``verify_commit_light`` -> ``BlsBatchVerifier`` (self-check,
              signature cache, the host library's structural checks) -> the
              supervisor's single-tier call (breaker ``bls_g1``) ->
              ``ops/bls_g1.neg_scaled_pubkeys`` -> the kernel, with the
              hashes to G2, the G2 scaling and the pairing product in the
              host library (``csrc/bls12381.cpp``): cold and warm, a
              tampered commit rejected at exactly 0, 128 and 255 (128 by
              the per-signature attribution after the combination fails),
              one launch per cold batch and every G1 call on ``cuda``; the
              kernel against its plain version as points at the main
              path's widths (the commit's 256 keys and the light commit's
              lanes, fresh 128-bit r_i), then its times at 256 and 10,240
              lanes beside its bound (``cuda_bls.needed_work``), its tally
              and its critical path (dependent multiplies per lane); the
              kernel of BLS_PARENT (its source from ``git show`` or
              $COMETBFT_TPU_BLS_PARENT_SRC) and builds of this source at
              each G of BLS_GROUPS, each timed in turns with this kernel;
              registers, spills (none), occupancy and waves, the
              instruction mix (``cuobjdump``) and the instructions per
              product of the field multiply's body; the cold commit's wall and
              its host parts, with a cProfile top 5.
 14. transport — the encrypted transport plane at CometBFT's defaults, a
              path of its own: the ChaCha20-Poly1305 kernel
              (``csrc/chacha20_poly1305.cu``: a block's threads share its
              frames' ChaCha blocks, a warp per frame runs Poly1305 by
              powers of r) against its
              plain PyTorch version bit for bit at 1,024 lanes of mixed
              lengths (0 to 2,048 bytes, the block edges among them), seal
              and open with tampered ciphertexts and tags, both against
              ``aead_ref`` on a 64-lane sample; the X25519 ladder kernel
              (``csrc/x25519_ladder.cu``, a quad of threads per lane) against its
              plain version at 256 lanes and n = 1, 7, 8, 9, 33, and against
              ``aead_ref.x25519`` on the RFC 7748 5.2 and 6.1 vectors, u with
              bit 255 set, u >= p and the low-order points (zero out); then
              50 ``SecretConnection`` pairs (40 inbound + 10 outbound peers)
              over socket pairs, all 100 handshakes dialing at once through
              ``p2p/handshake_pool`` -> ``ops/x25519_ladder`` -> the ladder
              kernel, each connection carrying a 4 MiB block as 64
              ``write_frames`` flushes of 64 frames of 1,024 bytes (a 64 KiB
              block part a flush) through ``p2p/transportplane`` ->
              ``ops/chacha_aead`` -> the AEAD kernel, read back by
              ``read_frame`` and compared; a flush with a tampered frame
              delivers its exact prefix, then a sticky
              ``SecretConnectionError``; every batched seal and open and every
              pool flush served by ``cuda``; both kernels against their plain
              versions again, bit for bit, on the first inputs the path gave
              them at each of its shapes (seal and open lanes x blocks, ladder
              lanes), kept as it ran; times of both kernels and their
              plain versions beside their bounds and the kernels' own
              tallies, the MAC's dependent multiplies per frame and the
              ladder's dependent field operations per lane, registers,
              spills (none) and occupancy; the kernels of TRANSPORT_PARENT
              (their sources from ``git show`` or
              $COMETBFT_TPU_AEAD_PARENT_SRC / $COMETBFT_TPU_LADDER_PARENT_SRC,
              the ladder's with the parent's ``fe25519.cuh`` beside it) and
              builds of this source at each block shape, each held to the
              package's kernel and timed in turns with it at 1,024 x 16 and
              64 x 16 (AEAD) and 256, 8 and 128 lanes (ladder): one call,
              the device time alone and calls back to back; the AEAD's
              stage builds (AEAD_STAGE) in turns, where its device time
              goes; the handshake storm's wall and handshakes/s, the
              transfer's wall and MB/s, host pack and unpack per flush.
 15. proofs — inclusion proofs and the coalescing proof server, a path of
              its own: eight seeded 4 MiB blocks (``MaxBytes``) of 16,384
              txs of 256 bytes (the tree kernel's lane ceiling);
              ``ops/sha256_tree.tree_proofs`` on the card (one launch of
              the tree kernel, its whole output copied back once, the
              proofs assembled on the host) equal to
              ``crypto/merkle.proofs_from_byte_slices`` in every field of
              every proof of a block, of sets of 1-129 leaves and of the
              SHA block-edge leaf lengths; the kernel's levels equal to its
              plain version bit for bit on the block, the edge lengths and
              sets at the edges of 1-129 (PROOF_PLAIN_N); where a build's
              time goes (packing and H2D, the kernel, the D2H of the
              levels, splitting, ``proofs_from_levels``) beside the host's
              build; then a ``ProofServer`` at its defaults over a store of
              the eight blocks, with header and validator-set hashers
              through the hashing plane, and 64 light-client threads asking
              10,000 queries (``prove_tx``, about 10% header and valset):
              every proof equal to the host oracle's and verified against
              its root, exactly 8 tx builds, every tree pass on ``cuda``,
              nothing shed, no serial fallback; queries/s and the cold
              queries' latency; a build under ``FaultyBackend`` (raise) on
              ``merkle_device`` raising ``BackendError`` through
              ``prove_tx`` with no serial answer; 200 serial ``prove_tx``
              with the kill switch off;
 16. warmboot — the build cache and the warm-boot pass: the build seconds
              phase 2 recorded per library (the cost of a boot with an
              empty build directory); two fresh processes
              (``--warm-child``) sharing the build directory and verifying
              the same commit, read from a file this process writes: one
              runs ``ops/warmboot.run()`` (every library ``hit``, 0
              failures, one self-check launch per kernel, each family's
              seconds) and then its first cold ``verify_commit`` runs no
              build, load or self-check; the other, without warm boot,
              times the same first commit; in this process the AEAD
              kernel's launch made to fail: the family's breaker records it,
              the others are warmed, the next AEAD pass raises
              ``BackendError``; ``ops/bls_g1.msm`` and ``sum_points`` on
              the card at 256 and 10,240 lanes (the products one G1 launch,
              the lane sum a torch tier on the card) against the
              pure-Python oracle's sums at 256 lanes and the host's sum of
              the kernel's products at 10,240, with their times and bound;
 17. blockexec — a blocksync joiner's apply path at BASELINE config 2's
              width, a path of its own: 10,240 equal-power Ed25519 validators
              (seed 20261031), a ``GenesisDoc`` with default consensus params
              (validated, hashed), ``state_from_genesis`` and ``InitChain`` on a
              ``KVStoreApplication`` through ``LocalClient``; a ``SqliteKV``
              chain store in a temporary directory under ``BlockStore``,
              ``StateStore`` and ``EvidencePool``, an ``EventBus`` with one
              NewBlock subscriber, ``NopMempool``; five blocks of 10,240 txs of
              256 bytes (each under ``MaxBytes``; block 2 carries a ``val:`` tx
              that raises one validator's power, block 4 a
              ``DuplicateVoteEvidence`` of height 2), each cut into 64 KiB
              parts, saved with its seen commit (every validator but one
              signs) and applied by ``BlockExecutor.apply_block`` with the
              signature cache cleared (``validate_block``: the LastCommit in one
              Ed25519 launch, the hashes through the tree kernel, the evidence's
              pair in one scheduler flush at ``PRIO_EVIDENCE``; then
              FinalizeBlock, the stores, the events); a copy of block 4 with
              vote B tampered and a copy of block 5 with a bad LastCommit
              signature at 5,000 rejected with the state and the stores
              unchanged; every Ed25519 batch and tree pass of the path on
              ``cuda``, each part set in one tree launch; both kernels
              against their plain versions on the path's own inputs; the
              SQLite files reopened: the state, ``load_validators`` and every
              block equal to what was applied; each block's apply wall and
              its parts, the part-set build, the loads' times.
 18. consensus — the consensus core, a path of its own.  Part A: four
              validators (CometBFT's ``make localnet-start``), each built by
              ``sim/node.build_node`` on the card (the batch backend resolved
              before it returns, so the verify scheduler takes the first
              vote) with an on-disk root (``pv_key.json``, ``pv_state.json``,
              ``cs.wal``), threaded, at ``ConsensusConfig()`` and
              ``MempoolConfig()`` defaults, wired by a loopback relay
              (``broadcast_hook`` -> ``add_peer_message``, with the sim's
              catchup scan); before each height every mempool is offered
              the same 5,000 KVStore txs of 256 bytes (a full mempool, seed
              CONSENSUS_SEED); every proposal and vote signature through
              ``verifysched.verify_cached`` -> the Ed25519 kernel, the data
              and results hashes through the tree kernel.  After five
              heights node 3 is stopped, the signature cache cleared, and it
              is rebuilt from its MemKV and root (the Handshaker replays the
              app, the WAL's catchup replay its height) and catches up; all
              four commit two more heights and it signs both.  Asserted: one
              block hash and one app hash per height everywhere, its state
              equal to its stores, its ``pv_state.json`` never stepping back,
              no evidence, the scheduler active before the first start, its
              consensus-class submissions at least the distinct proposals and
              votes, no shed fallback, every Ed25519 batch and tree pass on
              ``cuda`` and none raised, both kernels equal to their plain
              versions on the path's own inputs.  Printed: each height's
              wall, rounds, txs, launches and lanes per launch; each node's
              apply split (medians over heights); vote-verify latency; the
              restart's replay; the card's busy share (derived).
 18b. sim   — the deterministic simulator (``sim/scenarios.run_scenario``
              on virtual time, ``device=None``: the card, no stand-in at
              any seam), six scenarios at the JAX tests' sizes; every one
              but ``backend-brownout`` is held to fresh CPU processes
              (``--sim-child``, two beside the card's scenarios,
              ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``, the host oracle at the
              seams, no batch on ``cuda``): its trace,
              heights, events, commit hashes and its scheduler's, proof
              plane's and transport plane's blocks of ``summary()`` equal
              the card's; on the card every kernel's batches equal its
              launches.  ``baseline`` and ``crash-restart`` (seed 42);
              ``backend-brownout`` (seed 3) under the card's rule: every
              Ed25519 batch served by ``cuda`` or raised, each raised one
              faulted by the injector or refused by the open breaker, no
              faulted one served, the breakers' transitions and heights
              printed;
              ``dial-storm`` (42): every ladder and AEAD pass on ``cuda``,
              the tampered batch's prefix and the kill-switch wave's bytes
              asserted by the scenario, the AEAD digests in the trace;
              ``light-stampede`` (3): every tree pass on ``cuda``, the
              response digests in the trace, printed, no
              consensus-class shed; ``gossip-burst`` (3): no
              consensus-class shed, every Ed25519 batch on ``cuda``;
              the elastic mesh's ``chip-death`` and ``mesh-brownout`` (3,
              held to a third CPU child) and ``combined-storm`` (3, the
              card's rule: nothing answered below the kernel, the raised
              batches counted) over four virtual ordinals of the card, a
              kernel launch a shard, no mesh runner.  One ``sim:`` line a
              scenario: virtual and wall seconds, launches per kernel,
              ``reached``/``invariants_ok``.
 18c. mesh  — the elastic mesh (``parallel/mesh``, ``parallel/elastic``):
              ``__graft_entry__.dryrun_multichip``'s counterpart (an
              uneven 2W+3 batch and the 10,240 commit with bad (0, 5000,
              10239) through ``verify_batch_sharded`` at W = the card
              count and at four virtual ordinals: bits equal to one
              launch's and the plain version's, the host-summed count, W
              launches and W ``mesh.shard`` spans); each ``FaultyDevice``
              mode on ordinal 2 through ``ops.verify.verify_batch`` with
              no runner (shrink 4 -> 3, ``mesh_dev2`` open, a probe
              restores it, verdicts the plain version's, nothing on
              ``torch`` or ``host``); the sharded launches against one
              10,240-lane launch, in turns (virtual ordinals share the
              card: not a multi-card number).
 19. network — the peer-to-peer network and its reactors, a path of its
              own, each node wired by ``tests/torch_net.py`` as the JAX
              node's ``_setup_p2p`` wires one: a ``NodeKey``, a
              ``Transport`` and a ``Switch`` on 127.0.0.1:0, the consensus,
              blocksync, mempool, evidence and PEX reactors.  Part A:
              four validators (``sim/node.build_node`` on the card,
              ``ConsensusConfig()``, ``MempoolConfig()`` and ``P2PConfig()``
              defaults, on-disk roots) joined over SecretConnection links
              as persistent peers (every dial's ladders through the
              handshake pool and the X25519 kernel, every flush of four
              frames or more through the AEAD kernel); 5,000 txs of 256
              bytes offered to node 0's mempool alone before each height
              (the mempool reactor carries them); a duplicate vote put in
              node 1's evidence pool at height 2 (the evidence reactor
              carries it into a block); after height 4 a fifth,
              non-validator node whose only peer is node 0 blocksyncs to
              the frontier, switches to consensus, follows two more
              heights and learns peers by PEX; each node is a process of
              its own (``--net-node``).  Asserted: one block hash
              and app hash per height on all five, the evidence committed
              in every pool, the joiner's blocksync counters, every
              Ed25519 batch, tree pass, AEAD pass and ladder flush on
              ``cuda``, no shed fallback, no blocksync error logged.  Part
              B, in the script's own process after part A and every
              earlier phase: phase 17's SQLite chain (10,240 validators, five blocks of
              ~3.7 MiB) served by a ``BlocksyncReactor`` behind a switch; a
              fresh non-validator joiner (its own stores and app after
              ``InitChain``, the signature cache cleared) dials it at the
              default 5,120,000 B/s and blocksyncs to height 4 through the
              fused Ed25519 window: its blocks byte for byte the server's,
              its app hash block 5's, its height-5 set the height-2 power
              change, the height-4 evidence checked on the card.  The four
              kernels against their plain versions on the phase's own
              inputs; per height apply and verify ms, launches, lanes, and
              whether the prefetch fused the window or went to
              ``verify_batches_overlapped``.
 20. ingest_statesync — transaction ingestion and state sync, after
              phase 19 in the script's own process.  Part A, CometBFT's
              sentry deployment: a single validator V behind a full node
              S over one SecretConnection link, each a
              ``SigVerifyingApp(KVStoreApplication())`` through
              ``LocalClient``, an envelope-aware ``CListMempool`` at the
              ``MempoolConfig`` defaults and an ``IngestCoalescer`` at its
              defaults on its mempool reactor.  One round (cut from three for
              phase 21; ``INGEST_ROUNDS``): 8 client
              threads call S's ``check_tx`` (as ``broadcast_tx_sync``)
              with 4,905 Ed25519 envelopes (1,024 senders, rising nonces),
              25 secp256k1, 50 forged (102), 10 malformed (101); S's
              gossip to V is held until S has admitted them and the
              signature cache is cleared (V is another machine; S's later
              checks of those envelopes are answered from S's own
              verdicts, as a sentry's own cache would), then V admits
              them through the coalescer into ``check_tx_batch``; then 10
              re-signed at a used nonce (0 at S, 103 at V).  V commits
              every valid tx and no replay; its
              ``process_proposal``/``finalize_block`` re-checks find every
              signature in the cache; every recheck of more than one tx is
              one ``check_txs``; S's rechecks launch nothing; no "batched
              admission failed" line.  Each Ed25519 launch is attributed
              to the paths whose checks its flush carried (V's admission,
              S's clients, rechecks, applies).
              Part B: phase 17's chain extended by blocks 6 and 7 serves a
              ``StatesyncReactor`` and a ``BlocksyncReactor`` behind a
              switch; a fresh joiner whose app is a ``KVStoreApplication``
              behind ``abci/server.ABCIServer`` in a child process
              (``--abci-app``), reached through ``remote_client_creator``,
              discovers the snapshot at 5, verifies it through a
              ``LightClientStateProvider`` on the card (block 1 trusted by
              hash), fetches ~200 chunks of 64 KiB, applies them over the
              socket, bootstraps its stores and blocksyncs block 6: app
              hashes those of headers 6 and 7, its state H's at 5.  Every
              Ed25519 batch, tree pass, AEAD pass and ladder flush on
              ``cuda``; the four kernels against their plain versions on
              the phase's inputs; admission rates, flush ms, light hops,
              socket ms, the restore's MB/s and the busy share.
 21. node — the node as users start it, after phase 20: every port
              process is a child (``--cli-child``) that calls
              ``cometbft_tpu_torch.cmd.main.main`` with the CLI's own
              arguments and reports when it is stopped.  Part A, CometBFT's
              ``make localnet-start``: ``cmd testnet --v 4``, four ``cmd
              start`` processes at the default ``config.toml`` (the RPC, the
              kv indexer, the proof server, the kvstore app), validator 3's
              key behind a ``SignerServer`` child (``priv_validator_laddr``);
              8 client threads send 5,000 txs of 256 bytes by
              ``broadcast_tx_sync`` over the four nodes, then 20 by
              ``broadcast_tx_commit``; a websocket on node 1 subscribes to
              NewBlock; reads of ``status``, ``block``, ``commit``,
              ``validators``, ``block_results``, ``tx_search`` by height on
              every node, ``block_search``, 64 ``tx?prove=true`` (each proof
              checked on the host against the block's data hash) and 64
              ``abci_query``; node 2 stopped, ``cmd rollback``, restarted;
              a fifth home from ``cmd init`` statesyncs from nodes 0 and 1
              and follows 2 heights.  Asserted: equal block hashes, the
              5,020 txs indexed once on every node, every proof and query,
              every height on the websocket, the signer's last-sign state
              never stepping back, every pass of the four kernels ``cuda``
              in every process and each kernel equal to its plain version on
              the process's inputs, no consensus failure but block parts of
              another round.  Part B: ``cmd inspect`` over phase 17's chain
              in a home written around it, a ``cmd light`` proxy in front
              (height 1 trusted by hash), ``commit``, ``validators`` and
              ``block`` read through the proxy at every height above 1:
              each hop's commit through the Ed25519 kernel (3,414 and 6,827
              lanes skipping, 6,827 adjacent), each 10,240-leaf set hash
              through the tree kernel.

The script sets ``COMETBFT_TPU_WARMBOOT=0`` for its own process: a
background warm pass would add self-check launches to the phases'
counts.

Usage, from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Set-up signs 10,240 votes with the pure-Python oracle (~1.6 ms each on one
host core) and the light chain's 17,000 votes on up to 8 processes, 10,240
secp256k1 votes (~5 s) and 256 BLS12-381 votes in the host library
(~1 s), and 100 node keys for the transport phase, and for the blockexec
phase 10,240 keys and five commits of 10,239 votes on up to 8 processes
(the pure-Python oracle), and for phase 20 two more commits of 10,239 votes
and 3 x 4,965 envelope signatures on the same processes: the cost of
making the data, not of verifying it.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import cProfile
import collections
import contextlib
import gc
import hashlib
import json
import logging
import os
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
TRACE_COMMITS = 3  # cold verify_commit samples in each tracing turn
TRACE_VOTES = 5_120  # gossiped votes of a tracing turn (half the gossip phase's)
SECP_SEED = SEED + 5  # the secp256k1 validators' keys
SECP_SMALL_N = (1, 3, 15, 16, 17, 31, 33, 255)
SECP_EDGE_SEED = SEED + 8
SECP_PARENT = "bf5ae8b"  # its secp256k1 kernel: one thread per signature
SECP_AB_RUNS = 10  # samples of each kernel per turn: parent, new, new, parent
LIGHT_SEED = SEED + 7  # the light chain's keys and the tree phase's leaves
LIGHT_VALIDATORS = 1_000  # BASELINE config 3
LIGHT_HEADERS = 16  # adjacent headers after the trusted one
LIGHT_CHANGE_AT = 9  # the first height signed by the changed set
LIGHT_CHANGED = 100  # validators that leave, and that join, there
LIGHT_PERIOD_S = 14 * 24 * 3600  # trusting period
LIGHT_T0 = 1_760_000_000  # header 1's time; a header every 5 s
LIGHT_RUNS = 3  # cold chain samples
LIGHT_FORGED = (11, 123)  # (header of the chain, commit index) forged
LIGHT_BAD_HASH = 4  # header of the chain with a wrong validators_hash
LIGHT_UNTRUSTED_SIGNERS = 300  # of the trusted set's 1,000, on the target
TREE_BIG = 16_384  # the JAX bucket cap, the proof-serving size
TREE_SMALL_N = (1, 2, 3, 8, 9, 31, 32, 33, 63, 65, 127, 129)
TREE_EDGE_LENS = (0, 1, 54, 55, 56, 63, 64, 65, 118, 119, 120)
TREE_PARENT = "4eacead"  # its tree: a leaf kernel and a layer kernel per level
TREE_CHUNKS = (128, 256, 512, 1024)  # leaves per block C, timed in turns
TREE_AB_RUNS = 10  # samples of each tree per turn
TREE_DEPTHS = (1, 2, 4, 16, 64, 256)  # leaves of one-block trees, 1-9 levels
QUEUE_CYCLES = 1_000_000  # the sleep kernel in front of a queued sample
BLS_SEED = SEED + 9  # the BLS validators' keys and the G1 lanes
BLS_VALIDATORS = 256  # BASELINE config 5, cut from 10,240 (host pairing)
BLS_LANES = 10_240  # the G1 kernel against its plain version
BLS_SMALL_N = (1, 31, 32, 33, 129)  # with G - 1, G, G + 1 and a block's edge
BLS_SAMPLE = 256  # lanes held to the host library's G1 scalar mul
BLS_BAD = (0, 128, 255)  # 0 and 255 flipped bytes, 128 signs other bytes
BLS_COLD_RUNS = 3  # cold verify_commit / verify_commit_light samples
BLS_HOST_RUNS = 3  # samples of each host part of the commit
BLS_PARENT = "cb829e7"  # its G1 kernel: one thread per lane, RCB15 formulas
BLS_GROUPS = (1, 2, 4)  # threads per lane, built and timed in turns
BLS_AB_RUNS = 10  # samples of each kernel per turn
# main-path launches: self-check 1 + 3 cold + 3 cold light + warm 0 + bad
# commit 1 + the good commit after it 1 + batch-verifier bits 1
BLS_LAUNCHES = 1 + 2 * BLS_COLD_RUNS + 3
TRANSPORT_SEED = SEED + 11  # the transport phase's keys, frames and block
# CometBFT's defaults: max_num_inbound_peers 40 + max_num_outbound_peers 10
# (config/config.go DefaultP2PConfig), dataMaxSize 1,024
# (p2p/conn/secret_connection.go:47), MaxBytes 4 MiB (types/params.go
# DefaultBlockParams), block parts of 64 KiB (types.BlockPartSizeBytes)
TRANSPORT_PEERS = 50
TRANSPORT_FRAME = 1024
TRANSPORT_BLOCK = 4 << 20
TRANSPORT_PART = 64 << 10
TRANSPORT_BYTES = TRANSPORT_BLOCK // 4  # per connection; cut for phase 20's time
TRANSPORT_FLUSH = TRANSPORT_PART // TRANSPORT_FRAME  # frames per write_frames
TRANSPORT_TAMPER_AT = 37  # the tampered frame of the tampered flush
AEAD_LANES = 1024  # the JAX package's lane ceiling (COMETBFT_TPU_AEAD_MAX_LANES)
AEAD_EDGE_LENS = (0, 1, 15, 16, 17, 63, 64, 65, 1023, 1024, 2048)
AEAD_SAMPLE = 64  # lanes held to aead_ref
LADDER_LANES = 256  # the JAX package's lane ceiling (COMETBFT_TPU_X25519_MAX_LANES)
LADDER_SMALL_N = (1, 7, 8, 9, 33)
TRANSPORT_PARENT = "be4273a"  # its kernels: one thread's Poly1305, one thread a ladder
AEAD_FRAME_CHOICES = (1, 2, 4, 8)  # frames (warps) per CUDA block, timed in turns
LADDER_THREAD_CHOICES = (32, 64, 128)  # threads per block (8-32 quads), in turns
LADDER_PATH_BUCKETS = (8, 128)  # the pool's buckets on the path, timed too
TRANSPORT_AB_RUNS = 10  # samples of each kernel per turn
TRANSPORT_PER = 8  # calls per sample of the back-to-back reading
PROOF_SEED = SEED + 13  # the proof phase's blocks, stores and queries
PROOF_TXS = 16_384  # a 4 MiB block (MaxBytes) of 256-byte txs: the tree's lane ceiling
PROOF_TX_BYTES = 256
PROOF_HEIGHTS = 8  # blocks in the proof server's store
PROOF_VALIDATORS = 1_000  # leaves of each height's validator-set hash
PROOF_CLIENTS = 64  # light-client threads
PROOF_QUERIES = 10_000
PROOF_OTHER = 0.1  # the share of header and valset queries
PROOF_SMALL_N = range(1, 130)
PROOF_EDGE_LENS = (0, 1, 31, 32, 54, 55, 56, 63, 64, 65, 118, 119, 120)
PROOF_PLAIN_N = (1, 2, 3, 31, 32, 33, 127, 128, 129)  # also held to the plain version
PROOF_RUNS = 5  # samples of each part of a proof build
PROOF_SERIAL = 200  # serial prove_tx queries with the kill switch off
WARM_CHILD_TIMEOUT_S = 300
MSM_LANES = (256, 10_240)
MSM_SAMPLE = 256  # lanes of msm and sum_points held to the pure-Python oracle
MSM_RUNS = 3
BLOCKEXEC_SEED = 20261031  # the apply path's keys, txs and evidence
BLOCKEXEC_CHAIN = "blockexec-chain"
BLOCKEXEC_T0 = 1_760_000_000  # genesis time, s; block h at T0 + 6 h
BLOCKEXEC_VALIDATORS = 10_240  # BASELINE config 2's width
BLOCKEXEC_HEIGHTS = 5
BLOCKEXEC_TXS = 10_240  # KVStore key=value txs a block
BLOCKEXEC_TX_BYTES = 256  # 10,240 of them and the LastCommit: ~3.7 MiB < MaxBytes
BLOCKEXEC_PART = 64 << 10  # CometBFT's BlockPartSizeBytes
BLOCKEXEC_VAL_TX_AT = 2  # the block with the val: tx
BLOCKEXEC_CHANGED = 7  # the validator (genesis order) whose power it raises
BLOCKEXEC_CHANGED_POWER = 2
BLOCKEXEC_EVIDENCE_AT = 4  # the block with the duplicate-vote evidence
BLOCKEXEC_EVIDENCE_HEIGHT = 2  # the height its two precommits were signed at
BLOCKEXEC_EQUIVOCATOR = 11  # the equivocating validator (set order, that height)
BLOCKEXEC_ABSENT = 123  # the absent signer of every commit (set order)
BLOCKEXEC_BAD_SIG = 5_000  # the tampered LastCommit signature of the bad block
BLOCKEXEC_SIGNERS = min(8, os.cpu_count() or 1)  # signing processes (set-up only)
CONSENSUS_CHAIN = "consensus-chain"
CONSENSUS_SEED = SEED + 17  # the txs offered before each height
CONSENSUS_NODES = 4  # CometBFT's make localnet-start: node0-node3
CONSENSUS_TXS = 5_000  # MempoolConfig().size: a full mempool before each height
CONSENSUS_TX_BYTES = 256
CONSENSUS_HEIGHTS = 3  # committed by all four before the restart (cut from 5 for phase 20)
CONSENSUS_RESTARTED = 3  # the validator stopped and rebuilt from its stores
CONSENSUS_AFTER = 2  # heights all four commit after the restarted one caught up
CONSENSUS_TIMEOUT_S = 240.0  # each wait of the threaded run
CONSENSUS_CATCHUP_S = 0.5  # the relay's catchup scan (the sim's CATCHUP_INTERVAL)
# the sim phase: (scenario, seed, run_scenario overrides) at the JAX tests'
# seeds and sizes; all but backend-brownout (whose card rule differs from
# the CPU's by design) are held to a CPU child run of the same scenario.
# dial-storm runs to height 10: at its own target (6) both
# packages stop at ~6.6 virtual s, before its third wave (t=7) and its
# kill-switch parity wave (t=9)
# The three elastic-mesh scenarios (seed 3, as the JAX tests run them) run
# over four virtual ordinals of the card, a kernel launch a shard, no
# stand-in; combined-storm (whose single-card brownout raises on the card)
# is held to the card's rule as backend-brownout is.
SIM_SCENARIOS = (("baseline", 42, {}), ("crash-restart", 42, {}),
                 ("backend-brownout", 3, {}), ("dial-storm", 42, {"target_height": 10}),
                 ("light-stampede", 3, {}), ("gossip-burst", 3, {}),
                 ("chip-death", 3, {}), ("mesh-brownout", 3, {}), ("combined-storm", 3, {}))
SIM_AGAINST_CPU = ("baseline", "crash-restart", "dial-storm", "light-stampede",
                   "gossip-burst", "chip-death", "mesh-brownout")
SIM_MESH = ("chip-death", "mesh-brownout", "combined-storm")
SIM_CARD_RULE = ("backend-brownout", "combined-storm")
# the CPU children, each a fresh process running its share in turn: the
# longest alone, so that the children end within the card's runs
SIM_CHILDREN = (("dial-storm",), ("baseline", "crash-restart", "light-stampede",
                                  "gossip-burst"), ("chip-death", "mesh-brownout"))
# the kernels of the sim phase, by their ``ops/dispatch_stats`` tier keys
SIM_TIER_KEYS = {"ed25519": "ed25519", "tree": "merkle", "aead": "aead",
                 "ladder": "x25519"}
SIM_CHILD_TIMEOUT_S = 300
MESH_VIRTUAL = 4  # virtual ordinals of cuda:0 in the mesh phase
MESH_FAULT_LANES = 1_024  # the fault modes' batch, cut from the mixed lanes
MESH_HANG_DEADLINE_MS = 500  # the shard watchdog in the hang mode
MESH_HANG_S = 1.0
MESH_RUNS = 10  # samples of the sharded launches and of one launch, in turns
NETWORK_CHAIN = "network-chain"
NETWORK_SEED = 20261035  # the txs offered to node 0 before each height
NETWORK_NODES = 4  # CometBFT's make localnet-start: node0-node3
NETWORK_TXS = 5_000  # MempoolConfig().size
NETWORK_TX_BYTES = 256
NETWORK_EVIDENCE_AT = 2  # the height node 1's pool takes the duplicate vote at
NETWORK_EQUIVOCATOR = 3  # its validator (set order at height 1)
NETWORK_JOIN_AFTER = 2  # the fifth node starts once every validator has stored it (cut from 4, then 3)
NETWORK_SYNC_MIN = 3  # heights the joiner must blocksync: it dials once node0 stored one more
NETWORK_FOLLOW = 2  # heights the joiner commits after it switched to consensus
NETWORK_PEX = 2  # peers the joiner must learn by PEX, beyond node 0
NETWORK_TIMEOUT_S = 240.0  # each wait of part A
NETWORK_SYNC_TIMEOUT_S = 300.0  # part B's blocksync
INGEST_CHAIN = "ingest-chain"
INGEST_SEED = 20261037  # the senders' keys and the client txs
INGEST_ROUNDS = 1  # rounds of client traffic (cut from 3 for phase 21)
INGEST_CLIENTS = 8  # client threads calling the sentry's check_tx
INGEST_SENDERS = 1_024  # Ed25519 senders, nonces rising
INGEST_SECP_SENDERS = 8
INGEST_ED = 2_450  # valid Ed25519 envelopes a round (cut from 4,905 for the script's time)
INGEST_SECP = 25  # valid secp256k1 envelopes a round
INGEST_FORGED = 50
INGEST_MALFORMED = 10
INGEST_REPLAYS = 10  # re-signed at a nonce the round used, after V admitted it
INGEST_TX_BYTES = 256  # the key=value payload of an envelope
INGEST_TIMEOUT_S = 240.0  # each wait of part A
STATESYNC_SEED = 20261039  # blocks 6 and 7 of phase 17's chain
STATESYNC_TOP = 7  # the helper's height: light blocks 5-7 behind the snapshot at 5
STATESYNC_DISCOVERY_S = 2.0  # the joiner's discovery window (StateSyncConfig: 15 s)
NODE_CHAIN = "node-chain"
NODE_SEED = 20261041  # the clients' txs
NODE_VALIDATORS = 4  # CometBFT's make localnet-start: cmd testnet --v 4
NODE_SIGNED = 3  # the validator whose key a remote signer serves
NODE_TXS = 1_500  # by broadcast_tx_sync (5,000 is MempoolConfig().size: cut for the script's time)
NODE_TX_BYTES = 256
NODE_COMMIT_TXS = 20  # then by broadcast_tx_commit
NODE_CLIENTS = 8  # client threads
NODE_PROVE = 64  # tx?prove=true reads, and as many abci_query reads
NODE_FOLLOW = 2  # heights the statesync joiner follows at the frontier
NODE_DISCOVERY_S = 2  # the joiner's statesync.discovery_time_s (default 15 s)
NODE_TIMEOUT_S = 240.0  # each wait of the phase
NODE_WATCHED = 1  # the validator with instrumentation.prometheus and rpc.pprof_laddr
NODE_TRACE_RING = 65536  # its flight recorder's ring (the dials' spans stay in it)
NODE_KILLED = "node2-restart"  # the validator process SIGKILLed at the end
NODE_PROXY_HEIGHTS = 3  # part B's reads through the proxy (cut from 6 for the mesh phase)
NODE_TRUST_PERIOD_S = 3650 * 86400  # part B: phase 17's chain is dated October 2025


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


def cuda_ms(torch, fn, runs: int, warmup: int, per: int = 1,
            queued: bool = False) -> float:
    """Median device time of one ``fn`` over ``runs`` samples, CUDA events.
    A sample times ``per`` calls back to back and divides.  With ``per`` = 1,
    the method of every ``ms`` this script reports, a sample also counts the
    card's wait for the host to launch the call (Python, ctypes); with
    ``per`` > 1 that wait hides behind the previous call's work.  With
    ``queued`` a sample starts behind a sleep kernel of ~0.5 ms, so the call
    is queued before the card reaches it: its device time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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


class signing_pool:
    """A pool of BLOCKEXEC_SIGNERS spawned processes for set-up signing
    (the pure-Python oracle is ~1.6 ms a signature on one core): calling
    it maps a chunk worker over items in order; ``close`` stops it."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self.workers = BLOCKEXEC_SIGNERS
        self.ex = concurrent.futures.ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"))

    def __call__(self, fn, items: list) -> list:
        return in_chunks(self.ex, fn, items, self.workers)

    def close(self) -> None:
        self.ex.shutdown(wait=True, cancel_futures=True)


def make_commit(n: int, key_from_seed=None, seed: int = SEED):
    """Seeded validator set of ``n`` equal-power keys (Ed25519 unless
    ``key_from_seed`` makes another private key from 32 seeded bytes) and a
    commit signed by all of them.  Returns (vals, commit, block_id,
    sign_bytes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    # Ed25519: keys and signatures on processes; other keys sign here
    pool = signing_pool() if key_from_seed is None else None
    try:
        return _signed_commit(seeds, key_from_seed, pool, rng)
    finally:
        if pool is not None:
            pool.close()


def _signed_commit(seeds, key_from_seed, pool, rng):
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types.basic import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        PartSetHeader,
        Timestamp,
    )
    from cometbft_tpu_torch.types.block import Commit
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.types.vote import CommitSig

    if pool is not None:
        keys = pool(_expand_chunk, seeds)
        pubs = [Ed25519PubKey(k[2]) for k in keys]
    else:
        keys = [key_from_seed(sd) for sd in seeds]
        pubs = [k.pub_key() for k in keys]
    by_addr = {pub.address(): k for pub, k in zip(pubs, keys)}
    vals = ValidatorSet([Validator(pub, 1) for pub in pubs])
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
    jobs = [(by_addr[v.address], sb) for v, sb in zip(vals.validators, sign_bytes)]
    signed = (pool(_sign_chunk, jobs) if pool is not None
              else [k.sign(sb) for k, sb in jobs])
    for cs, sig in zip(commit.signatures, signed):
        cs.signature = sig
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
    cv.reset_launches()
    got, lat, wall_ms = gossip_burst(votes, pks)
    launches = cv.launches
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
    return votes, pks, want


def gossip_burst(votes, pks) -> tuple:
    """PEERS threads call ``Vote.verify`` on ``votes``, one vote at a time
    (thread t takes votes t, t + PEERS, ...): (verdicts, latency of each
    in seconds, wall ms)."""
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
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(not any(th.is_alive() for th in threads), "gossip: a peer hung")
    return got, lat, wall_ms


def tracing_phase(cv, ds, val, vals, block_id, commit, votes, pks, want, tag) -> None:
    """The flight recorder's cost and record on the main path: one cold
    commit's trace (one ``verify.commit`` over one ``verify.dispatch``,
    ``tier="cuda"``, every lane, as the kernel's launch counter says); then
    the cold commit's wall and a gossip burst's vote latency (the first
    ``TRACE_VOTES`` of the gossip phase's votes, its three tampered ones
    among them) in turns: tracing off (``COMETBFT_TPU_TRACE=0``,
    ``COMETBFT_TPU_BLACKBOX=0``), the recorder alone
    (``COMETBFT_TPU_BLACKBOX=0``) and the recorder with a black box, in the
    order off, recorder, on, on, recorder, off.  Verdicts and tiers are the
    same in every turn."""
    import numpy as np

    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import blackbox, tracing

    n = len(commit.signatures)
    cache = sigcache.get_cache()
    tracer = tracing.get_tracer()
    tracer.reset()
    cache.clear()
    cv.reset_launches()
    val.verify_commit(CHAIN_ID, vals, block_id, commit.height, commit)
    spans = tracer.tail(0)
    by_id = {sp["span"]: sp for sp in spans}

    def under(sp, root) -> bool:
        while sp is not None:
            if sp is root:
                return True
            sp = by_id.get(sp.get("parent"))
        return False

    commits = [sp for sp in spans if sp["stage"] == "verify.commit"]
    check(len(commits) == 1, f"tracing: {len(commits)} verify.commit spans")
    dispatches = [sp for sp in spans if sp["stage"] == "verify.dispatch"]
    check(len(dispatches) == 1 == cv.launches and under(dispatches[0], commits[0])
          and dispatches[0]["attrs"]["tier"] == "cuda"
          and dispatches[0]["attrs"]["lanes"] == n == dispatches[0]["attrs"]["n"],
          f"tracing: the cold commit's dispatch spans {dispatches}, {cv.launches} launches")
    print(f"tracing: the cold commit's trace: {json.dumps(commits[0], sort_keys=True)} over "
          f"{json.dumps(dispatches[0], sort_keys=True)} ({len(spans)} spans: "
          f"{sorted({sp['stage'] for sp in spans})}); cuda_verify counted {cv.launches} "
          f"launch {tag}")
    envs = {"off": {"COMETBFT_TPU_TRACE": "0", "COMETBFT_TPU_BLACKBOX": "0"},
            "recorder": {"COMETBFT_TPU_BLACKBOX": "0"}, "on": {}}
    votes, pks = list(votes[:TRACE_VOTES - 3]) + list(votes[-3:]), \
        list(pks[:TRACE_VOTES - 3]) + list(pks[-3:])
    want = list(want[:TRACE_VOTES - 3]) + list(want[-3:])
    rows = {turn: [] for turn in envs}
    for turn in ("off", "recorder", "on", "on", "recorder", "off"):
        bb = tempfile.mkdtemp(prefix="tracing-bb-")
        with environ(envs[turn]):
            journal = blackbox.open_journal(bb)
            check((journal is None) == (turn != "on"), f"tracing: black box in turn {turn}")
            try:
                samples = []
                for _ in range(TRACE_COMMITS):
                    cache.clear()
                    t0 = time.perf_counter()
                    val.verify_commit(CHAIN_ID, vals, block_id, commit.height, commit)
                    samples.append((time.perf_counter() - t0) * 1e3)
                cache.clear()
                got, lat, wall_ms = gossip_burst(votes, pks)
            finally:
                blackbox.close_journal(clean=True)
        check(got == want, f"tracing: turn {turn}: verdicts != the oracle's")
        check_tiers(ds, f"tracing turn {turn}")
        records = 0
        if turn == "on":
            records = blackbox.postmortem_report(bb)["journal"]["records"]
            check(records > 0, "tracing: the black box recorded nothing")
        shutil.rmtree(bb, ignore_errors=True)
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        rows[turn].append({"commit_ms": statistics.median(samples), "vote_p50_ms": p50,
                           "vote_p99_ms": p99, "gossip_wall_ms": wall_ms,
                           "journal_records": records})
    med = {turn: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for turn, rs in rows.items()}
    diff = {turn: {k: med[turn][k] - med["off"][k] for k in med[turn] if k != "journal_records"}
            for turn in ("recorder", "on")}
    print(f"time: tracing off (COMETBFT_TPU_TRACE=0, COMETBFT_TPU_BLACKBOX=0), the recorder "
          f"alone (COMETBFT_TPU_BLACKBOX=0) and on (the recorder and a black box) in turns "
          f"off, recorder, on, on, recorder, off: cold verify_commit of {n} (median of "
          f"{TRACE_COMMITS} a turn) and {len(votes)} gossiped votes by {PEERS} threads; "
          f"medians of each mode's two turns {json.dumps(med)}; less off "
          f"{json.dumps(diff)}; every turn {json.dumps(rows)} {tag}")


def supervisor_phase(cv, ov, ds, cbatch, val, vals, block_id, commit, pubs,
                     sign_bytes, sigs, ref, tag) -> None:
    """Phase 9: the supervisor on the card, under injected faults
    (``FaultyBackend`` on the cuda tier): a batch is served by the kernel
    or raises ``BackendError``, never answered below it and never cached;
    then bisect quarantine, then a clean commit served by the kernel.  The
    fault matrix runs with ``COMETBFT_TPU_TRACE_DIR`` set and a black box
    open: the hang's ``watchdog_fire`` dump names the dispatch triple, the
    breaker's opening is counted, and the journal holds both."""
    import tempfile
    import threading

    from cometbft_tpu_torch.crypto import backend_health as bh
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import blackbox, tracing
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
    flight = tempfile.mkdtemp(prefix="flight-")
    tracer = tracing.get_tracer()
    anomalies0 = dict(tracer.snapshot()["anomalies"])
    journal = blackbox.open_journal(os.path.join(flight, "blackbox"))
    check(journal is not None, "supervisor: the black box did not open")
    try:
        with environ({"COMETBFT_TPU_TRACE_DIR": flight}):
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
    finally:
        blackbox.close_journal(clean=True)
    flight_record(tracer, anomalies0, flight, tag)
    shutil.rmtree(flight, ignore_errors=True)
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


def flight_record(tracer, anomalies0: dict, flight: str, tag) -> None:
    """The supervisor phase's flight record: the ``hang`` fault's
    ``watchdog_fire`` dump (the first of its kind: ``tier="cuda"``,
    ``FAULT_LANES`` lanes, the dispatch ordinal its failed
    ``verify.dispatch`` span carries), the breaker's ``breaker_open``
    counted, and the black box holding both anomalies."""
    from cometbft_tpu_torch.libs import blackbox

    got = tracer.snapshot()["anomalies"]
    delta = {k: v - anomalies0.get(k, 0) for k, v in got.items() if v != anomalies0.get(k, 0)}
    dumps = sorted(f for f in os.listdir(flight) if f.endswith("-watchdog_fire.jsonl"))
    check(len(dumps) == 1, f"supervisor: watchdog_fire dumps {dumps} in {flight}")
    with open(os.path.join(flight, dumps[0])) as f:
        lines = [json.loads(line) for line in f]
    head = lines[0]
    failed = [sp for sp in lines[1:] if sp["stage"] == "verify.dispatch"
              and sp["attrs"].get("error") == "DispatchTimeoutError"]
    check(head["anomaly"] == "watchdog_fire" and head["attrs"]["tier"] == "cuda"
          and head["attrs"]["lanes"] == FAULT_LANES and head["attrs"]["n"] == FAULT_LANES
          and failed and failed[-1]["attrs"]["dispatch"] == head["attrs"]["dispatch"],
          f"supervisor: the watchdog_fire dump {head}, failed spans {failed[-1:]}")
    check(delta.get("breaker_open", 0) >= 1 and delta.get("watchdog_fire", 0) >= 1,
          f"supervisor: anomalies recorded {delta}")
    report = blackbox.postmortem_report(os.path.join(flight, "blackbox"))
    kinds = report["anomaly_counts"]
    check(report["clean_close"] and kinds.get("watchdog_fire", 0) == delta["watchdog_fire"]
          and kinds.get("breaker_open", 0) == delta["breaker_open"],
          f"supervisor: the black box holds {kinds}, the recorder counted {delta}")
    print(f"supervisor: flight recorder: the hang's watchdog_fire dump {dumps[0]} "
          f"({head['spans']} spans) heads {json.dumps(head, sort_keys=True)}; its failed "
          f"verify.dispatch span {json.dumps(failed[-1], sort_keys=True)}; anomalies "
          f"recorded in the fault matrix {delta}; the black box ({report['journal']['records']} "
          f"records, closed clean) holds {kinds} {tag}")


def secp_mixed(s, pubs, msgs, sigs):
    """The secp256k1 commit's triples damaged by lane (index mod 16): 0-6
    valid, 7 a flipped byte of s, 8 another message, 9 another validator's
    key, 10 high-S (n - s: valid ECDSA that the low-S rule rejects), 11
    r = 0, 12 s = 0, 13 r >= n, 14 a bad key (by (i // 16) mod 4: prefix 5,
    x not on the curve, x >= p, 32 bytes), 15 a 63-byte signature."""
    x = 5
    while s.pt_decompress(b"\x02" + x.to_bytes(32, "big")) is not None:
        x += 1
    keys = [b"\x05" + pubs[0][1:], b"\x02" + x.to_bytes(32, "big"),
            b"\x03" + (s.P + 1).to_bytes(32, "big"), pubs[0][:32]]
    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    n = len(pubs)
    for i in range(n):
        kind, sig = i % 16, sigs[i]
        r, sv_ = sig[:32], int.from_bytes(sig[32:], "big")
        if kind == 7:
            sigs[i] = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        elif kind == 8:
            msgs[i] = msgs[i] + b"\x00"
        elif kind == 9:
            pubs[i] = pubs[(i + 1) % n]
        elif kind == 10:
            sigs[i] = r + (s.N - sv_).to_bytes(32, "big")
        elif kind == 11:
            sigs[i] = bytes(32) + sig[32:]
        elif kind == 12:
            sigs[i] = r + bytes(32)
        elif kind == 13:
            sigs[i] = s.N.to_bytes(32, "big") + sig[32:]
        elif kind == 14:
            pubs[i] = keys[(i // 16) % 4]
        elif kind == 15:
            sigs[i] = sig[:63]
    return pubs, msgs, sigs


def start_nvcc(_build, src: bytes, stem: str, *defines, headers=None):
    """Start nvcc on the kernel source ``src`` with the package's flags and
    ``defines``, into a temporary directory, with ``headers`` ({file name:
    bytes}) beside it.  Returns (process, library, directory)."""
    tmp = tempfile.mkdtemp(prefix=f"{stem}-")
    cu = os.path.join(tmp, f"{stem}.cu")
    with open(cu, "wb") as f:
        f.write(src)
    for name, text in (headers or {}).items():
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(text)
    lib = os.path.join(tmp, f"lib{stem}.so")
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def start_parent(_build, env: str, commit: str, source: str, headers=()):
    """Start nvcc on the kernel ``source`` (a path in the repository) of
    ``commit``, to time it beside the current one: its source from the file
    that $``env`` names or from ``git show`` (a copy of the repository that
    is not a git checkout needs the file), built with the package's flags
    into a temporary directory, the ``headers`` it includes (paths in the
    repository) beside it, from that file's directory or ``git show`` too.
    Returns (process, library, directory), or (None, why not, None)."""
    path = os.environ.get(env)

    def read(repo_path, file):
        if path:
            with open(file, "rb") as f:
                return f.read()
        return subprocess.run(
            ["git", "show", f"{commit}:{repo_path}"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, check=True, timeout=60).stdout

    try:
        src = read(source, path)
        hdrs = {os.path.basename(h): read(h, os.path.join(
            os.path.dirname(path or "."), os.path.basename(h))) for h in headers}
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"no source of {commit}'s kernel ({type(e).__name__})", None
    return start_nvcc(_build, src, os.path.basename(source).split(".")[0],
                      headers=hdrs)


def start_parent_secp(_build, cs):
    """The secp256k1 kernel of commit SECP_PARENT (start_parent), from
    $COMETBFT_TPU_SECP_PARENT_SRC or ``git show``."""
    return start_parent(_build, "COMETBFT_TPU_SECP_PARENT_SRC", SECP_PARENT,
                        cs.SOURCE)


def stop_build(build) -> None:
    """Stop a build of start_nvcc or start_parent and remove its directory."""
    proc, _, tmp = build
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def ptxas_lines(log: str) -> list:
    """The register and spill lines of an nvcc log (-Xptxas -v)."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "stack frame" in line]


def parent_secp_launcher(torch, proc, lib):
    """The parent's kernel as a function of the device inputs, returning
    its (n,) bool bits; raises if its build or a launch failed."""
    import ctypes

    log, _ = proc.communicate()
    check(proc.returncode == 0, f"secp: the parent's kernel did not build:\n{log}")
    fn = ctypes.CDLL(lib).secp256k1_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q33, u1, u2, r, ok):
        n = q33.shape[0]
        out = torch.empty((n,), dtype=torch.int32, device=q33.device)
        stream = torch.cuda.current_stream(q33.device).cuda_stream
        flag = ok.to(torch.uint8)
        rc = fn(q33.data_ptr(), u1.data_ptr(), u2.data_ptr(), r.data_ptr(),
                flag.data_ptr(), out.data_ptr(), n, stream)
        check(rc == 0, f"secp: the parent's kernel: CUDA error {rc}")
        return out != 0

    return run, ptxas_lines(log)


def secp_phase(torch, dev, cbatch, val, ds, sigcache, n, bad, sms,
               max_clock_mhz, tag) -> dict:
    """Phase 11: secp256k1 commit verification (BASELINE config 4) through
    the hand-written ECDSA kernel.  Returns its entry of the kernels
    line."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_secp as cs

    parent = start_parent_secp(_build, cs)  # builds while the keys are made
    try:
        return secp_checks(torch, dev, cbatch, val, ds, sigcache, n, bad, sms,
                           max_clock_mhz, tag, parent)
    finally:
        stop_build(parent)


def secp_checks(torch, dev, cbatch, val, ds, sigcache, n, bad, sms,
                max_clock_mhz, tag, parent) -> dict:
    import numpy as np

    from cometbft_tpu_torch.crypto import secp256k1 as s
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_secp as cs
    from cometbft_tpu_torch.ops import secp_verify as sv

    def oracle(p, m, g):
        return len(p) == 33 and s.Secp256k1PubKey(p).verify_signature(m, g)

    t0 = time.perf_counter()
    vals, commit, block_id, sign_bytes = make_commit(
        n, s.Secp256k1PrivKey.from_secret, SECP_SEED)
    setup_s = time.perf_counter() - t0
    pubs = [v.pub_key.bytes() for v in vals.validators]
    sigs = [cs_.signature for cs_ in commit.signatures]
    print(f"secp: {n} secp256k1 keys and signed votes in {setup_s:.2f} s "
          f"(pure-Python RFC 6979 signing over the fixed-base table; data "
          f"set-up, not verification)")

    # the kernel against its plain version and the oracle
    mp, mm, ms = secp_mixed(s, pubs, sign_bytes, sigs)
    t = sv.batch_to_device(sv.prepare_batch(mp, mm, ms), dev)
    kern = cs.verify_core_cuda(**t)
    torch.cuda.synchronize()
    plain = sv.verify_core(**t)
    torch.cuda.synchronize()
    max_abs_err = int((kern.int() - plain.int()).abs().max())
    check(torch.equal(kern, plain),
          f"secp: kernel != plain on {int((kern != plain).sum())} of {n} lanes")
    bits = kern.cpu().numpy()
    rng = np.random.default_rng(SEED + 6)
    head = min(128, n)  # every kind of damage, eight times over
    sample = list(range(head)) + sorted(
        rng.choice(range(head, n), min(128, n - head), replace=False).tolist())
    for i in sample:
        want = oracle(mp[i], mm[i], ms[i])
        check(bool(bits[i]) == want, f"secp lane {i}: kernel {bits[i]}, oracle {want}")
    n_ok = int(bits.sum())
    check(0 < n_ok < n, f"secp: {n_ok} of {n} mixed lanes accepted")
    for k in SECP_SMALL_N:
        sub = {key: v[:k].contiguous() for key, v in t.items()}
        kb = cs.verify_core_cuda(**sub)
        check(torch.equal(kb, sv.verify_core(**sub)), f"secp n={k}: kernel != plain")
        kb = kb.cpu().numpy()
        for i in range(min(k, 64)):
            check(bool(kb[i]) == bool(bits[i]), f"secp n={k}: lane {i}")
    # the edges of the scalars and points, and the x >= n compare branch
    edge, want = cs.edge_lanes(SECP_EDGE_SEED)
    edge = sv.batch_to_device(edge, dev)
    got = cs.verify_core_cuda(**edge).tolist()
    check(got == sv.verify_core(**edge).tolist() == want,
          f"secp edge lanes: kernel {got}, want {want}")
    print(f"secp: kernel: {n} mixed lanes, kernel == plain version bit for "
          f"bit (max_abs_err {max_abs_err}), {n_ok} accepted; {len(sample)}-"
          f"lane sample (every kind of bad and structurally bad lane) == "
          f"oracle; n = {', '.join(map(str, SECP_SMALL_N))} == plain; "
          f"{len(want)} edge lanes (u1 = 0, Q = G, Q = -G with u1 = u2, "
          f"u1 or u2 = n - 1, x(R') >= n) == plain == {want}")

    # the commit through the entry points
    cache = sigcache.get_cache()
    bad_commit = tampered(commit, bad)
    full = lambda: val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    light = lambda: val.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT, commit)

    def cold_ms(fn) -> float:
        cache.clear()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    check(isinstance(cbatch.create_batch_verifier(vals.validators[0].pub_key),
                     cbatch.Secp256k1BatchVerifier),
          "secp: the default verifier is not the secp256k1 one")
    tiers0 = ds.tier_counts("secp256k1")
    cs.reset_launches()
    first_ms = cold_ms(full)
    commit_samples = [cold_ms(full) for _ in range(COMMIT_RUNS)]
    before = cs.launches
    t0 = time.perf_counter()
    full()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(cs.launches == before, f"secp: warm commit made {cs.launches - before} launches")
    light_samples = [cold_ms(light) for _ in range(COMMIT_RUNS)]
    cache.clear()
    try:
        val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, bad_commit)
    except val.InvalidSignatureError as e:
        check(e.index == bad[0], f"secp: InvalidSignatureError({e.index})")
    else:
        raise SmokeError("secp: a commit with bad signatures verified")
    misses, before = cache.stats()["misses"], cs.launches
    full()
    check(cache.stats()["misses"] - misses == len(bad) and cs.launches - before == 1,
          "secp: the bad commit's verdicts changed how the good commit verified")
    cache.clear()
    bv = cbatch.create_batch_verifier(vals.validators[0].pub_key)
    for v, sb, c in zip(vals.validators, sign_bytes, bad_commit.signatures):
        bv.add(v.pub_key, sb, c.signature)
    ok, bad_bits = bv.verify()
    false_at = [i for i, b in enumerate(bad_bits) if not b]
    check(not ok and false_at == list(bad), f"secp: false bits at {false_at}")
    launches = cs.launches
    check(launches == MAIN_PATH_LAUNCHES, f"secp: {launches} kernel launches")
    tiers = {k: (v[0] - tiers0[k][0], v[1] - tiers0[k][1])
             for k, v in ds.tier_counts("secp256k1").items()}
    check(tiers["torch"] == (0, 0) and tiers["host"] == (0, 0) and
          tiers["cuda"][0] == MAIN_PATH_LAUNCHES - 1,
          f"secp: batches served below the cuda tier or missing: {tiers}")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    check(not leaked, f"secp: imported {leaked}")
    print(f"secp: slice: verify_commit ({n} signatures) and "
          f"verify_commit_light passed on the secp256k1 verifier, cold "
          f"(signature cache cleared before each); a warm verify_commit made "
          f"0 launches; bad indices {list(bad)} -> InvalidSignatureError"
          f"({bad[0]}), the good commit after it passed with {len(bad)} "
          f"misses and 1 launch; batch-verifier bits false exactly at "
          f"{list(bad)}; {launches} kernel launches (self-check 1); jax not "
          f"imported; secp batches served by tier (batches, signatures): {tiers}")

    # times
    host = sv.prepare_batch(pubs, sign_bytes, sigs)
    good = sv.batch_to_device(host, dev)
    check(bool(cs.verify_core_cuda(**good).all()), "secp: valid lanes rejected")
    kernel_ms = cuda_ms(torch, lambda: cs.verify_core_cuda(**good), KERNEL_RUNS, 3)
    # the parent's kernel, in turns with this one on the same lanes
    proc, lib, _ = parent
    if proc is None:
        print(f"secp: parent: not measured: {lib}")
    else:
        run_parent, ptxas = parent_secp_launcher(torch, proc, lib)
        check(torch.equal(run_parent(**good), cs.verify_core_cuda(**good)) and
              torch.equal(run_parent(**t), kern),
              "secp: the parent's kernel disagrees with this one")
        fns = {"parent": lambda: run_parent(**good),
               "new": lambda: cs.verify_core_cuda(**good)}
        turns = [(k, cuda_ms(torch, fns[k], SECP_AB_RUNS, 1))
                 for k in ("parent", "new", "new", "parent")]
        parent_ms = statistics.median(v for k, v in turns if k == "parent")
        new_ms = statistics.median(v for k, v in turns if k == "new")
        print(f"secp: parent: the kernel of {SECP_PARENT} (one thread per "
              f"signature; {'; '.join(ptxas)}) == this one on the mixed and "
              f"valid lanes; in turns at {n} lanes (median of {SECP_AB_RUNS} "
              f"one-call samples each): " + ", ".join(
                  f"{k} {v}" for k, v in turns) + f" ms; parent {parent_ms} "
              f"ms, this kernel {new_ms} ms, {parent_ms / new_ms:.3f}x {tag}")
    plain_ms = cuda_ms(torch, lambda: sv.verify_core(**good), 1, 0)
    prep_ms = median_ms(lambda: sv.prepare_batch(pubs, sign_bytes, sigs), HOST_RUNS)
    # the bound: the work the function needs on this run's lanes
    # (libsecp256k1's GLV + wNAF ladder), not the work this kernel does
    muls, squares, products = cs.needed_work(host["q33"], host["u1"], host["u2"],
                                             host["ok"])
    bound_ms, bound_by = bound(products, n * cs.BYTES_PER_SIG, sms, max_clock_mhz)
    # the kernel's own work, from its host build's tally (the same for
    # every lane with ok set)
    tally = int(host["ok"].sum()) * cs.WIDE_PRODUCTS_PER_SIG
    tally_ms, _ = bound(tally, n * cs.BYTES_PER_SIG, sms, max_clock_mhz)
    occ = cs.occupancy()
    commit_ms = statistics.median(commit_samples)
    light_ms = statistics.median(light_samples)
    print(f"secp: time: kernel {kernel_ms} ms at {n} lanes (median of "
          f"{KERNEL_RUNS} samples of one call, CUDA events) = "
          f"{n / kernel_ms * 1e3:.0f} verifies/s; plain PyTorch version "
          f"{plain_ms} ms; host prep (prepare_batch: SHA-256, s^-1 mod n, u1, u2) "
          f"{prep_ms} ms (median of {HOST_RUNS}) {tag}")
    print(f"secp: time: verify_commit cold wall {commit_ms} ms (median of "
          f"{COMMIT_RUNS}; all {commit_samples}; first call, with the "
          f"self-check, {first_ms} ms); warm (0 launches) {warm_ms} ms; "
          f"verify_commit_light cold wall {light_ms} ms (all {light_samples}); "
          f"set-up {setup_s * 1e3:.0f} ms {tag}")
    print(f"secp: time: bound {bound_ms} ms by {bound_by}: {products} "
          f"32x32->64-bit products that ECDSA verification needs on these "
          f"{n} lanes ({muls} field multiplies, {squares} squares and the GLV "
          f"splits: libsecp256k1's wNAF Straus ladder, counted from this "
          f"run's scalars) over {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes "
          f"x {max_clock_mhz:.0f} MHz, or {n * cs.BYTES_PER_SIG} bytes; "
          f"kernel at {bound_ms / kernel_ms:.2%} of its bound {tag}")
    print(f"secp: time: the kernel's own work (its host build's tally): "
          f"{tally} products ({cs.FIELD_MULS_PER_SIG} multiplies, "
          f"{cs.FIELD_SQUARES_PER_SIG} squares, {cs.FIELD_SMALLS_PER_SIG} "
          f"small multiplies and {cs.THREADS_PER_SIG} x "
          f"{cs.KERNEL_SPLIT_PRODUCTS} split products per signature), "
          f"{tally / products:.3f}x the bound's, {tally_ms} ms at the same "
          f"rates; kernel at {tally_ms / kernel_ms:.2%} of that {tag}")
    print("secp: library_ms is null: no PyTorch library call computes "
          "secp256k1 ECDSA verification")
    grid = -(-n * cs.THREADS_PER_SIG // occ["threads"])
    waves = -(-grid // (occ["blocks_per_sm"] * sms))
    print(f"occupancy: {cs.NAME}: {cs.THREADS_PER_SIG} threads per signature, "
          f"{occ['threads']} threads per block, {occ['regs']} registers and "
          f"{occ['local_bytes']} bytes of local memory per thread, "
          f"{occ['shared_bytes']} bytes of shared memory per block; "
          f"{occ['blocks_per_sm']} blocks resident per SM; {n} lanes -> "
          f"{grid} blocks, {waves} wave(s) on {sms} SMs {tag}")
    check(occ["local_bytes"] == 0 and waves == 1,
          f"secp: {occ['local_bytes']} local bytes, {waves} waves")
    mix = sass_mix(_build.lib_path(cs.NAME), "secp256k1_verify_kernel", True)
    total = sum(mix.values())
    wide = sum(v for k, v in mix.items() if k.startswith("IMAD.WIDE"))
    top = sorted(mix.items(), key=lambda kv: -kv[1])[:8]
    print(f"secp: sass: {total} instructions of machine code, {wide} "
          f"IMAD.WIDE (one 32x32->64-bit product each): {total / wide:.2f} "
          f"instructions per product in the code; most common {top} {tag}")
    return {
        "name": cs.NAME, "route": "cuda", "source": cs.SOURCE,
        "replaces": cs.REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def tampered(commit, idx):
    """A copy of ``commit`` with the last byte of the signatures at ``idx``
    flipped."""
    out = type(commit)(
        commit.height, commit.round_, commit.block_id,
        [type(c)(c.block_id_flag, c.validator_address, c.timestamp, c.signature)
         for c in commit.signatures],
    )
    for i in idx:
        sig = out.signatures[i].signature
        out.signatures[i].signature = sig[:-1] + bytes([sig[-1] ^ 1])
    return out


def make_light_chain(n: int, headers: int):
    """BASELINE config 3's chain: ``n`` equal-power validators (keys from
    LIGHT_SEED), light blocks at heights 1 .. ``headers`` + 1, the set
    changed at LIGHT_CHANGE_AT by ``update_with_change_set`` (the first
    LIGHT_CHANGED leave, as many join, one more changes power), each header
    at its own time with a block id whose hash is ``Header.hash()``, each
    commit signed by its whole set.  Returns (light blocks, the set before,
    the set after)."""
    import numpy as np

    rng = np.random.default_rng(LIGHT_SEED)
    pool = signing_pool()
    try:
        return _light_chain(n, headers, rng, pool)
    finally:
        pool.close()


def _light_chain(n: int, headers: int, rng, pool):
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types.basic import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        PartSetHeader,
        Timestamp,
    )
    from cometbft_tpu_torch.types.block import Commit, ConsensusVersion, Header
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.types.vote import CommitSig

    keys = pool(_expand_chunk, [rng.bytes(32) for _ in range(n + LIGHT_CHANGED)])
    pubs = [Ed25519PubKey(k[2]) for k in keys]
    by_addr = {p.address(): k for p, k in zip(pubs, keys)}
    before = ValidatorSet([Validator(p, 10) for p in pubs[:n]])
    after = before.copy()
    after.update_with_change_set(
        [Validator(p, 0) for p in pubs[:LIGHT_CHANGED]]
        + [Validator(p, 10) for p in pubs[n:]]
        + [Validator(pubs[LIGHT_CHANGED], 30)])
    hashes = {id(before): before.hash(), id(after): after.hash()}
    lbs, bid = [], BlockID()
    for h in range(1, headers + 2):
        base = before if h < LIGHT_CHANGE_AT else after
        nxt = before if h + 1 < LIGHT_CHANGE_AT else after
        vals = base.copy_increment_proposer_priority(h)
        t = Timestamp(LIGHT_T0 + 5 * (h - 1), 0)
        header = Header(
            version=ConsensusVersion(11, 1), chain_id=CHAIN_ID, height=h, time=t,
            last_block_id=bid,
            data_hash=hashlib.sha256(b"data-%d" % h).digest(),
            validators_hash=hashes[id(base)],
            next_validators_hash=hashes[id(nxt)],
            app_hash=hashlib.sha256(b"app-%d" % h).digest(),
            proposer_address=vals.get_proposer().address,
        )
        bid = BlockID(header.hash(),
                      PartSetHeader(1, hashlib.sha256(b"parts-%d" % h).digest()))
        commit = Commit(h, 0, bid, [
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                      Timestamp(t.seconds + 1, 1_000_003 * i), b"")
            for i, v in enumerate(vals.validators)])
        lbs.append(LightBlock(SignedHeader(header, commit), vals))
    # every commit's signatures in one pass over the processes (no header
    # hash depends on a signature)
    jobs = [(by_addr[v.address], m) for lb in lbs
            for v, m in zip(lb.validator_set.validators,
                            lb.signed_header.commit.all_vote_sign_bytes(CHAIN_ID))]
    signed = iter(pool(_sign_chunk, jobs))
    for lb in lbs:
        for cs in lb.signed_header.commit.signatures:
            cs.signature = next(signed)
    return lbs, before, after


def _with_commit(lb, commit, header=None):
    """A copy of light block ``lb`` with another commit (and header)."""
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader

    return LightBlock(SignedHeader(header or lb.signed_header.header, commit),
                      lb.validator_set)


def light_cases(lbs):
    """The rejections of the light phase, built from the good chain: name
    -> (the bad light block, the chain of adjacent headers that ends in it,
    the error class the JAX package raises, the index it names)."""
    import dataclasses

    from cometbft_tpu_torch.types.basic import BlockID
    from cometbft_tpu_torch.types.vote import CommitSig

    news = lbs[1:]
    j, i = LIGHT_FORGED
    forged = tampered(news[j].signed_header.commit, [i])
    forged = _with_commit(news[j], forged)
    old = news[LIGHT_BAD_HASH]
    header = dataclasses.replace(old.signed_header.header, validators_hash=b"\x11" * 32)
    c = old.signed_header.commit
    # the commit follows the header, so validate_basic reaches the set check
    bad_hash = _with_commit(old, type(c)(
        c.height, c.round_, BlockID(header.hash(), c.block_id.part_set_header),
        c.signatures), header)
    trusted_vals = lbs[0].validator_set
    target = lbs[-1]
    keep = [k for k, v in enumerate(target.validator_set.validators)
            if trusted_vals.has_address(v.address)][:LIGHT_UNTRUSTED_SIGNERS]
    keep = set(keep)
    c = target.signed_header.commit
    untrusted = _with_commit(target, type(c)(c.height, c.round_, c.block_id, [
        cs if k in keep else CommitSig() for k, cs in enumerate(c.signatures)]))
    return {
        "forged signature": (forged, news[:j] + [forged],
                             "InvalidSignatureError", i),
        "wrong validators_hash": (bad_hash, news[:LIGHT_BAD_HASH] + [bad_hash],
                                  "ErrInvalidHeader", None),
        "untrusted target": (untrusted, None, "ErrNewValSetCantBeTrusted", None),
    }


def sass_ops(lib, kernel: str) -> list:
    """The opcodes, with their modifiers and in order, of ``kernel``'s
    machine code in the built library ``lib`` (``cuobjdump -sass``)."""
    from pathlib import Path

    from cometbft_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    ops, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = inside and re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops.append(m.group(1))
    return ops


def sass_mix(lib, kernel: str, modifiers: bool = False) -> dict:
    """Opcode counts of ``kernel``'s machine code in the built library
    ``lib`` (an opcode without its modifiers unless ``modifiers``)."""
    ops = sass_ops(lib, kernel)
    return dict(collections.Counter(ops if modifiers else
                                    (o.split(".")[0] for o in ops)))


MUL_BODY_GAP = 24  # instructions between two products of one multiply, at most


def mul_body(ops: list) -> list:
    """The instructions of a field multiply's body in a kernel's opcodes:
    from the first IMAD.WIDE to the last of the longest run of them in
    which no two are more than MUL_BODY_GAP instructions apart."""
    at = [i for i, o in enumerate(ops) if o.startswith("IMAD.WIDE")]
    runs = [[at[0]]] if at else []
    for i in at[1:]:
        if i - runs[-1][-1] <= MUL_BODY_GAP:
            runs[-1].append(i)
        else:
            runs.append([i])
    best = max(runs, key=len, default=None)
    return ops[best[0]:best[-1] + 1] if best else []


def tree_launcher(torch, dev, build, parent: bool):
    """A tree kernel being built by ``build`` (start_nvcc, start_parent) as
    a function of (data, offs) on ``dev`` that returns every level's words:
    TREE_PARENT's leaf launch and one layer launch per level (``parent``),
    or one launch of a build of the current kernel with a ticket of its own.
    Returns (function, ptxas lines); raises if the build failed."""
    import ctypes

    from cometbft_tpu_torch.ops import sha256_tree as st

    proc, lib, _ = build
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"light: a tree kernel did not build:\n{log}")
    so, vp, i32 = ctypes.CDLL(lib), ctypes.c_void_p, ctypes.c_int
    if parent:
        leaf, layer = so.sha256_leaf_launch, so.sha256_layer_launch
        leaf.argtypes = [vp, vp, i32, vp, vp]
        layer.argtypes = [vp, i32, vp, vp]
    else:
        tree = so.sha256_tree_launch
        tree.argtypes = [vp, vp, i32, vp, vp, vp]
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(data, offs):
        n = offs.numel() - 1
        sizes = st.level_sizes(n)
        out = torch.empty((sum(sizes), 8), dtype=torch.int32, device=dev)
        base = out.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if parent:
            rc = [leaf(data.data_ptr(), offs.data_ptr(), n, base, stream)]
            o = 0
            for k in sizes[:-1]:
                rc.append(layer(base + 32 * o, k, base + 32 * (o + k), stream))
                o += k
        else:
            rc = [tree(data.data_ptr(), offs.data_ptr(), n, base,
                       ticket.data_ptr(), stream)]
        check(not any(rc), f"light: a tree kernel's launch: CUDA errors {rc}")
        return out

    return run, ptxas_lines(log)


def light_phase(torch, dev, cbatch, cv, ds, sigcache, sms, max_clock_mhz,
                tag) -> dict:
    """Phase 12: light-client header sync (BASELINE config 3) through the
    SHA-256 tree kernel and the Ed25519 kernel.  Returns the tree kernel's
    entry of the kernels line."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_sha256 as csh

    # TREE_PARENT's tree and the current source at each C of TREE_CHUNKS,
    # built while the chain is signed
    src = (_build.CSRC_DIR / "sha256_tree.cu").read_bytes()
    builds = {"parent": start_parent(_build, "COMETBFT_TPU_TREE_PARENT_SRC",
                                     TREE_PARENT, csh.SOURCE)}
    builds.update({c: start_nvcc(_build, src, "sha256_tree", f"-DSHA256_CHUNK={c}")
                   for c in TREE_CHUNKS})
    try:
        return light_checks(torch, dev, cbatch, cv, ds, sigcache, sms,
                            max_clock_mhz, tag, builds)
    finally:
        for build in builds.values():
            stop_build(build)


def light_checks(torch, dev, cbatch, cv, ds, sigcache, sms, max_clock_mhz,
                 tag, builds) -> dict:
    import numpy as np

    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.light import verifier as lv
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.proofserve import plane
    from cometbft_tpu_torch.types import validation as val
    from cometbft_tpu_torch.types.validator import ValidatorSet

    t0 = time.perf_counter()
    lbs, before, after = make_light_chain(LIGHT_VALIDATORS, LIGHT_HEADERS)
    setup_s = time.perf_counter() - t0
    print(f"light: {LIGHT_VALIDATORS} validators, {LIGHT_HEADERS + 1} headers "
          f"(set changed at height {LIGHT_CHANGE_AT}: {LIGHT_CHANGED} left, "
          f"{LIGHT_CHANGED} joined, one changed power; {len(after)} validators "
          f"of total power {after.total_voting_power()} after it), "
          f"{sum(len(lb.signed_header.commit.signatures) for lb in lbs)} "
          f"signed votes in {setup_s:.2f} s (pure-Python signing; data "
          f"set-up, not verification)")

    # the tree kernel against its plain version and crypto/merkle, at the
    # chunk edges too (C leaves per block)
    chunk = csh.occupancy()["threads"]
    edges = (1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 4 * chunk - 1)
    rng = np.random.default_rng(LIGHT_SEED + 1)
    cycle = lambda k: [rng.bytes(TREE_EDGE_LENS[x % len(TREE_EDGE_LENS)])
                       for x in range(k)]
    validators = [v.simple_encode() for v in before.validators]
    big = [rng.bytes(int(ln)) for ln in rng.integers(0, 128, TREE_BIG)]
    sets = {"the validator set": validators}
    sets.update({f"{k} leaves": cycle(k)
                 for k in sorted(set(TREE_SMALL_N) | set(edges))})
    sets.update({f"9 leaves of {ln} bytes": [rng.bytes(ln) for _ in range(9)]
                 for ln in TREE_EDGE_LENS})
    sets[f"{TREE_BIG} leaves"] = big
    worst = 0
    for name, items in sets.items():
        data, offs = st.pack_leaves(items, dev)
        kern = csh.tree_words(data, offs)
        torch.cuda.synchronize()
        plain = st.tree_words_plain(data, offs)
        err = int((kern.long() - plain.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(kern, plain), f"light: tree kernel != plain on {name} "
              f"(max_abs_err {err})")
        levels = st.split_levels(kern.cpu().numpy(), len(items))
        check(levels == st.host_levels(items),
              f"light: tree levels != crypto/merkle's on {name}")
        check(st.device_root(items) == levels[-1][0]
              == merkle.hash_from_byte_slices(items),
              f"light: tree root != crypto/merkle on {name}")
    print(f"light: tree kernel == plain version bit for bit (max_abs_err "
          f"{worst}), every level == crypto/merkle's leaf and inner hashes, "
          f"the device pass's root == crypto/merkle's, on {len(sets)} leaf "
          f"sets (C = {chunk} leaves per block; chunk edges "
          f"{', '.join(map(str, edges))}, {TREE_BIG}): {', '.join(sets)}")

    # the sync through the entry points
    trusted, news = lbs[0], lbs[1:]
    now = LIGHT_T0 + 5 * (LIGHT_HEADERS + 2)
    cache = sigcache.get_cache()
    made = [0]  # validator-set hashes at the plane's width
    real_hash = ValidatorSet.hash

    def counted_hash(self, device=None):
        if len(self) >= plane.min_batch():
            made[0] += 1
        return real_hash(self, device)

    def chain(news_, now_=now):
        lv.verify_adjacent_chain(CHAIN_ID, trusted, news_, LIGHT_PERIOD_S, now_)

    def sequential(news_, now_=now):
        current = trusted
        for lb in news_:
            lv.verify_adjacent(CHAIN_ID, current, lb, LIGHT_PERIOD_S, now_)
            current = lb

    def outcome(fn):
        try:
            fn()
        except (lv.LightClientError, val.CommitVerificationError) as e:
            return type(e).__name__, getattr(e, "index", None)
        return None

    # a fresh process: no self-check has run, and the entry point runs it
    # before the first header's hashes, which are then the card's
    cbatch._SELF_CHECKED.clear()
    check(not st.device_active(), "light: the gate is open before any self-check")
    fresh0 = ds.tier_counts(st.MERKLE)
    lv.verify_adjacent(CHAIN_ID, trusted, news[0], LIGHT_PERIOD_S, now)
    fresh = {k: v[0] - fresh0[k][0] for k, v in ds.tier_counts(st.MERKLE).items()}
    check(st.device_active() and fresh["cuda"] == 1 and fresh["host"] == 0,
          f"light: the first header of a fresh gate hashed its set by tier {fresh}")
    print(f"light: a fresh gate: verify_adjacent ran the self-check before the "
          f"header checks; the first validator-set hash by tier {fresh}")

    ed0, tree0 = ds.tier_counts(), ds.tier_counts(st.MERKLE)
    over0 = ds.tier_counts(st.MERKLE_OVERSIZE)
    cv.reset_launches()
    csh.reset_launches()
    ValidatorSet.hash = counted_hash
    try:
        cold = []
        for _ in range(LIGHT_RUNS):
            cache.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain(news)
            cold.append((time.perf_counter() - t0) * 1e3)
        cold_launches = cv.launches
        check(cold_launches == LIGHT_RUNS * LIGHT_HEADERS,
              f"light: {cold_launches} Ed25519 launches for {LIGHT_RUNS} cold "
              f"chains of {LIGHT_HEADERS} headers")
        t0 = time.perf_counter()
        chain(news)
        warm_ms = (time.perf_counter() - t0) * 1e3
        check(cv.launches == cold_launches,
              f"light: the warm chain made {cv.launches - cold_launches} launches")
        cache.clear()
        t0 = time.perf_counter()
        sequential(news)
        seq_ms = (time.perf_counter() - t0) * 1e3
        cache.clear()
        t0 = time.perf_counter()
        lv.verify_non_adjacent(CHAIN_ID, trusted, lbs[-1], LIGHT_PERIOD_S, now)
        nonadj_ms = (time.perf_counter() - t0) * 1e3
        lv.verify(CHAIN_ID, trusted, lbs[1], LIGHT_PERIOD_S, now)
        lv.verify(CHAIN_ID, trusted, lbs[-1], LIGHT_PERIOD_S, now)

        # rejections, each with the JAX package's error class
        late = LIGHT_T0 + LIGHT_PERIOD_S + 1
        seen = {"expired trusted header": (
            outcome(lambda: chain(news, late)), outcome(lambda: sequential(news, late)),
            outcome(lambda: lv.verify_non_adjacent(CHAIN_ID, trusted, lbs[-1],
                                                   LIGHT_PERIOD_S, late)))}
        check(set(seen["expired trusted header"]) == {("ErrOldHeaderExpired", None)},
              f"light: expired: {seen}")
        for name, (bad, run, want, index) in light_cases(lbs).items():
            if run is None:
                got = (outcome(lambda: lv.verify_non_adjacent(
                           CHAIN_ID, trusted, bad, LIGHT_PERIOD_S, now)),
                       outcome(lambda: lv.verify(CHAIN_ID, trusted, bad,
                                                 LIGHT_PERIOD_S, now)))
            else:
                # the run before the bad header passes (warm): it is the
                # bad header that raises, on both paths
                chain(run[:-1])
                got = (outcome(lambda: chain(run)), outcome(lambda: sequential(run)))
            seen[name] = got
            check(set(got) == {(want, index)}, f"light: {name}: {got}, want "
                  f"{(want, index)}")
    finally:
        ValidatorSet.hash = real_hash
    launches = csh.launches
    tree = {k: (v[0] - tree0[k][0], v[1] - tree0[k][1])
            for k, v in ds.tier_counts(st.MERKLE).items()}
    over = {k: v[0] - over0[k][0] for k, v in ds.tier_counts(st.MERKLE_OVERSIZE).items()}
    ed = {k: (v[0] - ed0[k][0], v[1] - ed0[k][1]) for k, v in ds.tier_counts().items()}
    check(tree["cuda"][0] == made[0] > 0 and tree["torch"] == tree["host"] == (0, 0)
          and not any(over.values()),
          f"light: tree passes by tier {tree}, oversize {over}, for {made[0]} "
          f"validator-set hashes")
    check(ed["cuda"][0] > 0 and ed["torch"] == ed["host"] == (0, 0),
          f"light: signature batches by tier {ed}")
    check(cv.launches > 0 and launches == made[0] > 0,
          f"light: {launches} tree launches for {made[0]} validator-set "
          f"hashes, {cv.launches} Ed25519 launches")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    check(not leaked, f"light: imported {leaked}")
    print(f"light: slice: verify_adjacent_chain over {LIGHT_HEADERS} headers "
          f"passed cold ({LIGHT_RUNS} runs, cache cleared before each, "
          f"{LIGHT_HEADERS} Ed25519 launches each) and warm (0 Ed25519 "
          f"launches); the sequential verify_adjacent loop, verify_non_adjacent "
          f"1 -> {LIGHT_HEADERS + 1} and verify passed; rejections, chain and "
          f"sequential agreeing, as (error, index): {seen}; "
          f"{made[0]} validator-set hashes, tree passes by tier (passes, "
          f"leaves) {tree}, oversize {over}; signature batches by tier {ed}; "
          f"launches: tree kernel {launches} (one per validator-set hash), "
          f"Ed25519 {cv.launches}; jax not imported")

    # times: the tree kernel, its plain version and the host merkle
    def tree_times(items):
        data, offs = st.pack_leaves(items, dev)
        fn = lambda: csh.tree_words(data, offs)
        ms = cuda_ms(torch, fn, KERNEL_RUNS, 3)
        device_ms = cuda_ms(torch, fn, KERNEL_RUNS, 3, queued=True)
        plain_ms = cuda_ms(torch, lambda: st.tree_words_plain(data, offs), 3, 1)
        host_ms = median_ms(lambda: merkle.hash_from_byte_slices(items), 5)
        lens = [len(x) for x in items]
        comps = csh.compressions(lens)
        nbytes = (sum(lens) + 8 * (len(items) + 1)
                  + 32 * sum(st.level_sizes(len(items))))
        b_ms, b_by = bound(comps * csh.OPS_PER_COMPRESSION, nbytes, sms,
                           max_clock_mhz)
        # the longest chain of dependent compressions: a leaf's blocks, then
        # two per level above it
        levels = len(st.level_sizes(len(items)))
        crit = max((ln + 9) // 64 + 1 for ln in lens) + 2 * (levels - 1)
        print(f"light: time: tree kernel {ms} ms at {len(items)} leaves (1 "
              f"launch, {-(-len(items) // chunk)} blocks of {chunk}; median of "
              f"{KERNEL_RUNS} samples of one call, CUDA events), its device "
              f"time alone {device_ms} ms (queued behind a sleep kernel); "
              f"critical path {crit} dependent compressions ({levels} "
              f"levels): {ms / crit * 1e3:.4f} us per critical compression, "
              f"{device_ms / crit * 1e3:.4f} us of device time; plain "
              f"PyTorch version {plain_ms} ms; host crypto/merkle (the host "
              f"path, not a card number) {host_ms} ms; bound {b_ms} ms by "
              f"{b_by}: {comps} compressions x {csh.OPS_PER_COMPRESSION} sm_90 "
              f"integer instructions (SHF, LOP3, IADD3, IADD) over "
              f"{sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
              f"{max_clock_mhz:.0f} MHz, or {nbytes} bytes; kernel at "
              f"{b_ms / ms:.2%} of its bound ({b_ms / device_ms:.2%} of its "
              f"device time) {tag}")
        return ms, plain_ms, b_ms, b_by

    kernel_ms, plain_ms, bound_ms, bound_by = tree_times(validators)
    tree_times(big)
    print("light: library_ms is null: no PyTorch library call computes SHA-256")

    # device time against depth: trees of one block, 1 to 9 levels
    depth = {}
    for k in TREE_DEPTHS:
        data, offs = st.pack_leaves(validators[:k], dev)
        depth[k] = cuda_ms(torch, lambda: csh.tree_words(data, offs),
                           KERNEL_RUNS, 3, queued=True)
    top = len(st.level_sizes(TREE_DEPTHS[-1])) - 1
    per_level = (depth[TREE_DEPTHS[-1]] - depth[1]) / top
    print(f"light: depth: device time alone (queued) of the first k "
          f"validators' tree: " + ", ".join(
              f"k = {k} ({len(st.level_sizes(k))} levels) {v} ms"
              for k, v in depth.items())
          + f"; {per_level * 1e3:.4f} us per level above the leaves (two "
          f"dependent compressions, a barrier), {depth[1] * 1e3:.4f} us for "
          f"the launch and one leaf {tag}")

    def in_turns(items, fns, order):
        """Medians per tree of ``fns`` over ``items``, one-call and queued
        (device time alone), sampled in ``order`` (TREE_AB_RUNS samples of
        each a turn), each tree first held to this kernel's words."""
        data, offs = st.pack_leaves(items, dev)
        want = csh.tree_words(data, offs)
        for k, fn in fns.items():
            check(torch.equal(fn(data, offs), want),
                  f"light: tree {k} != this kernel on {len(items)} leaves")
        turns = [(k, cuda_ms(torch, lambda: fns[k](data, offs), TREE_AB_RUNS, 1),
                  cuda_ms(torch, lambda: fns[k](data, offs), TREE_AB_RUNS, 1,
                          queued=True))
                 for k in order]
        med = {k: (statistics.median(a for j, a, _ in turns if j == k),
                   statistics.median(b for j, _, b in turns if j == k))
               for k in fns}
        return med, "; ".join(f"{k} {a} / {b}" for k, a, b in turns)

    # TREE_PARENT's two-kernel tree, in turns with this one
    if builds["parent"][0] is None:
        print(f"light: parent: not measured: {builds['parent'][1]}")
    else:
        run_parent, ptxas = tree_launcher(torch, dev, builds["parent"], True)
        fns = {"parent": run_parent, "new": csh.tree_words}
        for items in (validators, big):
            med, turns = in_turns(items, fns, ("parent", "new", "new", "parent"))
            (p1, pq), (n1, nq) = med["parent"], med["new"]
            print(f"light: parent: the tree of {TREE_PARENT} (a leaf launch "
                  f"and one layer launch per level, "
                  f"{len(st.level_sizes(len(items)))} launches; "
                  f"{'; '.join(ptxas)}) == this kernel; in turns at "
                  f"{len(items)} leaves, one-call / queued ms (medians of "
                  f"{TREE_AB_RUNS} samples each): {turns}; parent {p1} / {pq} "
                  f"ms, this kernel {n1} / {nq} ms: {p1 / n1:.3f}x one-call, "
                  f"{pq / nq:.3f}x device time {tag}")

    # C, the leaves per block: each of TREE_CHUNKS built from this source
    runs = {}
    for c in TREE_CHUNKS:
        runs[c], ptxas = tree_launcher(torch, dev, builds[c], False)
        print(f"light: chunks: C = {c}: {'; '.join(ptxas)}")
    order = TREE_CHUNKS + TREE_CHUNKS[::-1]
    for items in (validators, big):
        med, turns = in_turns(items, runs, order)
        print(f"light: chunks: in turns at {len(items)} leaves, one-call / "
              f"queued ms (medians of {TREE_AB_RUNS} samples a turn; turns "
              f"{turns}): " + ", ".join(f"C = {k} {a} / {b} ms"
                                        for k, (a, b) in med.items())
              + f"; the package builds C = {chunk} {tag}")

    log = _build.build_log(csh.NAME)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    check(spills and not any(int(a) or int(b) for a, b in spills),
          f"light: the tree kernel spills: {ptxas_lines(log)}")
    mix = sass_mix(_build.lib_path(csh.NAME), "sha256_tree_kernel")
    alu = {k: mix.get(k, 0) for k in ("SHF", "LOP3", "IADD3", "IADD", "IMAD",
                                      "PRMT", "SHL", "SHR", "LEA", "BAR", "LDS",
                                      "STS")}
    check(sum(mix.values()) > 0, "light: cuobjdump showed no sha256_tree_kernel")
    print(f"sass: sha256_tree_kernel (a leaf, then one parent per level, per "
          f"thread): {sum(mix.values())} instructions, of them {alu}; the "
          f"bound counts {csh.OPS_PER_COMPRESSION} per compression {tag}")
    occ = csh.occupancy()
    print(f"occupancy: {csh.NAME}: 1 thread per leaf, C = {occ['threads']} "
          f"threads per block, {occ['regs']} registers and "
          f"{occ['local_bytes']} bytes of local memory per thread, "
          f"{occ['shared_bytes']} bytes of shared memory per block; "
          f"{occ['blocks_per_sm']} blocks resident per SM; ptxas: "
          f"{'; '.join(ptxas_lines(log))} {tag}")
    check(occ["local_bytes"] == 0, f"light: {occ['local_bytes']} local bytes")

    # times: the sync, and where a header's time goes
    per_cold = statistics.median(cold) / LIGHT_HEADERS
    print(f"light: time: verify_adjacent_chain over {LIGHT_HEADERS} headers of "
          f"{LIGHT_VALIDATORS} validators: cold {statistics.median(cold)} ms "
          f"(median of {LIGHT_RUNS}; all {cold}) = {per_cold} ms per header = "
          f"{1e3 / per_cold:.1f} headers/s; warm (0 Ed25519 launches) {warm_ms} "
          f"ms = {warm_ms / LIGHT_HEADERS} ms per header; the sequential "
          f"verify_adjacent loop, cold, {seq_ms} ms = {seq_ms / LIGHT_HEADERS} "
          f"ms per header; verify_non_adjacent 1 -> {LIGHT_HEADERS + 1}, cold, "
          f"{nonadj_ms} ms; set-up {setup_s * 1e3:.0f} ms {tag}")
    lb = news[LIGHT_CHANGE_AT]
    commit = lb.signed_header.commit
    valset_ms = median_ms(lambda: lb.validator_set.hash(), 10)
    encode_ms = median_ms(lambda: [v.simple_encode() for v in lb.validator_set.validators], 10)
    header_ms = median_ms(lambda: lb.signed_header.header.hash(), 10)
    basic_ms = median_ms(lambda: lb.validate_basic(CHAIN_ID), 5)
    prep = lambda: val.prepare_commit_light(CHAIN_ID, lb.validator_set,
                                            commit.block_id, lb.height, commit)
    prepare_ms = median_ms(prep, 5)
    p = prep()

    def cache_round():
        cache.clear()
        bits, miss = sigcache.partition_misses(p.pubs, p.msgs, p.sigs)
        sigcache.writeback(p.pubs, p.msgs, p.sigs, bits, miss, [True] * len(miss))

    cache_ms = median_ms(cache_round, 5)
    pack_ms = median_ms(lambda: ov.prepare_batch(p.pubs, p.msgs, p.sigs), 5)
    arrays, _, _ = ov.prepare_batch(p.pubs, p.msgs, p.sigs)
    tg = ov.batch_to_device(arrays, dev)
    ed_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**tg), KERNEL_RUNS, 3)
    rest = per_cold - basic_ms - prepare_ms - cache_ms - pack_ms - ed_ms
    print(f"light: time: one header (height {lb.height}, {len(p.pubs)} "
          f"signatures to pass 2/3), medians of separate runs: validate_basic "
          f"{basic_ms} ms (of it the validator-set hash {valset_ms} ms: "
          f"simple_encode of {len(lb.validator_set)} validators {encode_ms} ms, "
          f"the tree plane and kernel the rest; the header hash, 14 leaves on "
          f"the host, {header_ms} ms); entries and sign bytes "
          f"(prepare_commit_light) {prepare_ms} ms; the signature cache "
          f"(partition and writeback, cold) {cache_ms} ms; Ed25519 host prep "
          f"{pack_ms} ms; Ed25519 kernel {ed_ms} ms; remainder of the cold "
          f"per-header wall {rest} ms {tag}")
    cache.clear()
    verifysched.reset_scheduler()  # drains and joins its threads
    return {
        "name": csh.NAME, "route": "cuda", "source": csh.SOURCE,
        "replaces": csh.REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def bls_tampered(commit, sign_bytes, privs):
    """A copy of ``commit`` with the signatures at BLS_BAD damaged: the
    last byte flipped at the first and the last (not a point: the
    structural filter drops them) and, at the middle one, the validator's
    signature of other bytes (a valid point: the random linear combination
    fails and every signature is verified on its own)."""
    out = tampered(commit, (BLS_BAD[0], BLS_BAD[-1]))
    mid = BLS_BAD[1]
    out.signatures[mid].signature = privs[mid].sign(sign_bytes[mid] + b"!")
    return out


def bls_lanes(native, n: int):
    """``n`` seeded G1 lanes: 96-byte pubkeys of seeded secret keys (the
    host library's ``bls_pubkey_from_sk``) and 128-bit scalars from numpy,
    the edge lanes first: the identity, the generator, one point repeated,
    scalars 0, 1 and 2^128 - 1."""
    import ctypes

    import numpy as np

    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls_g1

    rng = np.random.default_rng(BLS_SEED + 1)
    lib = native.bls()
    pubs = []
    for _ in range(n):
        sk = int.from_bytes(rng.bytes(32), "big") % (bls.R - 1) + 1
        out = ctypes.create_string_buffer(96)
        check(lib.bls_pubkey_from_sk(sk.to_bytes(32, "big"), out) == 0,
              "bls: bls_pubkey_from_sk failed")
        pubs.append(out.raw)
    ks = [int.from_bytes(rng.bytes(16), "big") for _ in range(n)]
    check(n >= 8, f"bls: {n} lanes leave no room for the edge lanes")
    pubs[:4] = [bls_g1.INFINITY, bls.g1_serialize(bls.G1_GEN), pubs[6], pubs[6]]
    ks[3:6] = [0, 1, (1 << 128) - 1]
    return pubs, ks


def bls_edge_lanes():
    """[(pubs, scalars, nbits)]: the order-3 point (0, 2) of y^2 = x^3 + 4
    and its negation (outside the subgroup: both H = 0 branches, a table
    entry at infinity) at scalars 1-7 and a 128-bit one; the identity at
    several scalars; the generator at the scalar edges of each width: 0,
    1, 2, 2^w - 1, 2^w, 2^(w-1), 2^nbits - 1 and 0x1234 at nbits 1, 7 (not
    a multiple of w), 16 (the self-check's) and 128."""
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls_g1
    from cometbft_tpu_torch.ops import cuda_bls as cb

    p = bls.P
    raw = lambda x, y: x.to_bytes(48, "big") + y.to_bytes(48, "big")
    ks = list(range(1, 8)) + [(1 << 127) | 0xF00D]
    pubs = [raw(0, 2)] * len(ks) + [raw(0, p - 2)] * len(ks) + [bls_g1.INFINITY] * 3
    out = [(pubs, ks + ks + [0, 1, (1 << 128) - 1], 128)]
    gen = bls.g1_serialize(bls.G1_GEN)
    w = cb.config()["window"]
    for nbits in (1, 7, 16, 128):
        edge = [0, 1, 2, 2 ** w - 1, 2 ** w, 2 ** (w - 1), (1 << nbits) - 1, 0x1234]
        ks = sorted({k & ((1 << nbits) - 1) for k in edge})
        out.append(([gen] * len(ks), ks, nbits))
    return out


def bls_affine_err(a, b) -> int:
    """The largest |difference| of the affine coordinates of two (n, 144)
    X || Y || Z arrays, lane by lane (0 where both are the identity; p
    where one is and the other is not): 0 when they are the same points."""
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls_g1

    err = 0
    for u, v in zip(bls_g1.affine(a), bls_g1.affine(b)):
        if (u is None) != (v is None):
            err = max(err, bls.P)
        elif u is not None:
            err = max(err, abs(u[0] - v[0]), abs(u[1] - v[1]))
    return err


def bls_launcher(torch, build, what: str):
    """A G1 kernel being built by ``build`` (start_nvcc, start_parent) as a
    function of the device inputs (pts, scalars) returning (n, 144) uint8;
    raises if its build or a launch failed.  Returns (function, ptxas
    lines, its occupancy query or None)."""
    import ctypes

    proc, lib, _ = build
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"bls: {what} did not build:\n{log}")
    so = ctypes.CDLL(lib)
    fn = so.bls_g1_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(pts, sc, nbits=128):
        out = torch.empty((pts.shape[0], 144), dtype=torch.uint8, device=pts.device)
        rc = fn(pts.data_ptr(), sc.data_ptr(), out.data_ptr(), pts.shape[0],
                nbits, torch.cuda.current_stream(pts.device).cuda_stream)
        check(rc == 0, f"bls: {what}: CUDA error {rc}")
        return out

    occ = None
    if hasattr(so, "bls_g1_config"):  # this source: its G and occupancy too
        def occ():
            q = so.bls_g1_occupancy
            q.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
            vals = [ctypes.c_int() for _ in range(5)]
            check(q(*map(ctypes.byref, vals)) == 0, f"bls: {what}: occupancy")
            keys = ("blocks_per_sm", "threads", "regs", "local_bytes", "shared_bytes")
            out = dict(zip(keys, (v.value for v in vals)))
            cfg = [ctypes.c_int() for _ in range(4)]
            so.bls_g1_config(*map(ctypes.byref, cfg))
            out["threads_per_lane"] = cfg[0].value
            return out
    return run, ptxas_lines(log), occ


def bls_phase(torch, dev, cbatch, val, ds, sigcache, sms, max_clock_mhz,
              tag) -> dict:
    """Phase 13: BLS12-381 commit verification (BASELINE config 5) through
    the hand-written G1 scalar-multiplication kernel and the host library.
    Returns its entry of the kernels line."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_bls as cb

    # BLS_PARENT's kernel and this source at each G of BLS_GROUPS, built
    # while the keys are made
    src = (_build.CSRC_DIR / "bls_g1.cu").read_bytes()
    builds = {"parent": start_parent(_build, "COMETBFT_TPU_BLS_PARENT_SRC",
                                     BLS_PARENT, cb.SOURCE)}
    builds.update({g: start_nvcc(_build, src, "bls_g1", f"-DBLS_GROUP={g}")
                   for g in BLS_GROUPS})
    try:
        return bls_checks(torch, dev, cbatch, val, ds, sigcache, sms,
                          max_clock_mhz, tag, builds)
    finally:
        for build in builds.values():
            stop_build(build)


def bls_field_check(torch, dev, cb) -> str:
    """The kernel's field operations on the card (``cuda_bls.fe_op_cuda``,
    the PTX carry chains) against Python integers at the extreme operands
    of ``cuda_bls.FE_EDGES``: results below their bound and equal mod p."""
    import random

    import numpy as np

    from cometbft_tpu_torch.crypto import bls12381 as bls

    p, rng, n = bls.P, random.Random(BLS_SEED + 3), 0

    def words(vals):
        w = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
                      for v in vals], np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    for name, (code, want, top_out, top_in) in cb.FE_OPS.items():
        xs = list(cb.FE_EDGES) + list(cb.FE_RAW_EDGES if top_in > 2 * p else ())
        xs += [rng.randrange(top_in) for _ in range(64 - len(xs))]
        ys = list(cb.FE_EDGES[::-1])
        ys += [rng.randrange(2 * p) for _ in range(64 - len(ys))]
        a, b = words(xs), words(ys)
        got = cb.fe_op_cuda(code, a, b).cpu().numpy().view(np.uint32)
        got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in got]
        if name == "is_zero":
            ok = got == [want(x, 0) for x in xs]
        else:
            ok = all(g < top_out and g % p == want(x, y)
                     for g, x, y in zip(got, xs, ys))
        check(ok, f"bls: the card's field op '{name}' disagrees with the ints")
        n += len(xs)
    return f"{len(cb.FE_OPS)} operations, {n} operand pairs"


def bls_checks(torch, dev, cbatch, val, ds, sigcache, sms, max_clock_mhz,
               tag, builds) -> dict:
    import ctypes
    import secrets

    import numpy as np

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.crypto.keys import Bls12381PrivKey
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import bls_g1
    from cometbft_tpu_torch.ops import cuda_bls as cb

    lib = native.bls()
    group = cb.THREADS_PER_LANE

    # the kernel against its plain version (as points), the host library,
    # the oracle and Python integers
    t0 = time.perf_counter()
    pubs, ks = bls_lanes(native, BLS_LANES)
    lanes_s = time.perf_counter() - t0

    def inputs(pubs, ks, nbits=128):
        pts = np.frombuffer(b"".join(pubs), np.uint8).reshape(len(pubs), 96)
        return (torch.from_numpy(pts.copy()).to(dev),
                torch.from_numpy(bls_g1.scalars_to_bytes(ks, nbits).copy()).to(dev))

    def same(a, b) -> bool:
        return bool(bls_g1.points_equal(a.cpu().numpy(), b.cpu().numpy()).all())

    field = bls_field_check(torch, dev, cb)
    pts, sc = inputs(pubs, ks)
    kern = cb.scalar_mul_cuda(pts, sc)
    torch.cuda.synchronize()
    plain = bls_g1.batch_scalar_mul_plain(pts, sc)
    torch.cuda.synchronize()
    kern_np, plain_np = kern.cpu().numpy(), plain.cpu().numpy()
    eq = bls_g1.points_equal(kern_np, plain_np)
    check(eq.all(), f"bls: kernel != plain (as points) on {int((~eq).sum())} of "
          f"{BLS_LANES} lanes")
    block = cb.config()["lanes_per_block"]
    small_n = sorted({1, max(1, group - 1), group, group + 1, block - 1, block,
                      block + 1, *BLS_SMALL_N})
    for k in small_n:
        kb = cb.scalar_mul_cuda(pts[:k].contiguous(), sc[:k].contiguous())
        check((kb == kern[:k]).all() and
              same(kb, bls_g1.batch_scalar_mul_plain(pts[:k], sc[:k])),
              f"bls: n={k}: kernel != plain")
    edges = 0
    for epubs, eks, nbits in bls_edge_lanes():
        ep, es = inputs(epubs, eks, nbits)
        kb = cb.scalar_mul_cuda(ep, es, nbits)
        check(same(kb, bls_g1.batch_scalar_mul_plain(ep, es, nbits)),
              f"bls: edge lanes at {nbits} bits: kernel != plain")
        want = []
        for pb, k in zip(epubs, eks):
            if pb == bls_g1.INFINITY:
                want.append(None)
                continue
            xy = (int.from_bytes(pb[:48], "big") & ((1 << 381) - 1),
                  int.from_bytes(pb[48:], "big"))
            want.append(bls.E1.affine(bls.E1.mul_scalar((*xy, 1), k)))
        check(bls_g1.affine(kb.cpu().numpy()) == want,
              f"bls: edge lanes at {nbits} bits: kernel != the oracle")
        edges += len(eks)
    rng = np.random.default_rng(BLS_SEED + 2)
    sample = list(range(8)) + sorted(
        rng.choice(range(8, BLS_LANES), BLS_SAMPLE - 8, replace=False).tolist())
    got = bls_g1.affine(kern_np[sample])
    for i, g in zip(sample, got):
        out = ctypes.create_string_buffer(96)
        check(lib.bls_g1_scalar_mul(pubs[i], ks[i].to_bytes(16, "big"), 16, out) == 0,
              f"bls: bls_g1_scalar_mul failed on lane {i}")
        want = (bls_g1.INFINITY if g is None else
                g[0].to_bytes(48, "big") + g[1].to_bytes(48, "big"))
        check(out.raw == want, f"bls: lane {i}: kernel != host library")
    check(got[0] is None and got[3] is None and got[4] is not None,
          "bls: the identity and scalar 0 lanes are not the identity")
    check(got[4] == bls.E1.affine(bls.g1_deserialize(pubs[4])),
          "bls: scalar 1 does not give the point back")
    gen = bls.E1.affine(bls.G1_GEN)
    known = bls_g1.batch_scalar_mul([gen], [0x1234], nbits=16, device=dev)
    check(known == [bls.E1.affine(bls.E1.mul_scalar(bls.G1_GEN, 0x1234))],
          "bls: G * 0x1234 at 16 bits")
    print(f"bls: kernel: {BLS_LANES} seeded lanes (pubkeys of the host "
          f"library, {lanes_s:.2f} s; the identity, the generator, a repeated "
          f"point, scalars 0, 1 and 2^128 - 1 among them) == plain version as "
          f"points (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1, Z = 0 matched; affine "
          f"max_abs_err {bls_affine_err(kern_np, plain_np)}); n = "
          f"{', '.join(map(str, small_n))} == plain; {edges} edge lanes (the "
          f"order-3 point (0, 2) and its negation at scalars 1-7 and a 128-bit "
          f"one, the identity, the generator at the scalar edges of 1, 7, 16 "
          f"and 128 bits) == plain == the oracle; {BLS_SAMPLE}-lane sample == "
          f"the host library's bls_g1_scalar_mul; G * 0x1234 at 16 bits == the "
          f"oracle; field ops on the card == Python ints at the extreme "
          f"operands ({field})")

    # the commit through the entry points
    t0 = time.perf_counter()
    vals, commit, block_id, sign_bytes = make_commit(
        BLS_VALIDATORS, Bls12381PrivKey.from_secret, BLS_SEED)
    setup_s = time.perf_counter() - t0
    seeds = np.random.default_rng(BLS_SEED)  # make_commit's keys, again
    keys = [Bls12381PrivKey.from_secret(seeds.bytes(32))
            for _ in range(BLS_VALIDATORS)]
    by_addr = {k.pub_key().address(): k for k in keys}
    privs = [by_addr[v.address] for v in vals.validators]
    bad_commit = bls_tampered(commit, sign_bytes, privs)
    vpubs = [v.pub_key.bytes() for v in vals.validators]
    vsigs = [c.signature for c in commit.signatures]
    cache = sigcache.get_cache()
    full = lambda: val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    light = lambda: val.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT, commit)

    def cold_ms(fn) -> float:
        cache.clear()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    check(isinstance(cbatch.create_batch_verifier(vals.validators[0].pub_key),
                     cbatch.BlsBatchVerifier),
          "bls: the default verifier is not the BLS one")
    tiers0 = ds.tier_counts("bls12_381")
    cb.reset_launches()
    commit_samples = [cold_ms(full) for _ in range(BLS_COLD_RUNS)]
    before = cb.launches
    t0 = time.perf_counter()
    full()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(cb.launches == before, f"bls: warm commit made {cb.launches - before} launches")
    light_samples = [cold_ms(light) for _ in range(BLS_COLD_RUNS)]
    cache.clear()
    t0 = time.perf_counter()
    try:
        val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, bad_commit)
    except val.InvalidSignatureError as e:
        check(e.index == BLS_BAD[0], f"bls: InvalidSignatureError({e.index})")
    else:
        raise SmokeError("bls: a commit with bad signatures verified")
    bad_ms = (time.perf_counter() - t0) * 1e3
    misses, before = cache.stats()["misses"], cb.launches
    full()
    check(cache.stats()["misses"] - misses == len(BLS_BAD) and
          cb.launches - before == 1,
          "bls: the bad commit's verdicts changed how the good commit verified")
    cache.clear()
    bv = cbatch.create_batch_verifier(vals.validators[0].pub_key)
    for v, sb, c in zip(vals.validators, sign_bytes, bad_commit.signatures):
        bv.add(v.pub_key, sb, c.signature)
    ok, bad_bits = bv.verify()
    false_at = [i for i, b in enumerate(bad_bits) if not b]
    check(not ok and false_at == list(BLS_BAD), f"bls: false bits at {false_at}")
    launches = cb.launches
    check(launches == BLS_LAUNCHES, f"bls: {launches} kernel launches, want "
          f"{BLS_LAUNCHES}")
    tiers = {k: (v[0] - tiers0[k][0], v[1] - tiers0[k][1])
             for k, v in ds.tier_counts("bls12_381").items()}
    check(tiers["torch"] == (0, 0) and tiers["host"] == (0, 0) and
          tiers["cuda"][0] == BLS_LAUNCHES - 1,
          f"bls: G1 calls served below the cuda tier or missing: {tiers}")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    check(not leaked, f"bls: imported {leaked}")
    print(f"bls: slice: {BLS_VALIDATORS}-validator BLS12-381 commit "
          f"(keys and signatures in {setup_s:.2f} s, data set-up): "
          f"verify_commit and verify_commit_light passed on the BLS verifier, "
          f"{BLS_COLD_RUNS} cold samples each (signature cache cleared before "
          f"each); a warm verify_commit made 0 launches; bad indices "
          f"{list(BLS_BAD)} ({BLS_BAD[1]} a valid point over other bytes) -> "
          f"InvalidSignatureError({BLS_BAD[0]}) in {bad_ms:.1f} ms (the "
          f"combination fails, each signature verified on its own); the good "
          f"commit after it passed with {len(BLS_BAD)} misses and 1 launch; "
          f"batch-verifier bits false exactly at {list(BLS_BAD)}; {launches} "
          f"G1 launches (self-check 1, one per cold batch); jax not imported; "
          f"G1 calls served by tier (calls, keys): {tiers}")

    # the kernel at the main path's widths (the commit's keys, fresh r_i:
    # the whole commit and verify_commit_light's lanes), held to its plain
    # version as points before it is timed there and at 10,240 lanes
    rs = [secrets.randbits(128) | 1 for _ in vpubs]
    cp, ck = inputs(vpubs, rs)
    light_n = len(val._collect_entries(vals, commit,
                                       vals.total_voting_power() * 2 // 3,
                                       False, False)[0])
    errs = {}
    for n in (BLS_VALIDATORS, light_n):
        kb = cb.scalar_mul_cuda(cp[:n].contiguous(), ck[:n].contiguous())
        pb = bls_g1.batch_scalar_mul_plain(cp[:n], ck[:n])
        torch.cuda.synchronize()
        kb, pb = kb.cpu().numpy(), pb.cpu().numpy()
        eq = bls_g1.points_equal(kb, pb)
        errs[n] = bls_affine_err(kb, pb)
        check(eq.all() and errs[n] == 0, f"bls: kernel != plain on "
              f"{int((~eq).sum())} of the main path's {n} lanes")
    print(f"bls: kernel at the main path's widths: the commit's {BLS_VALIDATORS} "
          f"keys and fresh 128-bit r_i, and the first {light_n} of them "
          f"(verify_commit_light's lanes), == plain version as points "
          f"(affine max_abs_err {errs})")
    per, dep = {}, cb.MUL_ROUNDS_PER_LANE[group]
    for n, (p, k), scal in ((BLS_VALIDATORS, (cp, ck), rs),
                            (BLS_LANES, (pts, sc), ks)):
        ms = cuda_ms(torch, lambda: cb.scalar_mul_cuda(p, k), KERNEL_RUNS, 3)
        plain_ms = cuda_ms(torch, lambda: bls_g1.batch_scalar_mul_plain(p, k), 1, 0)
        muls, squares, products = cb.needed_work(scal)
        bound_ms, bound_by = bound(products, n * cb.BYTES_PER_LANE, sms,
                                   max_clock_mhz)
        own = n * cb.WIDE_PRODUCTS_PER_LANE
        tally_ms, _ = bound(own, n * cb.BYTES_PER_LANE, sms, max_clock_mhz)
        per[n] = (ms, plain_ms, bound_ms, bound_by)
        print(f"bls: time: kernel {ms} ms at {n} lanes (median of {KERNEL_RUNS} "
              f"samples of one call, CUDA events) = {n / ms * 1e3:.0f} scalar "
              f"multiplications/s; plain PyTorch version {plain_ms} ms; bound "
              f"{bound_ms} ms by {bound_by} ({products} 32x32->64-bit products "
              f"that these {n} 128-bit scalar multiplications need: {muls} "
              f"multiplies, {squares} squares, the cheapest width-w NAF ladder "
              f"per scalar in Jacobian coordinates over a one-Z table), "
              f"kernel at {bound_ms / ms:.2%} of it; the kernel's own tally "
              f"for {n} full lanes {own} products ({own / products:.3f}x; "
              f"{cb.WIDE_PRODUCTS_PER_LANE} a lane), {tally_ms} ms at "
              f"the same rates, kernel at {tally_ms / ms:.2%} of that {tag}")
    ms256 = per[BLS_VALIDATORS][0]
    deps = {g: cb.MUL_ROUNDS_PER_LANE[g] for g in BLS_GROUPS}
    print(f"bls: critical path: {dep} dependent field multiplies per full "
          f"lane at G = {group} (the schedule's multiply levels, ceil(n / G) "
          f"each; {', '.join(f'G = {g}: {d}' for g, d in deps.items())}) "
          f"and {cb.ADD_ROUNDS_PER_LANE[group]} addition levels: "
          f"{ms256 / dep * 1e3:.4f} us per dependent multiply at "
          f"{BLS_VALIDATORS} lanes, the latency floor the throughput bound "
          f"does not see {tag}")
    print("bls: library_ms is null: no PyTorch library call computes a "
          "BLS12-381 G1 scalar multiplication")

    # BLS_PARENT's kernel, then this source at each G, in turns
    def in_turns(fns, order, n, p, k):
        turns = [(o, cuda_ms(torch, lambda: fns[o](p, k), BLS_AB_RUNS, 1))
                 for o in order]
        med = {o: statistics.median(v for j, v in turns if j == o) for o in fns}
        return med, ", ".join(f"{o} {v}" for o, v in turns)

    sizes = ((BLS_VALIDATORS, cp, ck), (BLS_LANES, pts, sc))
    if builds["parent"][0] is None:
        print(f"bls: parent: not measured: {builds['parent'][1]}")
    else:
        run_parent, ptxas, _ = bls_launcher(torch, builds["parent"],
                                            f"the kernel of {BLS_PARENT}")
        for n, p, k in sizes:
            check(same(run_parent(p, k), cb.scalar_mul_cuda(p, k)),
                  f"bls: the parent's kernel disagrees with this one at {n} lanes")
        for n, p, k in sizes:
            fns = {"parent": run_parent, "new": cb.scalar_mul_cuda}
            med, turns = in_turns(fns, ("parent", "new", "new", "parent"), n, p, k)
            print(f"bls: parent: the kernel of {BLS_PARENT} (one thread per "
                  f"lane, RCB15's complete formulas, fully reduced C++ field; "
                  f"{'; '.join(ptxas)}) == this one as points; in turns at {n} "
                  f"lanes (median of {BLS_AB_RUNS} one-call samples each): "
                  f"{turns} ms; parent {med['parent']} ms, this kernel "
                  f"{med['new']} ms, {med['parent'] / med['new']:.3f}x {tag}")
    runs, per_g = {}, {}
    for g in BLS_GROUPS:
        run, ptxas, occ = bls_launcher(torch, builds[g], f"G = {g}")
        check(occ is not None, f"bls: G = {g}: no occupancy query in the build")
        o = occ()
        check(o["local_bytes"] == 0 and o["threads_per_lane"] == g,
              f"bls: G = {g}: {o['local_bytes']} local bytes, "
              f"{o['threads_per_lane']} threads per lane")
        print(f"bls: groups: G = {g}: {'; '.join(ptxas)}; {o['threads']} "
              f"threads per block, {o['blocks_per_sm']} blocks per SM")
        runs[f"G={g}"] = run
        per_g[f"G={g}"] = deps[g]
    for n, p, k in sizes:
        for name, run in runs.items():
            check(same(run(p, k), kern[:n] if n == BLS_LANES else
                       cb.scalar_mul_cuda(p, k)),
                  f"bls: {name} disagrees with the package's kernel at {n} lanes")
        order = list(runs) + list(runs)[::-1]
        med, turns = in_turns(runs, order, n, p, k)
        print(f"bls: groups: in turns at {n} lanes (medians of {BLS_AB_RUNS} "
              f"one-call samples a turn; turns {turns}): " + ", ".join(
                  f"{name} {v} ms ({v / per_g[name] * 1e3:.4f} us per dependent "
                  f"multiply)" for name, v in med.items())
              + f"; the package builds G = {group} {tag}")

    occ = cb.occupancy()
    log = _build.build_log(cb.NAME)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    check(spills and not any(int(a) or int(b) for a, b in spills),
          f"bls: the G1 kernel spills: {ptxas_lines(log)}")
    check(occ["local_bytes"] == 0, f"bls: {occ['local_bytes']} local bytes")
    for n in (BLS_VALIDATORS, BLS_LANES):
        grid = -(-n // occ["lanes_per_block"])
        waves = -(-grid // max(1, occ["blocks_per_sm"] * sms))
        print(f"occupancy: {cb.NAME}: {occ['threads_per_lane']} threads per "
              f"lane, {occ['lanes_per_block']} lanes and {occ['threads']} "
              f"threads per block, {occ['regs']} registers and "
              f"{occ['local_bytes']} bytes of local memory per thread (spill "
              f"stores, loads: {spills}), {occ['shared_bytes']} bytes of shared "
              f"memory per block; {occ['blocks_per_sm']} blocks resident per "
              f"SM; {n} lanes -> {grid} blocks, {min(grid, sms)} of {sms} SMs "
              f"with work, {waves} wave(s) {tag}")
    check(waves == 1, f"bls: {BLS_LANES} lanes take {waves} waves")
    ops = sass_ops(_build.lib_path(cb.NAME), "bls_g1_kernel")
    mix = dict(collections.Counter(ops))
    total = sum(mix.values())
    wide = sum(v for k, v in mix.items() if k.startswith("IMAD.WIDE"))
    check(wide > 0, "bls: cuobjdump showed no wide multiply in bls_g1_kernel")
    top = sorted(mix.items(), key=lambda kv: -kv[1])[:10]
    body = mul_body(ops)
    body_mix = collections.Counter(o.split(".")[0] for o in body)
    print(f"bls: sass: bls_g1_kernel {total} instructions of machine code, "
          f"{wide} IMAD.WIDE (one 32x32->64-bit product each; a field "
          f"multiply issues {cb.PRODUCTS_PER_MUL - 12} of them, and an IMAD for "
          f"each of its 12 m_i): {total / wide:.2f} instructions per product "
          f"over the whole kernel; the field multiply's body (its first "
          f"IMAD.WIDE to its last, the longest run of them with gaps under "
          f"{MUL_BODY_GAP} instructions) {len(body)} instructions with "
          f"{sum(o.startswith('IMAD.WIDE') for o in body)} IMAD.WIDE: "
          f"{len(body) / cb.PRODUCTS_PER_MUL:.3f} SASS instructions per 32x32 "
          f"product ({cb.PRODUCTS_PER_MUL} a multiply), "
          f"{body_mix.most_common(6)}; most common in the kernel {top} {tag}")

    # the cold commit's wall and its host parts
    rb = [r.to_bytes(16, "big") for r in rs]

    def validation():
        for p, g in zip(vpubs, vsigs):
            lib.bls_pubkey_validate(p, 96)
            lib.bls_sig_validate(g)

    def hashes():
        out = ctypes.create_string_buffer(96)
        for m in sign_bytes:
            lib.bls_hash_to_g2(m, len(m), out)

    def g2_scaling():
        out = ctypes.create_string_buffer(96)
        for g, r in zip(vsigs, rb):
            lib.bls_g2_scalar_mul_compressed(g, r, 16, out)

    # the random linear combination of the commit by hand: the kernel's
    # -(r_i * pk_i), the host library's H(m_i) and sum r_i * S_i
    g1_parts = bls_g1.neg_scaled_pubkeys(vpubs, rs, dev)
    hs, scaled = [], []
    for m, g, r in zip(sign_bytes, vsigs, rb):
        h, s2 = ctypes.create_string_buffer(96), ctypes.create_string_buffer(96)
        check(lib.bls_hash_to_g2(m, len(m), h) == 0 and
              lib.bls_g2_scalar_mul_compressed(g, r, 16, s2) == 0,
              "bls: host library G2 op failed")
        hs.append(h.raw)
        scaled.append(s2.raw)
    agg = ctypes.create_string_buffer(96)
    check(lib.bls_aggregate_sigs(b"".join(scaled), len(scaled), agg) == 0,
          "bls: bls_aggregate_sigs failed")
    g1cat = b"".join(g1_parts) + bls.g1_serialize(bls.G1_GEN)
    g2cat = b"".join(hs) + agg.raw
    n_pairs = len(vpubs) + 1

    def pairing():
        return lib.bls_pairing_product_is_one_serialized(g1cat, g2cat, n_pairs)

    check(pairing() == 1, "bls: the product over the kernel's G1 points is not 1")

    parts = {
        "validation (KeyValidate, SigValidate)": median_ms(validation, BLS_HOST_RUNS),
        "hash_to_g2": median_ms(hashes, BLS_HOST_RUNS),
        "G2 scaling r_i * S_i": median_ms(g2_scaling, BLS_HOST_RUNS),
        f"pairing product ({n_pairs} pairs)": median_ms(pairing, BLS_HOST_RUNS),
        "G1 call (neg_scaled_pubkeys: packing, one launch, affine)": median_ms(
            lambda: bls_g1.neg_scaled_pubkeys(vpubs, rs, dev), BLS_HOST_RUNS),
    }
    commit_ms = statistics.median(commit_samples)
    rest_ms = commit_ms - sum(parts.values())
    cache.clear()
    by_cum, by_own = top_host_functions(full)
    print(f"bls: time: verify_commit cold wall {commit_ms} ms (median of "
          f"{BLS_COLD_RUNS}; all {commit_samples}; the first with the "
          f"self-check) = {BLS_VALIDATORS / commit_ms * 1e3:.0f} verifies/s; "
          f"warm (0 launches) {warm_ms} ms; verify_commit_light cold wall "
          f"{statistics.median(light_samples)} ms (all {light_samples}); the bad "
          f"commit (attribution) {bad_ms} ms {tag}")
    print(f"bls: time: host parts of a cold commit, medians of "
          f"{BLS_HOST_RUNS} (ms): " + "; ".join(
              f"{k} {v}" for k, v in parts.items())
          + f"; remainder of the wall {rest_ms} ms {tag}")
    print(f"bls: time: cProfile of one cold verify_commit, top 5 by cumulative "
          f"ms: {by_cum}")
    print(f"bls: time: cProfile of the same run, top 5 by own ms: {by_own}")
    ms, plain_ms, bound_ms, bound_by = per[BLS_VALIDATORS]
    return {
        "name": cb.NAME, "route": "cuda", "source": cb.SOURCE,
        "replaces": cb.REPLACES, "launches": launches,
        "max_abs_err": errs[BLS_VALIDATORS], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def aead_mixed_frames(rng, lanes: int):
    """``lanes`` frames with the lengths of AEAD_EDGE_LENS first, the rest
    random in [0, 2,048], each with its own key and nonce."""
    lens = list(AEAD_EDGE_LENS) + rng.integers(0, 2049, lanes - len(AEAD_EDGE_LENS)).tolist()
    return [(rng.bytes(32), rng.bytes(12), rng.bytes(int(n))) for n in lens]


def transport_vectors():
    """(scalar, u, want) of RFC 7748 5.2 and 6.1, u with bit 255 set, u >= p
    and the low-order points 0 and 1 (the ladder gives 0 for them)."""
    p = 2**255 - 19
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b_pub = bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    rfc = [
        ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
         "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
         "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
        ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
         "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
         "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
        (a.hex(), (9).to_bytes(32, "little").hex(),
         "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"),
        (a.hex(), b_pub.hex(),
         "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"),
    ]
    out = [tuple(bytes.fromhex(x) for x in v) for v in rfc]
    for u in (2**255 + 12345, p + 7, 2**255 - 1, 0, 1):
        want = None if u > 1 else bytes(32)
        out.append((hashlib.sha256(b"edge-%d" % u).digest(),
                    u.to_bytes(32, "little"), want))
    return out


@contextlib.contextmanager
def keeping_inputs(mod, name: str, key):
    """While the block runs, ``mod.name`` keeps a clone of the first
    arguments of each shape ``key(args, kwargs)`` in the dict it yields,
    then calls the wrapper it replaced, which launches and counts as
    before."""
    fn, kept = getattr(mod, name), {}

    def keep(*args, **kwargs):
        k = key(args, kwargs)
        if k not in kept:
            kept[k] = ([a.clone() for a in args], kwargs)
        return fn(*args, **kwargs)

    setattr(mod, name, keep)
    try:
        yield kept
    finally:
        setattr(mod, name, fn)


def transport_launcher(torch, build, what: str, kind: str):
    """A transport kernel being built by ``build`` (start_nvcc,
    start_parent) as a function of the wrapper's device inputs: ``kind``
    "aead" (key, nonce, data, nbytes, seal) -> (out, tag), "ladder"
    (scalars, us) -> out; raises if its build or a launch failed.  Returns
    (function, ptxas lines, its occupancy)."""
    import ctypes

    proc, lib, _ = build
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"transport: {what} did not build:\n{log}")
    so = ctypes.CDLL(lib)
    if kind == "aead":
        fn = so.chacha20_poly1305_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

        def run(key, nonce, data, nbytes, seal):
            out = torch.empty_like(data)
            tg = torch.empty((data.shape[1], 4), dtype=torch.int32, device=data.device)
            rc = fn(key.data_ptr(), nonce.data_ptr(), data.data_ptr(),
                    nbytes.data_ptr(), data.shape[0], data.shape[1], int(seal),
                    out.data_ptr(), tg.data_ptr(),
                    torch.cuda.current_stream(data.device).cuda_stream)
            check(rc == 0, f"transport: {what}: CUDA error {rc}")
            return out, tg
    else:
        fn = so.x25519_ladder_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]

        def run(scalars, us):
            out = torch.empty_like(scalars)
            rc = fn(scalars.data_ptr(), us.data_ptr(), scalars.shape[0],
                    out.data_ptr(), torch.cuda.current_stream(scalars.device).cuda_stream)
            check(rc == 0, f"transport: {what}: CUDA error {rc}")
            return out
    fn.restype = ctypes.c_int
    q = getattr(so, "chacha20_poly1305_occupancy" if kind == "aead"
                else "x25519_ladder_occupancy")
    q.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    vals = [ctypes.c_int() for _ in range(5)]
    check(q(*map(ctypes.byref, vals)) == 0, f"transport: {what}: occupancy")
    keys = ("blocks_per_sm", "threads", "regs", "local_bytes", "shared_bytes")
    return run, ptxas_lines(log), dict(zip(keys, (v.value for v in vals)))


def transport_phase(torch, dev, cbatch, ds, sms, max_clock_mhz, tag):
    """Phase 14: the encrypted transport plane at CometBFT's defaults:
    SecretConnection frames through the ChaCha20-Poly1305 kernel, dials
    through the X25519 ladder kernel.  Returns the two kernels' entries of
    the kernels line."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_aead
    from cometbft_tpu_torch.ops import cuda_x25519

    # TRANSPORT_PARENT's two kernels (its ladder includes its own
    # fe25519.cuh) and this source at each block shape, built while the
    # phase checks and drives the path
    aead_src = (_build.CSRC_DIR / "chacha20_poly1305.cu").read_bytes()
    ladder_src = (_build.CSRC_DIR / "x25519_ladder.cu").read_bytes()
    builds = {
        ("aead", "parent"): start_parent(
            _build, "COMETBFT_TPU_AEAD_PARENT_SRC", TRANSPORT_PARENT, cuda_aead.SOURCE),
        ("ladder", "parent"): start_parent(
            _build, "COMETBFT_TPU_LADDER_PARENT_SRC", TRANSPORT_PARENT,
            cuda_x25519.SOURCE, headers=("cometbft_tpu_torch/csrc/fe25519.cuh",)),
    }
    builds.update({("aead", f): start_nvcc(_build, aead_src, "chacha20_poly1305",
                                           f"-DAEAD_FRAMES={f}")
                   for f in AEAD_FRAME_CHOICES})
    builds.update({("aead", f"stage {k}"): start_nvcc(
        _build, aead_src, "chacha20_poly1305", f"-DAEAD_STAGE={k}") for k in (0, 1, 2)})
    builds.update({("ladder", t): start_nvcc(_build, ladder_src, "x25519_ladder",
                                             f"-DX25519_THREADS={t}",
                                             f"-I{_build.CSRC_DIR}")
                   for t in LADDER_THREAD_CHOICES})
    try:
        return transport_checks(torch, dev, cbatch, ds, sms, max_clock_mhz, tag,
                                builds)
    finally:
        for build in builds.values():
            stop_build(build)


def transport_checks(torch, dev, cbatch, ds, sms, max_clock_mhz, tag, builds):
    """Phase 14's checks, path and times, with the parent and block-shape
    builds ``builds`` of transport_phase."""
    import numpy as np

    from cometbft_tpu_torch.crypto import aead_ref
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import cuda_aead
    from cometbft_tpu_torch.ops import cuda_x25519
    from cometbft_tpu_torch.ops import x25519_ladder as xl

    t_phase = time.perf_counter()
    rng = np.random.default_rng(TRANSPORT_SEED)

    # -- 1. the kernels against their plain versions and the reference
    frames = aead_mixed_frames(rng, AEAD_LANES)
    lanes, blocks = ca._bucket_shape(frames)
    check(lanes == AEAD_LANES, f"transport: AEAD bucket {lanes}x{blocks}")
    packed = [torch.from_numpy(a).to(dev) for a in ca._pack_frames(frames, lanes, blocks)]
    sealed_out, sealed_tag = cuda_aead.aead(*packed, seal=True)
    plain = ca.aead_core(*packed, seal=True)
    torch.cuda.synchronize()
    aead_err = max(int((sealed_out.long() - plain[0].long()).abs().max()),
                   int((sealed_tag.long() - plain[1].long()).abs().max()))
    check(torch.equal(sealed_out, plain[0]) and torch.equal(sealed_tag, plain[1]),
          "transport: AEAD kernel != plain version (seal)")
    sealed = ca._unpack_outputs(sealed_out.cpu().numpy(), sealed_tag.cpu().numpy(), frames)
    # open: every frame's ciphertext, some tampered in a byte, against the
    # received tags, some tampered: a frame authenticates iff the kernel's
    # tag equals the received one
    bad_ct = {i for i in range(3, lanes, 97) if frames[i][2]}
    bad_tag = set(range(5, lanes, 89)) - bad_ct
    opened_in, tags_in = [], []
    for i, ((key, nonce, _), (ct, tg)) in enumerate(zip(frames, sealed)):
        if i in bad_ct:
            ct = bytes([ct[0] ^ 0x20]) + ct[1:]
        if i in bad_tag:
            tg = tg[:-1] + bytes([tg[-1] ^ 1])
        opened_in.append((key, nonce, ct))
        tags_in.append(tg)
    packed_o = [torch.from_numpy(a).to(dev)
                for a in ca._pack_frames(opened_in, lanes, blocks)]
    open_out, open_tag = cuda_aead.aead(*packed_o, seal=False)
    plain = ca.aead_core(*packed_o, seal=False)
    torch.cuda.synchronize()
    aead_err = max(aead_err, int((open_out.long() - plain[0].long()).abs().max()),
                   int((open_tag.long() - plain[1].long()).abs().max()))
    check(torch.equal(open_out, plain[0]) and torch.equal(open_tag, plain[1]),
          "transport: AEAD kernel != plain version (open)")
    opened = ca._unpack_outputs(open_out.cpu().numpy(), open_tag.cpu().numpy(), opened_in)
    for i, ((_, _, data), (pt, tg)) in enumerate(zip(frames, opened)):
        accept = tg == tags_in[i]
        check(accept == (i not in bad_ct and i not in bad_tag)
              and (not accept or pt == data), f"transport: AEAD open verdict of lane {i}")
    sample = sorted(rng.choice(lanes, AEAD_SAMPLE, replace=False).tolist())
    for op, fs, got in (("seal", frames, sealed), ("open", opened_in, opened)):
        ref = ca._host_pass(op, [fs[i] for i in sample])
        check([got[i] for i in sample] == ref, f"transport: AEAD {op} != aead_ref")
    print(f"transport: AEAD kernel == plain version bit for bit at {lanes} lanes "
          f"x {blocks} blocks (lengths {list(AEAD_EDGE_LENS)} and random in "
          f"[0, 2048]), seal and open; {len(bad_ct)} tampered ciphertexts and "
          f"{len(bad_tag)} tampered tags rejected, the rest accepted (max_abs_err {aead_err}); {AEAD_SAMPLE}-lane sample "
          f"== aead_ref, seal and open")

    vecs = transport_vectors()
    pairs = [(s, u) for s, u, _ in vecs]
    pairs += [(rng.bytes(32), rng.bytes(32)) for _ in range(LADDER_LANES - len(pairs))]
    scalars, us = (torch.from_numpy(a).to(dev) for a in xl._pack_pairs(pairs, LADDER_LANES))
    kout = cuda_x25519.ladder(scalars, us)
    pout = xl.ladder_plain(scalars, us)
    torch.cuda.synchronize()
    ladder_err = int((kout.long() - pout.long()).abs().max())
    check(torch.equal(kout, pout), "transport: ladder kernel != plain version")
    got = kout.cpu().numpy()
    for i, (s, u, want) in enumerate(vecs):
        ref = aead_ref.x25519(s, u)
        check(got[i].tobytes() == ref and (want is None or ref == want),
              f"transport: ladder vector {i}")
    rest = range(len(vecs), LADDER_LANES)
    for i in rng.choice(rest, min(32, len(rest)), replace=False).tolist():
        check(got[i].tobytes() == aead_ref.x25519(*pairs[i]), f"transport: ladder lane {i}")
    for k in LADDER_SMALL_N:
        sub = cuda_x25519.ladder(scalars[:k].contiguous(), us[:k].contiguous())
        check(torch.equal(sub, pout[:k]), f"transport: ladder n={k}")
    torch.cuda.synchronize()
    print(f"transport: ladder kernel == plain version at {LADDER_LANES} lanes and "
          f"n = {', '.join(map(str, LADDER_SMALL_N))} (max_abs_err {ladder_err}); "
          f"the RFC 7748 5.2 and 6.1 vectors, u with bit 255 set, u >= p and the "
          f"low-order points 0 and 1 (zero out) and 32 random lanes == aead_ref")

    # -- 2. the path: 50 peers' handshakes and a 4 MiB block to each, the
    # kernels' first inputs of each shape kept for the checks below
    with keeping_inputs(cuda_aead, "aead", lambda a, kw: (
            "seal" if kw["seal"] else "open", a[2].shape[1], a[2].shape[0])) as kept_aead, \
            keeping_inputs(cuda_x25519, "ladder", lambda a, kw: a[0].shape[0]) as kept_ladder:
        path = transport_path(torch, cbatch, ds)

    # -- the kernels against their plain versions at the path's own shapes,
    # on the inputs the path gave them (these launches are not counted)
    check(any(op == "seal" for op, _, _ in kept_aead)
          and any(op == "open" for op, _, _ in kept_aead) and kept_ladder,
          f"transport: the path's kernel shapes {sorted(kept_aead)}, {sorted(kept_ladder)}")
    for (op, sl, sb), (args, kw) in sorted(kept_aead.items()):
        got, want = cuda_aead.aead(*args, **kw), ca.aead_core(*args, **kw)
        torch.cuda.synchronize()
        aead_err = max(aead_err, *(int((g.long() - w.long()).abs().max())
                                   for g, w in zip(got, want)))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"transport: AEAD kernel != plain version on the path's {op} "
              f"inputs at {sl} x {sb}")
    for ll, (args, _) in sorted(kept_ladder.items()):
        got, want = cuda_x25519.ladder(*args), xl.ladder_plain(*args)
        torch.cuda.synchronize()
        ladder_err = max(ladder_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want),
              f"transport: ladder kernel != plain version on the path's inputs at {ll} lanes")
    print(f"transport: on the inputs the path gave them, AEAD kernel == plain "
          f"version bit for bit at each of its shapes (op, lanes, blocks) "
          f"{sorted(kept_aead)}; ladder kernel == plain version at each of its "
          f"lane buckets {sorted(kept_ladder)} (max_abs_err {aead_err}, {ladder_err})")

    # -- 3. times
    full = [(rng.bytes(32), rng.bytes(12), rng.bytes(TRANSPORT_FRAME))
            for _ in range(AEAD_LANES)]
    fl, fb = ca._bucket_shape(full)
    pf = [torch.from_numpy(a).to(dev) for a in ca._pack_frames(full, fl, fb)]
    aead_ms = cuda_ms(torch, lambda: cuda_aead.aead(*pf, seal=True), KERNEL_RUNS, 3)
    aead_plain_ms = cuda_ms(torch, lambda: ca.aead_core(*pf, seal=True), 3, 1)
    flush = full[:TRANSPORT_FLUSH]
    ql, qb = ca._bucket_shape(flush)
    pq = [torch.from_numpy(a).to(dev) for a in ca._pack_frames(flush, ql, qb)]
    got, want = cuda_aead.aead(*pq, seal=True), ca.aead_core(*pq, seal=True)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"transport: AEAD kernel != plain version at the timed flush's {ql} x {qb}")
    flush_ms = cuda_ms(torch, lambda: cuda_aead.aead(*pq, seal=True), KERNEL_RUNS, 3)
    ops, products = cuda_aead.needed_work([TRANSPORT_FRAME] * fl)
    k_ops, k_products = cuda_aead.kernel_work([TRANSPORT_FRAME] * fl)
    aead_bytes = sum(t.numel() * t.element_size() for t in pf) + (fl * fb * 16 + fl * 4) * 4
    aead_bound, aead_by = bound(ops + products, aead_bytes, sms, max_clock_mhz)
    aead_own, _ = bound(k_ops + k_products, aead_bytes, sms, max_clock_mhz)
    ladder_ms = cuda_ms(torch, lambda: cuda_x25519.ladder(scalars, us), KERNEL_RUNS, 3)
    ladder_plain_ms = cuda_ms(torch, lambda: xl.ladder_plain(scalars, us), 1, 1)
    ladder_products = LADDER_LANES * cuda_x25519.WIDE_PRODUCTS_PER_LANE
    ladder_bound, ladder_by = bound(ladder_products,
                                    LADDER_LANES * cuda_x25519.BYTES_PER_LANE,
                                    sms, max_clock_mhz)
    ladder_own, _ = bound(LADDER_LANES * cuda_x25519.KERNEL_PRODUCTS_PER_LANE,
                          LADDER_LANES * cuda_x25519.BYTES_PER_LANE, sms, max_clock_mhz)
    out_np = [t.cpu().numpy() for t in cuda_aead.aead(*pq, seal=True)]
    pack_ms = median_ms(lambda: ca._pack_frames(flush, ql, qb), HOST_RUNS * 4)
    unpack_ms = median_ms(lambda: ca._unpack_outputs(*out_np, flush), HOST_RUNS * 4)
    levels, parent_levels = cuda_aead.mac_levels(TRANSPORT_FRAME), -(-TRANSPORT_FRAME // 16) + 1
    print(f"transport: time: AEAD kernel {aead_ms} ms at {fl} lanes x {fb} blocks "
          f"(frames of {TRANSPORT_FRAME} bytes, seal; median of {KERNEL_RUNS} "
          f"one-call samples, CUDA events), {flush_ms} ms at a flush's {ql} x {qb}; "
          f"plain version {aead_plain_ms} ms; bound {aead_bound} ms by {aead_by} "
          f"({ops} 32-bit ChaCha operations + {products} Poly1305 products over "
          f"{sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x {max_clock_mhz:.0f} MHz, "
          f"or {aead_bytes} bytes at {H100_HBM_BYTES_PER_S:.3g} B/s): the kernel "
          f"at {aead_bound / aead_ms:.2%} of it; the kernel's own tally {k_ops} "
          f"operations + {k_products} products ({k_products / products:.3f}x the "
          f"products: the scan and the padded blocks), {aead_own} ms at the same "
          f"rates; a frame's MAC {levels} dependent multiplies (log2 T + m; "
          f"one thread's chain in {TRANSPORT_PARENT}: {parent_levels}) {tag}")
    print(f"transport: time: ladder kernel {ladder_ms} ms at {LADDER_LANES} lanes "
          f"(median of {KERNEL_RUNS}); plain version {ladder_plain_ms} ms; bound "
          f"{ladder_bound} ms by {ladder_by} ({ladder_products} 32x32->64-bit "
          f"products, {cuda_x25519.WIDE_PRODUCTS_PER_LANE} a lane): the kernel at "
          f"{ladder_bound / ladder_ms:.2%} of it; the kernel's own tally "
          f"{cuda_x25519.KERNEL_PRODUCTS_PER_LANE} products a lane "
          f"({cuda_x25519.KERNEL_PRODUCTS_PER_LANE / cuda_x25519.WIDE_PRODUCTS_PER_LANE:.3f}x"
          f"), {ladder_own} ms at the same rates; "
          f"{cuda_x25519.DEPENDENT_OPS_PER_LANE} dependent field operations a "
          f"lane ({cuda_x25519.ONE_THREAD_DEPENDENT_OPS_PER_LANE} in one thread): "
          f"{ladder_ms * 1e3 / cuda_x25519.DEPENDENT_OPS_PER_LANE:.4f} us each {tag}")
    spills = {}
    for w in (cuda_aead, cuda_x25519):
        log = _build.build_log(w.NAME)
        spills[w.NAME] = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        check(spills[w.NAME] and not any(int(a) or int(b) for a, b in spills[w.NAME]),
              f"transport: {w.NAME} spills: {ptxas_lines(log)}")
        occ = w.occupancy()
        check(occ["local_bytes"] == 0, f"transport: {w.NAME}: {occ['local_bytes']} local bytes")
        n = AEAD_LANES if w is cuda_aead else LADDER_LANES
        per = occ["threads"] // w.THREADS_PER_LANE
        shape = (f"a warp per frame, {per} frames" if w is cuda_aead
                 else f"a quad per lane, {per} lanes")
        grid = -(-n // per)
        print(f"occupancy: {w.NAME}: {shape} and {occ['threads']} threads per "
              f"block, {occ['regs']} registers and {occ['local_bytes']} bytes of "
              f"local memory per thread (spill stores, loads: {spills[w.NAME]}), "
              f"{occ['shared_bytes']} bytes of static shared memory per "
              f"block; {occ['blocks_per_sm']} blocks resident per SM; {n} lanes -> "
              f"{grid} blocks, {min(grid, sms)} of {sms} SMs with work"
              f"{'' if grid <= occ['blocks_per_sm'] * sms else ' (more than one wave)'} {tag}")
    transport_turns(torch, builds, pf, pq, scalars, us, tag)
    moved = TRANSPORT_PEERS * TRANSPORT_BYTES
    kernel_share = path["aead_launches"] * flush_ms / (path["transfer_s"] * 1e3)
    print(f"transport: time: {2 * TRANSPORT_PEERS} handshakes in "
          f"{path['storm_s'] * 1e3:.2f} ms of wall = "
          f"{2 * TRANSPORT_PEERS / path['storm_s']:.1f} handshakes/s; "
          f"{moved / 2**20:.0f} MiB ({TRANSPORT_PEERS} x {TRANSPORT_BYTES} bytes) in "
          f"{path['transfer_s'] * 1e3:.2f} ms of wall = "
          f"{moved / path['transfer_s'] / 1e6:.2f} MB/s; host pack "
          f"{pack_ms} ms and unpack {unpack_ms} ms per flush of "
          f"{TRANSPORT_FLUSH} frames (medians of {HOST_RUNS * 4}); the AEAD "
          f"kernel's share of the transfer wall ~{kernel_share:.2%} (derived: "
          f"{path['aead_launches']} launches x {flush_ms} ms) {tag}")
    print(f"transport: phase wall {time.perf_counter() - t_phase:.1f} s")
    return ({"name": cuda_aead.NAME, "route": "cuda", "source": cuda_aead.SOURCE,
             "replaces": cuda_aead.REPLACES, "launches": path["aead_launches"],
             "max_abs_err": aead_err, "ms": aead_ms, "plain_ms": aead_plain_ms,
             "bound_ms": aead_bound, "bound_by": aead_by, "library_ms": None},
            {"name": cuda_x25519.NAME, "route": "cuda", "source": cuda_x25519.SOURCE,
             "replaces": cuda_x25519.REPLACES, "launches": path["ladder_launches"],
             "max_abs_err": ladder_err, "ms": ladder_ms,
             "plain_ms": ladder_plain_ms, "bound_ms": ladder_bound,
             "bound_by": ladder_by, "library_ms": None})


def transport_turns(torch, builds, pf, pq, scalars, us, tag) -> None:
    """Phase 14's kernels in turns on one card.  Each against
    TRANSPORT_PARENT's (parent, new, new, parent) at the AEAD's 1,024 x 16
    and a flush's 64 x 16 (seal) and the ladder's 256 lanes and the path's
    buckets, three readings each: one call, the device time alone (queued
    behind a sleep kernel) and TRANSPORT_PER calls back to back.  Then
    this source at each block shape of AEAD_FRAME_CHOICES and
    LADDER_THREAD_CHOICES, one-call and device alone, every build first
    held to the package's kernel bit for bit."""
    from cometbft_tpu_torch.ops import cuda_aead
    from cometbft_tpu_torch.ops import cuda_x25519

    readings = (("one-call", {}), ("device alone", {"queued": True}),
                (f"back to back x{TRANSPORT_PER}", {"per": TRANSPORT_PER}))

    def in_turns(fns, order, call, ways):
        med, seq = {}, {}
        for way, kw in ways:
            turns = [(o, cuda_ms(torch, lambda: call(fns[o]), TRANSPORT_AB_RUNS, 1, **kw))
                     for o in order]
            med[way] = {o: statistics.median(v for j, v in turns if j == o) for o in fns}
            seq[way] = ", ".join(f"{o} {v}" for o, v in turns)
        return med, seq

    def same(a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    aead_shapes = {f"{t[2].shape[1]} x {t[2].shape[0]}": t for t in (pf, pq)}
    ladder_shapes = {n: (scalars[:n].contiguous(), us[:n].contiguous())
                     for n in (LADDER_LANES,) + LADDER_PATH_BUCKETS}
    kinds = (
        ("aead", "AEAD", cuda_aead.aead, aead_shapes, lambda f, a: f(*a, seal=True),
         "frames per block", AEAD_FRAME_CHOICES, cuda_aead.FRAMES_PER_BLOCK),
        ("ladder", "ladder", cuda_x25519.ladder, ladder_shapes, lambda f, a: f(*a),
         "threads per block", LADDER_THREAD_CHOICES, cuda_x25519.THREADS_PER_BLOCK),
    )
    for kind, label, package_fn, shapes, call, knob, choices, chosen in kinds:
        # this source at each block shape, held to the package's kernel
        runs = {}
        for c in choices:
            run, ptxas, occ = transport_launcher(
                torch, builds[(kind, c)], f"the {label} kernel at {c} {knob}", kind)
            check(occ["local_bytes"] == 0,
                  f"transport: {label} at {c} {knob}: {occ['local_bytes']} local bytes")
            print(f"transport: shapes: {label} at {c} {knob}: {'; '.join(ptxas)}; "
                  f"{occ['threads']} threads per block, {occ['blocks_per_sm']} "
                  f"blocks per SM")
            runs[c] = run
        for name, args in shapes.items():
            for c, run in runs.items():
                check(same(call(run, args), call(package_fn, args)),
                      f"transport: {label} at {c} {knob} disagrees with the "
                      f"package's kernel at {name}")
            med, _ = in_turns(runs, list(runs) + list(runs)[::-1],
                              lambda f: call(f, args), readings[:2])
            print(f"transport: shapes: {label} at {name}, by {knob} in turns "
                  f"(medians of {TRANSPORT_AB_RUNS} samples a turn): " + "; ".join(
                      f"{way}: " + ", ".join(f"{c} {v} ms" for c, v in m.items())
                      for way, m in med.items())
                  + f"; the package builds {chosen} {tag}")
        # TRANSPORT_PARENT's kernel against this one, both launched by the
        # same glue (transport_launcher), so that the host side is alike
        parent = builds[(kind, "parent")]
        if parent[0] is None:
            print(f"transport: {label} parent: not measured: {parent[1]}")
            continue
        run, ptxas, occ = transport_launcher(
            torch, parent, f"the {label} kernel of {TRANSPORT_PARENT}", kind)
        for name, args in shapes.items():
            check(same(call(run, args), call(package_fn, args)),
                  f"transport: the {label} kernel of {TRANSPORT_PARENT} "
                  f"disagrees with this one at {name}")
            med, seq = in_turns({"parent": run, "new": runs[chosen]},
                                ("parent", "new", "new", "parent"),
                                lambda f: call(f, args), readings)
            extra = ""
            if kind == "aead":
                one, alone = med["one-call"]["new"], med["device alone"]["new"]
                extra = (f"; this kernel's launch wait in a one-call sample "
                         f"{one - alone:.4f} ms ({(one - alone) / one:.1%} of it; "
                         f"derived: one-call - device alone), the parent's "
                         f"{med['one-call']['parent'] - med['device alone']['parent']:.4f} ms")
            print(f"transport: parent: the {label} kernel of {TRANSPORT_PARENT} "
                  f"({'; '.join(ptxas)}; {occ['threads']} threads per block) "
                  f"== this one at {name}; in turns (medians of "
                  f"{TRANSPORT_AB_RUNS} samples a turn): " + "; ".join(
                      f"{way}: parent {m['parent']} ms, new {m['new']} ms, "
                      f"{m['parent'] / m['new']:.3f}x (turns {seq[way]})"
                      for way, m in med.items()) + f"{extra} {tag}")
    # where the AEAD's device time goes: the kernel stopped at once, after
    # the keys' loads and after the keystream (AEAD_STAGE), in turns with
    # the whole
    stages = {k: transport_launcher(torch, builds[("aead", f"stage {k}")],
                                    f"the AEAD kernel's stage {k}", "aead")[0]
              for k in (0, 1, 2)}
    stages[3] = cuda_aead.aead
    for name, args in aead_shapes.items():
        med, _ = in_turns(stages, (0, 1, 2, 3, 3, 2, 1, 0),
                          lambda f: f(*args, seal=True), readings[1:2])
        m = med["device alone"]
        levels = cuda_aead.mac_levels(int(args[3][0]))
        print(f"transport: AEAD stages at {name}, device time alone in turns: an "
              f"empty launch {m[0]} ms; + the keys loaded (one load, a barrier) "
              f"{m[1]} ms (+{m[1] - m[0]:.4f}); + the keystream {m[2]} ms "
              f"(+{m[2] - m[1]:.4f}); + the MAC (the whole kernel) {m[3]} ms "
              f"(+{m[3] - m[2]:.4f}: a frame's {levels} dependent multiplies, "
              f"{(m[3] - m[2]) * 1e3 / levels:.4f} us each) {tag}")


def transport_path(torch, cbatch, ds) -> dict:
    """The main path of phase 14: TRANSPORT_PEERS SecretConnection pairs
    over socket pairs, every handshake dialing at once through the
    handshake pool and the ladder kernel, then each connection carrying
    TRANSPORT_BYTES of a block as flushes of TRANSPORT_FLUSH frames through
    the plane and the AEAD kernel, and one tampered flush.  Returns the
    launch counts and walls."""
    import socket
    import struct
    import threading

    import numpy as np

    from cometbft_tpu_torch.crypto import backend_health
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import cuda_aead
    from cometbft_tpu_torch.ops import cuda_x25519
    from cometbft_tpu_torch.ops import x25519_ladder as xl
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats
    from cometbft_tpu_torch.p2p.secret_connection import (SecretConnection,
                                                            SecretConnectionError)
    from cometbft_tpu_torch.verifysched import service

    if not service.backend_trusted():
        cbatch.default_backend()  # the batch seam's self-check opens the gate
    check(service.backend_trusted(), "transport: the gate is closed")
    n = TRANSPORT_PEERS
    privs = [Ed25519PrivKey.from_seed(hashlib.sha256(b"peer-%d" % i).digest())
             for i in range(2 * n)]
    block = np.random.default_rng(TRANSPORT_SEED + 1).bytes(TRANSPORT_BLOCK)
    data = block[:TRANSPORT_BYTES]
    socks = [socket.socketpair() for _ in range(n)]
    conns = [None] * (2 * n)
    errors = []
    handshake_pool.reset_pool()
    backend_health.reset()
    tstats.reset()
    ds.reset()
    cuda_aead.reset_launches()
    cuda_x25519.reset_launches()
    barrier = threading.Barrier(2 * n + 1)

    def dial(i):
        try:
            barrier.wait()
            conns[i] = SecretConnection(socks[i // 2][i % 2], privs[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=dial, args=(i,)) for i in range(2 * n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(120)
    storm_s = time.perf_counter() - t0
    check(not errors and all(conns), f"transport: handshakes failed: {errors[:3]}")
    for i in range(0, 2 * n, 2):
        check(conns[i + 1].remote_pub_key == privs[i].pub_key()
              and conns[i].remote_pub_key == privs[i + 1].pub_key(),
              f"transport: pair {i // 2} authenticated the wrong keys")
    hs = tstats.snapshot()

    chunk = TRANSPORT_FLUSH * TRANSPORT_FRAME

    def send(sc):
        try:
            for off in range(0, len(data), chunk):
                part = data[off:off + chunk]
                sc.write_frames([part[k:k + TRANSPORT_FRAME]
                                 for k in range(0, len(part), TRANSPORT_FRAME)])
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def recv(sc):
        try:
            view = memoryview(data)
            for off in range(0, len(data), TRANSPORT_FRAME):
                if view[off:off + TRANSPORT_FRAME] != sc.read_frame():
                    errors.append(f"frame at {off} differs")
                    return
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=send, args=(conns[i],)) for i in range(0, 2 * n, 2)]
    threads += [threading.Thread(target=recv, args=(conns[i],)) for i in range(1, 2 * n, 2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    transfer_s = time.perf_counter() - t0
    check(not errors, f"transport: the transfer failed: {errors[:3]}")

    # one flush with a frame tampered at TRANSPORT_TAMPER_AT: the exact
    # prefix, then a sticky error
    a, b = conns[0], conns[1]
    part = [bytes([k % 251]) * TRANSPORT_FRAME for k in range(TRANSPORT_FLUSH)]
    sealed = a._send.seal_batch(part)
    s = sealed[TRANSPORT_TAMPER_AT]
    sealed[TRANSPORT_TAMPER_AT] = s[:-1] + bytes([s[-1] ^ 1])
    a._sock.sendall(b"".join(struct.pack(">I", len(x)) + x for x in sealed))
    got = []
    try:
        while True:
            got.append(b.read_frame())
    except SecretConnectionError:
        pass
    check(got == part[:TRANSPORT_TAMPER_AT],
          f"transport: {len(got)} frames before the tampered one, want "
          f"{TRANSPORT_TAMPER_AT}")
    try:
        b.read_frame()
        raise SmokeError("transport: the error after a tampered frame is not sticky")
    except SecretConnectionError:
        pass

    aead_launches, ladder_launches = cuda_aead.launches, cuda_x25519.launches
    snap = tstats.snapshot()
    aead_tiers, ladder_tiers = ds.tier_counts(ca.AEAD), ds.tier_counts(xl.X25519)
    for c in conns:
        c.close()
    handshake_pool.reset_pool()
    check(aead_tiers["torch"] == aead_tiers["host"] == (0, 0) and aead_tiers["cuda"][0]
          == snap["dispatches"]["device"] == aead_launches > 0,
          f"transport: AEAD passes by tier {aead_tiers}, {aead_launches} launches")
    check(ladder_tiers["torch"] == ladder_tiers["host"] == (0, 0)
          and ladder_tiers["cuda"] == (snap["hs_device"], 4 * n)
          and snap["hs_device"] == ladder_launches > 0,
          f"transport: ladder passes by tier {ladder_tiers}, {ladder_launches} launches")
    check(snap["dispatches"]["host"] == 0
          and snap["bad_tags"] == 1 and snap["reject_confirms"] == 1,
          f"transport: counters {snap}")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    check(not leaked, f"imported {leaked}")
    print(f"transport: {n} SecretConnection pairs over socket pairs, "
          f"{2 * n} handshakes dialed at once: {2 * n} public keys and "
          f"{2 * n} exchanges through the handshake pool in "
          f"{sum(hs['hs_flushes'].values())} flushes {hs['hs_flushes']} "
          f"({hs['handshakes_per_flush']:.1f} exchanges a flush), "
          f"{hs['hs_shed']} shed; then {TRANSPORT_BYTES} bytes of a "
          f"{TRANSPORT_BLOCK}-byte block per connection"
          + ("" if TRANSPORT_BYTES == TRANSPORT_BLOCK
             else f" (cut from {TRANSPORT_BLOCK}: the phase's time)")
          + f" as {TRANSPORT_BYTES // chunk} write_frames flushes of "
          f"{TRANSPORT_FLUSH} frames of {TRANSPORT_FRAME} bytes (block parts of "
          f"{TRANSPORT_PART} bytes), read back by read_frame equal; a frame "
          f"tampered at {TRANSPORT_TAMPER_AT} of a flush: that prefix, then a "
          f"sticky SecretConnectionError.  Frames batched {snap['frames']['batched']}"
          f", serial {snap['frames']['serial']}; AEAD passes {snap['batches']} "
          f"({snap['frames_per_batch']:.1f} frames each), launches: "
          f"{cuda_aead.NAME} {aead_launches}, {cuda_x25519.NAME} {ladder_launches}; "
          f"served by tier (passes, items): aead {aead_tiers}, x25519 "
          f"{ladder_tiers}; jax not imported")
    return {"aead_launches": aead_launches, "ladder_launches": ladder_launches,
            "storm_s": storm_s, "transfer_s": transfer_s}


def proof_fields(proofs) -> list:
    return [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in proofs]


def proofs_phase(torch, dev, ds, tag) -> int:
    """Phase 15: proofs and the coalescing proof server through the
    SHA-256 tree kernel, every level of its output copied back.  Returns
    the tree kernel's launches on the server's path."""
    import threading

    import numpy as np

    from cometbft_tpu_torch.crypto import backend_health as bh
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.crypto.backend_health import BackendError
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import supervisor as sup
    from cometbft_tpu_torch.proofserve import plane
    from cometbft_tpu_torch.proofserve import service as psvc
    from cometbft_tpu_torch.proofserve import stats as proof_stats

    t_phase = time.perf_counter()
    rng = np.random.default_rng(PROOF_SEED)
    size = PROOF_TXS * PROOF_TX_BYTES
    raw = rng.bytes(PROOF_HEIGHTS * size)
    blocks = {h: [raw[o : o + PROOF_TX_BYTES]
                  for o in range((h - 1) * size, h * size, PROOF_TX_BYTES)]
              for h in range(1, PROOF_HEIGHTS + 1)}
    block = blocks[1]
    big = f"the {PROOF_TXS}-tx block"

    def merkle_only(where: str) -> tuple:
        counts = ds.tier_counts(st.MERKLE)
        check(counts["cuda"][0] > 0 and all(
            v == (0, 0) for t, v in counts.items() if t != "cuda"),
            f"proofs: {where}: tree passes served below the cuda tier: {counts}")
        return counts["cuda"]

    # every proof == crypto/merkle's; the kernel's levels == its plain version
    cases = {big: block}
    cases.update({f"{k} leaves": [rng.bytes(int(ln)) for ln in rng.integers(0, 130, k)]
                  for k in PROOF_SMALL_N})
    cases["the block-edge lengths"] = [rng.bytes(ln) for ln in PROOF_EDGE_LENS * 3]
    ds.reset()
    n_proofs = 0
    for name, items in cases.items():
        root, proofs = st.tree_proofs(items)
        want_root, want = merkle.proofs_from_byte_slices(items)
        check(root == want_root and proof_fields(proofs) == proof_fields(want),
              f"proofs: tree_proofs != crypto/merkle on {name}")
        n_proofs += len(proofs)
    served = merkle_only("the proof checks")
    check(served[0] == len(cases), f"proofs: {served[0]} tree passes for "
          f"{len(cases)} leaf sets")
    worst = 0
    plain_cases = [big, "the block-edge lengths"] + [f"{k} leaves" for k in PROOF_PLAIN_N]
    for name in plain_cases:
        data, offs = st.pack_leaves(cases[name], dev)
        kern = csh.tree_words(data, offs)
        plain = st.tree_words_plain(data, offs)
        err = int((kern.long() - plain.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(kern, plain), f"proofs: tree kernel != plain on {name} "
              f"(max_abs_err {err})")
    print(f"proofs: tree_proofs on the card == crypto/merkle's "
          f"proofs_from_byte_slices in every field (total, index, leaf_hash, "
          f"every aunt) of all {n_proofs} proofs of {len(cases)} leaf sets "
          f"({big} of {PROOF_TX_BYTES} bytes, 1-{PROOF_SMALL_N[-1]} leaves of "
          f"0-129 bytes, leaves of {', '.join(map(str, PROOF_EDGE_LENS))} bytes), "
          f"one tree pass each on cuda; the kernel's levels == its plain version "
          f"bit for bit (max_abs_err {worst}) on {', '.join(plain_cases)}")

    # where a proof build's time goes, at the block
    data, offs = st.pack_leaves(block, dev)
    pack_ms = median_ms(lambda: (st.pack_leaves(block, dev),
                                 torch.cuda.synchronize()), PROOF_RUNS)
    kernel_ms = cuda_ms(torch, lambda: csh.tree_words(data, offs), KERNEL_RUNS, 3)
    out = csh.tree_words(data, offs)
    torch.cuda.synchronize()
    d2h_ms = median_ms(lambda: out.cpu(), PROOF_RUNS)
    words = out.cpu().numpy()
    split_ms = median_ms(lambda: st.split_levels(words, PROOF_TXS), PROOF_RUNS)
    levels = st.split_levels(words, PROOF_TXS)
    assemble_ms = median_ms(lambda: st.proofs_from_levels(levels), PROOF_RUNS)
    build_ms = median_ms(lambda: st.tree_proofs(block), PROOF_RUNS)
    host_ms = median_ms(lambda: merkle.proofs_from_byte_slices(block), PROOF_RUNS)
    rest_ms = build_ms - pack_ms - kernel_ms - d2h_ms - split_ms - assemble_ms
    print(f"proofs: time: one proof build of {PROOF_TXS} txs (medians of "
          f"{PROOF_RUNS} samples, the kernel's of {KERNEL_RUNS}): the whole "
          f"tree_proofs {build_ms} ms = leaves packed and copied to the card "
          f"{pack_ms} ms + the tree kernel {kernel_ms} ms (device time, one "
          f"call) + the D2H of every level ({words.nbytes} bytes) {d2h_ms} ms + "
          f"split into levels {split_ms} ms + proofs_from_levels {assemble_ms} "
          f"ms + the rest (supervisor, validation) {rest_ms} ms; the host's "
          f"merkle.proofs_from_byte_slices on the same block {host_ms} ms {tag}")

    # the server: 64 light clients over 8 heights
    headers = {h: [rng.bytes(32) for _ in range(14)] for h in blocks}
    valsets = {h: [rng.bytes(46) for _ in range(PROOF_VALIDATORS)] for h in blocks}
    oracle = {h: merkle.proofs_from_byte_slices(blocks[h]) for h in blocks}
    want_other = {"header": {h: merkle.hash_from_byte_slices(headers[h]) for h in blocks},
                  "valset": {h: merkle.hash_from_byte_slices(valsets[h]) for h in blocks}}
    draw = rng.random(PROOF_QUERIES)
    plan = [("header" if d < PROOF_OTHER / 2 else "valset" if d < PROOF_OTHER else "tx",
             int(h), int(i))
            for d, h, i in zip(draw, rng.integers(1, PROOF_HEIGHTS + 1, PROOF_QUERIES),
                               rng.integers(0, PROOF_TXS, PROOF_QUERIES))]
    hashers = [lambda h, src=src: plane.tree_hash(src[h]) if h in src else None
               for src in (headers, valsets)]
    server = psvc.configure(blocks.get, *hashers)
    check((server.flush_s, server.queue_cap, server.cache_cap) == (
        psvc.DEFAULT_FLUSH_US / 1e6, psvc.DEFAULT_QUEUE_CAP, psvc.DEFAULT_CACHE_CAP),
        "proofs: the server is not at its defaults")
    results, lat, cold, errors = ([None] * PROOF_QUERIES, [0.0] * PROOF_QUERIES,
                                  [False] * PROOF_QUERIES, [])

    def client(k: int) -> None:
        try:
            for q in range(k, PROOF_QUERIES, PROOF_CLIENTS):
                kind, h, i = plan[q]
                t0 = time.perf_counter()
                if kind == "tx":
                    cold[q] = not server.cached("tx", h)
                    results[q] = psvc.prove_tx(blocks.get, h, i)
                else:
                    results[q] = server.submit(kind, h).result(60)
                lat[q] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    proof_stats.reset()
    ds.reset()
    csh.reset_launches()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(PROOF_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = csh.launches
    snap = proof_stats.snapshot()
    check(not errors, f"proofs: {len(errors)} clients failed: {errors[:3]}")
    for q, (kind, h, i) in enumerate(plan):
        got = results[q]
        if kind != "tx":
            check(got == want_other[kind][h], f"proofs: {kind} {h} != its hash")
            continue
        root, proof = got
        check(root == oracle[h][0] and proof_fields([proof]) == proof_fields(
            [oracle[h][1][i]]) and proof.verify(root, blocks[h][i]),
            f"proofs: query {q} (height {h}, tx {i}) != the host oracle's")
    served = merkle_only("the server")
    check(snap["tree_builds"]["tx"] == PROOF_HEIGHTS,
          f"proofs: {snap['tree_builds']['tx']} tx tree builds")
    check(snap["shed_total"] == 0 and snap["serial_fallbacks"] == 0,
          f"proofs: shed {snap['shed']}, serial {snap['serial_fallbacks']}")
    check(launches == served[0] == snap["trees_device"] and snap["trees_host"] == 0
          and launches >= PROOF_HEIGHTS,
          f"proofs: {launches} tree launches, {served} cuda passes, {snap}")
    n_tx = sum(kind == "tx" for kind, _, _ in plan)
    cold_ms = [lat[q] * 1e3 for q in range(PROOF_QUERIES) if cold[q]]
    all_ms = [x * 1e3 for x in lat]
    p50, p99 = np.percentile(cold_ms, [50, 99]) if cold_ms else (None, None)
    print(f"proofs: server: {PROOF_CLIENTS} light-client threads, {PROOF_QUERIES} "
          f"queries ({n_tx} tx through prove_tx, the rest header and valset) over "
          f"{PROOF_HEIGHTS} heights of {PROOF_TXS} txs, the default flush "
          f"({psvc.DEFAULT_FLUSH_US:.0f} us), queue ({psvc.DEFAULT_QUEUE_CAP}) and "
          f"cache ({psvc.DEFAULT_CACHE_CAP}): every proof == the host oracle's "
          f"and verifies against its root; {snap['tree_builds']} builds, "
          f"{launches} tree launches (every tree pass on cuda), shed "
          f"{snap['shed_total']}, serial fallbacks {snap['serial_fallbacks']}, "
          f"{snap['flushes']} flushes, {snap['cache_hits_total']} cache hits, "
          f"{snap['queries_per_flush']:.2f} queries per flush")
    print(f"proofs: time: {PROOF_QUERIES / wall:.1f} coalesced queries/s "
          f"({PROOF_QUERIES} in {wall:.3f} s); cold tx queries (height not yet "
          f"cached when asked: {len(cold_ms)}) latency p50 {p50} ms, p99 {p99} "
          f"ms; every query p50 {np.percentile(all_ms, 50)} ms, p99 "
          f"{np.percentile(all_ms, 99)} ms {tag}")

    # a faulted build: BackendError reaches prove_tx, no serial answer
    server = psvc.configure(blocks.get, *hashers)  # a fresh cache
    before = proof_stats.snapshot()["serial_fallbacks"]
    sup.set_fault_injector(sup.FaultyBackend("raise", backends=(bh.MERKLE_DEVICE,)))
    try:
        psvc.prove_tx(blocks.get, 1, 0)
    except BackendError as e:
        raised = e
    else:
        raised = None
    finally:
        sup.clear_fault_injector()
    failures = bh.snapshot()["breakers"][bh.MERKLE_DEVICE]["failures_total"]
    check(raised is not None, "proofs: a faulted build was answered")
    check(proof_stats.snapshot()["serial_fallbacks"] == before,
          "proofs: a faulted build was answered by the serial path")
    check(failures == 1, f"proofs: the merkle_device breaker saw {failures} failures")
    bh.reset()
    print(f"proofs: FaultyBackend(raise) on {bh.MERKLE_DEVICE}: prove_tx raised "
          f"{type(raised).__name__} ({raised}); serial fallbacks unchanged, the "
          f"breaker recorded 1 failure (reset after)")

    # the serial path with the kill switch off
    pick = rng.integers(0, PROOF_QUERIES, PROOF_SERIAL)
    with environ({"COMETBFT_TPU_PROOFSERVE": "0"}):
        check(not psvc.server_active(), "proofs: the kill switch left the server on")
        t0 = time.perf_counter()
        for q in pick:
            _, h, i = plan[q]
            root, proof = psvc.prove_tx(blocks.get, h, i)
            check(root == oracle[h][0], "proofs: serial root")
        serial_s = time.perf_counter() - t0
    psvc.reset_server()
    print(f"proofs: time: serial prove_tx (COMETBFT_TPU_PROOFSERVE=0: one "
          f"merkle.proofs_from_byte_slices of the whole block per query), "
          f"{PROOF_SERIAL} queries in {serial_s:.3f} s = {PROOF_SERIAL / serial_s:.2f} "
          f"queries/s; the coalesced server {PROOF_QUERIES / wall / (PROOF_SERIAL / serial_s):.1f}x "
          f"that {tag}")
    print(f"proofs: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def warm_child(path: str, mode: str) -> int:
    """One fresh process of phase 16: unpickle the commit, warm boot
    (``mode`` "warm": ``warmboot.run()``) or not ("cold"), then the first
    cold ``verify_commit``; prints one JSON line."""
    t_boot = time.perf_counter()
    import pickle

    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import _build, cuda_aead, cuda_bls, cuda_secp
    from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify, cuda_x25519, warmboot
    from cometbft_tpu_torch.types import validation as val

    check(torch.cuda.is_available(), "warmboot child: no CUDA device")
    with open(path, "rb") as f:
        vals, commit, block_id = pickle.load(f)
    mods = (cuda_verify, cuda_secp, cuda_bls, cuda_sha256, cuda_aead, cuda_x25519)
    t0 = time.perf_counter()
    report = warmboot.run() if mode == "warm" else None
    warm_s = time.perf_counter() - t0
    warm_launches = {m.NAME: m.launches for m in mods}
    ran = []
    for name in ("gpu_self_check", "secp_self_check", "bls_self_check"):
        real = getattr(cbatch, name)
        setattr(cbatch, name, lambda dev=None, real=real, name=name:
                (ran.append(name), real(dev))[1])
    before = _build.statuses(_build.sources())
    t0 = time.perf_counter()
    val.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    first_ms = (time.perf_counter() - t0) * 1e3
    after = _build.statuses(_build.sources())
    print(json.dumps({
        "mode": mode, "report": report, "warm_s": warm_s,
        "warm_launches": warm_launches, "self_checks": ran,
        "loaded_by_commit": {n: s for n, s in after.items() if before[n] != s},
        "first_commit_ms": first_ms,
        "commit_launches": cuda_verify.launches - warm_launches[cuda_verify.NAME],
        "boot_to_commit_s": time.perf_counter() - t_boot,
    }))
    return 0


def run_warm_child(path: str, mode: str) -> dict:
    script = os.path.abspath(__file__)
    env = dict(os.environ, COMETBFT_TPU_WARMBOOT="0")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, "--warm-child", path, mode],
                          cwd=os.path.dirname(script), env=env, capture_output=True,
                          text=True, timeout=WARM_CHILD_TIMEOUT_S)
    check(proc.returncode == 0, f"warmboot: the {mode} child failed "
          f"(rc {proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def bls_point(pub: bytes):
    """A 96-byte uncompressed G1 point as affine ints (None: infinity)."""
    if pub[0] & 0x40:
        return None
    return (int.from_bytes(pub[:48], "big") & ((1 << 381) - 1),
            int.from_bytes(pub[48:], "big"))


def warmboot_phase(torch, dev, ds, vals, commit, block_id, n, sms,
                   max_clock_mhz, tag) -> None:
    """Phase 16: the build cache and the warm-boot pass in two fresh
    processes, a failed family in this one, and ``msm``/``sum_points``."""
    import pickle

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import backend_health as bh
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.crypto.backend_health import BackendError
    from cometbft_tpu_torch.ops import _build, bls_g1, chacha_aead, cuda_aead
    from cometbft_tpu_torch.ops import cuda_bls as cb
    from cometbft_tpu_torch.ops import warm_stats, warmboot

    t_phase = time.perf_counter()
    infos = {name: _build.info(name) for name in _build.sources()}
    costs = {name: (f"{i['build_s']:.2f} s" if i.get("build") == "built"
                    else i.get("build", "not loaded"))
             for name, i in infos.items()}
    print(f"warmboot: build cost of a boot with an empty build directory, "
          f"per library as phase 2 recorded it (compilers in parallel: seconds "
          f"until each finished; 'hit' where phase 2 found it built): {costs} {tag}")

    # two fresh processes sharing the build directory
    tmp = tempfile.mkdtemp(prefix="chip-smoke-warm-")
    try:
        path = os.path.join(tmp, "commit.pickle")
        with open(path, "wb") as f:
            pickle.dump((vals, commit, block_id), f)
        warm = run_warm_child(path, "warm")
        cold = run_warm_child(path, "cold")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep = warm["report"]
    families = {f for f, _, _ in warmboot.FAMILIES}
    libs = {k: v for k, v in rep["statuses"].items() if k not in families}
    check(rep["failures"] == 0 and set(rep["family_seconds"]) == families,
          f"warmboot: warm pass {rep}")
    check(libs and all(s == "hit" for s in libs.values()) and len(libs) == 8,
          f"warmboot: library statuses {rep['statuses']}")
    check(all(v == 1 for v in warm["warm_launches"].values()),
          f"warmboot: self-check launches {warm['warm_launches']}")
    check(warm["self_checks"] == [] and warm["loaded_by_commit"] == {},
          f"warmboot: the first commit after warm boot ran self-checks "
          f"{warm['self_checks']} or loaded {warm['loaded_by_commit']}")
    check(cold["self_checks"] == ["gpu_self_check"]
          and set(cold["loaded_by_commit"]) == {"host_prep", "ed25519_verify"},
          f"warmboot: the cold child's first commit ran {cold['self_checks']}, "
          f"loaded {cold['loaded_by_commit']}")
    check(warm["commit_launches"] == 1 and cold["commit_launches"] == 2,
          f"warmboot: first-commit Ed25519 launches {warm['commit_launches']} "
          f"after warm boot (the commit), {cold['commit_launches']} without "
          f"(the self-check and the commit)")
    fam = {k: f"{v * 1e3:.1f} ms" for k, v in rep["family_seconds"].items()}
    print(f"warmboot: a fresh process (COMETBFT_TPU_WARMBOOT=0, warmboot.run() "
          f"called): statuses {rep['statuses']}, failures {rep['failures']}, "
          f"each family's load and self-check {fam}, the pass {rep['seconds']:.3f} "
          f"s; one self-check launch per kernel {warm['warm_launches']}; then "
          f"the first cold verify_commit of {n} signatures ran no build, no "
          f"load and no self-check: {warm['first_commit_ms']} ms (process start "
          f"to its end {warm['boot_to_commit_s']:.2f} s, the process "
          f"{warm['process_s']:.2f} s) {tag}")
    print(f"warmboot: a fresh process without warm boot: the same first cold "
          f"verify_commit {cold['first_commit_ms']} ms, which loaded "
          f"{cold['loaded_by_commit']} and ran {cold['self_checks']} (process "
          f"start to its end {cold['boot_to_commit_s']:.2f} s, the process "
          f"{cold['process_s']:.2f} s); warm boot took "
          f"{cold['first_commit_ms'] - warm['first_commit_ms']:.1f} ms off the "
          f"first commit {tag}")

    # a failed family in this process: the AEAD kernel's launch fails
    bh.reset()
    warm_stats.reset()
    real = cuda_aead.aead

    def failing(*args, **kwargs):
        raise RuntimeError("injected: the AEAD kernel's launch fails")

    cuda_aead.aead = failing
    try:
        rep = warmboot.run()
        wsnap = warm_stats.snapshot()
        frame = (bytes(32), bytes(12), b"warm-boot fault")
        try:
            chacha_aead.seal_frames([frame])
        except BackendError as e:
            raised = e
        else:
            raised = None
        snap = bh.snapshot()
    finally:
        cuda_aead.aead = real
        bh.reset()
        warm_stats.reset()
    others = {k: v for k, v in rep["statuses"].items() if k != "aead"}
    check(rep["statuses"].get("aead") == "error:RuntimeError" and rep["failures"] == 1,
          f"warmboot: fault: {rep}")
    check(wsnap["warm_failures"] == 1 and snap["demotions"] == 2
          and snap["breakers"][bh.AEAD_DEVICE]["failures_total"] == 2,
          f"warmboot: fault: {wsnap}, {snap['breakers'].get(bh.AEAD_DEVICE)}")
    check(len(others) == 7 and all(v in ("hit", "built") for v in others.values()),
          f"warmboot: fault: the other families {others}")
    check(raised is not None, "warmboot: an AEAD pass after the failed family "
          "did not raise")
    print(f"warmboot: the AEAD hook's launch made to fail in this process: "
          f"statuses {rep['statuses']}, warm_failures {wsnap['warm_failures']}, "
          f"{bh.AEAD_DEVICE} failures {snap['breakers'][bh.AEAD_DEVICE]['failures_total']} "
          f"and demotions {snap['demotions']} (the warm pass's and the next "
          f"pass's); the other families warmed; "
          f"the next AEAD pass raised {type(raised).__name__}; reset after")

    # msm and sum_points on the card
    pubs, ks = bls_lanes(native, BLS_LANES)
    pts = [bls_point(p) for p in pubs]
    cb.reset_launches()
    got = {m: bls_g1.msm(pts[:m], ks[:m]) for m in MSM_LANES}
    sums = {m: bls_g1.sum_points(pts[:m]) for m in MSM_LANES}
    torch.cuda.synchronize()
    launches = cb.launches
    check(launches == len(MSM_LANES), f"msm: {launches} G1 launches")

    def host_sum(points, scalars=None):
        acc = bls.E1.infinity()
        for i, p in enumerate(points):
            if p is not None:
                q = (p[0], p[1], 1)
                acc = bls.E1.add_pts(acc, q if scalars is None
                                     else bls.E1.mul_scalar(q, scalars[i]))
        return bls.E1.affine(acc)

    s = MSM_SAMPLE
    check(got[s] == host_sum(pts[:s], ks[:s]), f"msm: {s} lanes != the oracle")
    check(sums[s] == host_sum(pts[:s]), f"sum_points: {s} lanes != the oracle")
    big = MSM_LANES[-1]
    check(got[big] == host_sum(bls_g1.batch_scalar_mul(pts[:big], ks[:big])),
          f"msm: {big} lanes != the host sum of the kernel's products")
    check(sums[big] == host_sum(pts[:big]), f"sum_points: {big} lanes != the oracle")
    print(f"msm: msm and sum_points on the card ({launches} G1 launches for "
          f"{len(MSM_LANES)} msm calls, the lane sums a torch tier on the card) "
          f"== the pure-Python oracle's sums at {s} lanes; at {big} lanes msm == "
          f"the host's sum of the kernel's per-lane products and sum_points == "
          f"the oracle's sum")
    for m in MSM_LANES:
        cp = torch.from_numpy(bls_g1.points_to_bytes(pts[:m]).copy()).to(dev)
        ck = torch.from_numpy(bls_g1.scalars_to_bytes(ks[:m]).copy()).to(dev)
        mul_ms = cuda_ms(torch, lambda: cb.scalar_mul_cuda(cp, ck), KERNEL_RUNS, 3)
        xyz = cb.scalar_mul_cuda(cp, ck)
        fold_ms = cuda_ms(torch, lambda: bls_g1.lane_sum_xyz(bls_g1.points_from_xyz(xyz)),
                          MSM_RUNS, 1)
        msm_ms = median_ms(lambda: bls_g1.msm(pts[:m], ks[:m]), MSM_RUNS)
        bsm_ms = median_ms(lambda: bls_g1.batch_scalar_mul(pts[:m], ks[:m]), MSM_RUNS)
        sum_ms = median_ms(lambda: bls_g1.sum_points(pts[:m]), MSM_RUNS)
        muls, squares, products = cb.msm_needed_work(ks[:m])
        bound_ms, bound_by = bound(products, m * (96 + 16) + 96, sms, max_clock_mhz)
        print(f"msm: time at {m} lanes: msm {msm_ms} ms (host wall, median of "
              f"{MSM_RUNS}: packing, the G1 kernel, the lane sum, the copy back) "
              f"beside batch_scalar_mul {bsm_ms} ms; on the card the G1 kernel "
              f"{mul_ms} ms and the lane sum (torch tier, {max(m - 1, 0).bit_length()} "
              f"levels of complete additions) {fold_ms} ms; sum_points {sum_ms} ms; "
              f"bound {bound_ms} ms by {bound_by} ({products} products: "
              f"the G1 row's work and {m - 1} additions, add-2007-bl), msm's "
              f"device time at {bound_ms / (mul_ms + fold_ms):.2%} of it; "
              f"library_ms null: no PyTorch call computes a G1 multi-scalar "
              f"multiplication {tag}")
    print(f"warmboot: phase wall {time.perf_counter() - t_phase:.1f} s")


def _expand_chunk(seeds):
    """Worker of phase 17: Ed25519 signing keys from seeds (``expand``)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.expand(s) for s in seeds]


def _sign_chunk(jobs):
    """Worker of phase 17: (expanded key, message) pairs -> signatures."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.sign_expanded(key, msg) for key, msg in jobs]


def in_chunks(pool, fn, items: list, workers: int) -> list:
    """``fn`` over ``items`` in about 4 chunks per worker of ``pool``,
    flattened back in order."""
    k = max(1, -(-len(items) // (4 * workers)))
    chunks = [items[i : i + k] for i in range(0, len(items), k)]
    return [x for part in pool.map(fn, chunks) for x in part]


class PartTimer:
    """Wall ms of named calls, summed per window: ``wrap`` replaces
    ``obj.name`` with a timing wrapper until ``restore``."""

    def __init__(self):
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self._undo = []

    def wrap(self, obj, name: str, label: str) -> None:
        real = getattr(obj, name)
        ms, calls = self.ms, self.calls

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                ms[label] += (time.perf_counter() - t0) * 1e3
                calls[label] += 1

        self._undo.append((obj, name, name in vars(obj), vars(obj).get(name)))
        setattr(obj, name, timed)

    def window(self) -> dict:
        out = {k: (round(self.ms[k], 3), self.calls[k]) for k in sorted(self.ms)}
        self.ms.clear()
        self.calls.clear()
        return out

    def restore(self) -> None:
        for obj, name, had, old in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()


def blockexec_phase(torch, dev, cbatch, cv, ds, sigcache, tag) -> dict:
    """Phase 17: a blocksync joiner's apply path at BASELINE config 2's
    width.  Returns {"ed25519": launches, "tree": launches} of the path,
    and the chain for phases 19 and 20: "dir" (the temporary directory,
    which the caller removes), "db" (the closed SQLite store's path),
    "genesis" (the ``GenesisDoc``), "keys" (the validators' expanded
    signing keys, in genesis order) and "app" (the KVStore app at height 5,
    its snapshot taken).  On a failure the directory is removed here."""
    import base64
    import concurrent.futures
    import dataclasses
    import multiprocessing

    import numpy as np

    from cometbft_tpu_torch.abci import types as at
    from cometbft_tpu_torch.abci.client import LocalClient
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.crypto import tmhash
    from cometbft_tpu_torch.crypto.ed25519_ref import sign_expanded as ref_sign
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.mempool.clist_mempool import NopMempool
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.state import execution
    from cometbft_tpu_torch.state.state import _params_to_json, state_from_genesis
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV
    from cometbft_tpu_torch.types import codec, events, validation
    from cometbft_tpu_torch.types.basic import (
        BLOCK_ID_FLAG_COMMIT, PRECOMMIT_TYPE, BlockID, PartSetHeader, Timestamp)
    from cometbft_tpu_torch.types.block import Commit, Data
    from cometbft_tpu_torch.types.evidence import (
        DuplicateVoteEvidence, evidence_list_hash)
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.validator import ValidatorSet
    from cometbft_tpu_torch.types.vote import CommitSig, Vote
    from cometbft_tpu_torch.verifysched import stats as vstats

    n, heights = BLOCKEXEC_VALIDATORS, BLOCKEXEC_HEIGHTS
    check(cbatch.default_backend() == "gpu", "blockexec: the default backend is not gpu")
    rng = np.random.default_rng(BLOCKEXEC_SEED)
    workers = BLOCKEXEC_SIGNERS
    tmp = tempfile.mkdtemp(prefix="blockexec-")
    ctx = multiprocessing.get_context("spawn")
    pool_ex = concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx)
    timer = PartTimer()
    undo_keep = []
    handed = False
    try:
        # -- genesis: keys, the document, the state, InitChain -------------
        t0 = time.perf_counter()
        seeds = [rng.bytes(32) for _ in range(n)]
        keys = in_chunks(pool_ex, _expand_chunk, seeds, workers)
        key_s = time.perf_counter() - t0
        pubs = [Ed25519PubKey(k[2]) for k in keys]
        key_by_addr = {p.address(): k for p, k in zip(pubs, keys)}
        t0 = time.perf_counter()
        gdoc = GenesisDoc(chain_id=BLOCKEXEC_CHAIN, genesis_time=Timestamp(BLOCKEXEC_T0, 0),
                          validators=[GenesisValidator(p, 1, f"v{i}")
                                      for i, p in enumerate(pubs)])
        gdoc.validate_and_complete()
        genesis_hash = tmhash.sum256(gdoc.to_json().encode())
        state = state_from_genesis(gdoc)
        app = KVStoreApplication()
        client = LocalClient(app)
        res = client.init_chain(at.InitChainRequest(
            time_unix_ns=gdoc.genesis_time.to_ns(), chain_id=gdoc.chain_id,
            consensus_params=_params_to_json(gdoc.consensus_params),
            validators=[at.ValidatorUpdate("ed25519", p.bytes(), 1) for p in pubs],
            app_state_bytes=gdoc.app_state, initial_height=gdoc.initial_height))
        state.app_hash = res.app_hash
        path = os.path.join(tmp, "chain.db")
        db = SqliteKV(path, surface="state")
        bstore, sstore = BlockStore(db), StateStore(db)
        sstore.bootstrap(state)
        evpool = EvidencePool(db, sstore, bstore)
        bus = events.EventBus()
        sub = bus.subscribe("blockexec", events.query_for_event(events.EVENT_NEW_BLOCK),
                            capacity=16)
        ex = execution.BlockExecutor(sstore, bstore, client, NopMempool(),
                                     evidence_pool=evpool, event_bus=bus)
        genesis_s = time.perf_counter() - t0
        params = state.consensus_params
        print(f"blockexec: genesis of {n} equal-power Ed25519 validators (seed "
              f"{BLOCKEXEC_SEED}; keys in {key_s:.2f} s on {workers} processes), "
              f"default consensus params (block max_bytes {params.block.max_bytes}, "
              f"evidence max_bytes {params.evidence.max_bytes}), validated, hash "
              f"{genesis_hash.hex()[:16]}; state_from_genesis, InitChain on a "
              f"KVStoreApplication through LocalClient (app hash "
              f"{res.app_hash.hex()[:16]}), SqliteKV chain store in a temporary "
              f"directory, BlockStore, StateStore, EvidencePool (device None: the "
              f"card), EventBus with one NewBlock subscriber, NopMempool: "
              f"{genesis_s:.2f} s")

        def txs_at(h: int) -> list:
            hexed = rng.bytes(BLOCKEXEC_TXS * BLOCKEXEC_TX_BYTES // 2).hex().encode()
            out = []
            for i in range(BLOCKEXEC_TXS):
                head = b"h%d-%05d=" % (h, i)
                o = i * BLOCKEXEC_TX_BYTES
                out.append(head + hexed[o : o + BLOCKEXEC_TX_BYTES - len(head)])
            return out

        changed = pubs[BLOCKEXEC_CHANGED]
        sign_s = {}

        def sign_commit(h: int, bid, vals) -> Commit:
            t0 = time.perf_counter()
            base_ns = (BLOCKEXEC_T0 + 6 * h + 1) * 10**9
            sigs = []
            for i, v in enumerate(vals.validators):
                if i == BLOCKEXEC_ABSENT:
                    sigs.append(CommitSig.absent_sig())
                    continue
                ns = base_ns + 1_000_003 * i
                sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                                      Timestamp(ns // 10**9, ns % 10**9), b""))
            commit = Commit(h, 0, bid, sigs)
            idx = [i for i, cs in enumerate(sigs) if not cs.absent()]
            msgs = commit.all_vote_sign_bytes(BLOCKEXEC_CHAIN, idx)
            jobs = [(key_by_addr[sigs[i].validator_address], m) for i, m in zip(idx, msgs)]
            for i, s in zip(idx, in_chunks(pool_ex, _sign_chunk, jobs, workers)):
                sigs[i].signature = s
            sign_s[h] = time.perf_counter() - t0
            return commit

        def duplicate_vote(h: int):
            vals = sstore.load_validators(h)
            meta = bstore.load_block_meta(h)
            who = vals.validators[BLOCKEXEC_EQUIVOCATOR]
            votes = []
            for c in (0xA0, 0xB0):
                bid = BlockID(bytes([c]) * 32, PartSetHeader(1, bytes([c + 1]) * 32))
                v = Vote(PRECOMMIT_TYPE, h, 0, bid, meta.header.time, who.address,
                         BLOCKEXEC_EQUIVOCATOR)
                v.signature = ref_sign(key_by_addr[who.address], v.sign_bytes(BLOCKEXEC_CHAIN))
                votes.append(v)
            return DuplicateVoteEvidence.from_votes(
                *votes, meta.header.time, who.voting_power, vals.total_voting_power())

        def digest() -> bytes:
            h = hashlib.sha256()
            for k, v in db.iterate():
                h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(8, "big") + v)
            return h.digest()

        def rejected(what: str, block, want_cls, want_msg: str) -> dict:
            """``apply_block`` of a bad copy raises ``want_cls``; the state
            and both stores as they were."""
            before = (digest(), sstore.load().to_json(), bstore.height())
            sigcache.get_cache().clear()
            l0, s0 = cv.launches, vstats.snapshot()["submitted"]["evidence_light"]
            t0 = time.perf_counter()
            try:
                ex.apply_block(state, BlockID(), block)
            except want_cls as e:
                got = str(e)
            else:
                raise SmokeError(f"blockexec: {what} was applied")
            ms = (time.perf_counter() - t0) * 1e3
            check(want_msg in got, f"blockexec: {what}: {want_cls.__name__}({got})")
            after = (digest(), sstore.load().to_json(), bstore.height())
            check(after == before, f"blockexec: {what} changed the state or a store")
            out = {"error": f"{want_cls.__name__}({got})", "ms": round(ms, 3),
                   "ed25519_launches": cv.launches - l0,
                   "evidence_submitted": vstats.snapshot()["submitted"]["evidence_light"] - s0}
            print(f"blockexec: rejected {what}: {out}; state, block store and "
                  f"state store unchanged (digest of every key and value)")
            return out

        # -- the chain --------------------------------------------------------
        for obj, name, label in (
                (ex, "validate_block", "validate_block"),
                (validation, "verify_commit", "verify_commit"),
                (ValidatorSet, "hash", "set_hashes"),
                (Data, "hash", "data_hash"),
                (Commit, "hash", "commit_hash"),
                (execution, "results_hash", "results_hash"),
                (evpool, "check_evidence", "evidence_check"),
                (app, "finalize_block", "finalize_block"),
                (ex, "_update_state", "update_state"),
                (ex, "_commit", "app_commit"),
                (evpool, "update", "evidence_update"),
                (sstore, "save_finalize_block_response", "state_store_writes"),
                (sstore, "save", "state_store_writes"),
                (ex, "_fire_events", "events")):
            timer.wrap(obj, name, label)
        kept_ed, kept_tree = {}, {}
        real_ed, real_tree = cv.verify_core_cuda, csh.tree_words

        def keep_ed(**t):
            kept_ed.setdefault(t["s_ok"].shape[0], {k: v.clone() for k, v in t.items()})
            return real_ed(**t)

        def keep_tree(data, offs):
            n_leaves = offs.shape[0] - 1
            per = data.shape[0] // max(n_leaves, 1)
            # one part set is enough: the plain version scans each 64 KiB
            # leaf's 1,025 blocks one after another
            kind = "part set" if per > BLOCKEXEC_PART // 2 else "hash"
            if kind == "hash" or not any(k[0] == kind for k in kept_tree):
                kept_tree.setdefault((kind, n_leaves, per), (data.clone(), offs.clone()))
            return real_tree(data, offs)

        cv.verify_core_cuda, csh.tree_words = keep_ed, keep_tree
        undo_keep.append(lambda: setattr(cv, "verify_core_cuda", real_ed))
        undo_keep.append(lambda: setattr(csh, "tree_words", real_tree))
        ds.reset()
        cv.reset_launches()
        csh.reset_launches()
        ev_submitted0 = vstats.snapshot()["submitted"]["evidence_light"]
        last_commit = Commit(0, 0, BlockID(), [])
        rows, block_ids, blocks, rejections = [], {}, {}, {}
        path_ed, path_tree = 0, 0
        for h in range(1, heights + 1):
            txs = txs_at(h)
            if h == BLOCKEXEC_VAL_TX_AT:
                txs[-1] = (b"val:" + base64.b64encode(changed.bytes()) + b"!%d"
                           % BLOCKEXEC_CHANGED_POWER)
            evidence = []
            if h == BLOCKEXEC_EVIDENCE_AT:
                evidence = [duplicate_vote(BLOCKEXEC_EVIDENCE_HEIGHT)]
            proposer = state.validators.get_proposer().address
            block = execution.make_block(h, txs, last_commit, state, proposer,
                                         Timestamp(BLOCKEXEC_T0 + 6 * h, 0))
            if evidence:
                block.evidence = evidence
                block.header.evidence_hash = evidence_list_hash(evidence)
            timer.window()
            l0 = csh.launches
            t0 = time.perf_counter()
            parts = block.make_part_set(BLOCKEXEC_PART)
            part_ms = (time.perf_counter() - t0) * 1e3
            check(csh.launches - l0 == 1, f"blockexec: height {h}: the part set "
                  f"of {parts.header.total} parts took {csh.launches - l0} tree "
                  f"launches, want 1")
            check(parts.byte_size < params.block.max_bytes,
                  f"blockexec: block {h} is {parts.byte_size} bytes, over MaxBytes")
            bid = BlockID(block.hash(), parts.header)
            commit = sign_commit(h, bid, state.validators)
            if h == BLOCKEXEC_EVIDENCE_AT:
                bad = codec.decode_block(codec.encode_block(block))
                vb = bad.evidence[0].vote_b
                vb.signature = vb.signature[:5] + bytes([vb.signature[5] ^ 1]) + vb.signature[6:]
                bad.header.evidence_hash = evidence_list_hash(bad.evidence)
                rejections["evidence"] = rejected(
                    f"a copy of block {h} whose evidence has vote B tampered", bad,
                    execution.InvalidBlockError, "invalid signature on vote B")
            if h == heights:
                bad = codec.decode_block(codec.encode_block(block))
                cs = bad.last_commit.signatures[BLOCKEXEC_BAD_SIG]
                cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
                bad.header.last_commit_hash = b""
                bad.fill_header_hashes()
                rejections["last_commit"] = rejected(
                    f"a copy of block {h} whose LastCommit has a bad signature at "
                    f"index {BLOCKEXEC_BAD_SIG}", bad, validation.InvalidSignatureError,
                    f"index {BLOCKEXEC_BAD_SIG}")
            path_ed += cv.launches
            path_tree += csh.launches
            cv.reset_launches()
            csh.reset_launches()
            sigcache.get_cache().clear()  # a joiner never saw the votes
            t0 = time.perf_counter()
            bstore.save_block(block, parts, commit)
            save_ms = (time.perf_counter() - t0) * 1e3
            timer.window()
            t0 = time.perf_counter()
            state = ex.apply_block(state, bid, block)
            apply_ms = (time.perf_counter() - t0) * 1e3
            split = timer.window()
            torch.cuda.synchronize()
            want_ed = (0 if h == 1 else 1) + (1 if evidence else 0)
            check(cv.launches == want_ed, f"blockexec: height {h}: {cv.launches} "
                  f"Ed25519 launches, want {want_ed} (one per cold LastCommit, one "
                  f"for the evidence's flush)")
            row = {"height": h, "txs": len(block.data.txs), "bytes": parts.byte_size,
                   "parts": parts.header.total, "apply_ms": round(apply_ms, 3),
                   "part_set_ms": round(part_ms, 3), "save_block_ms": round(save_ms, 3),
                   "ed25519_launches": cv.launches, "tree_launches": csh.launches,
                   "split": split}
            rows.append(row)
            print(f"blockexec: height {h}: {json.dumps(row)} {tag}")
            path_ed += cv.launches
            path_tree += csh.launches
            cv.reset_launches()
            csh.reset_launches()
            block_ids[h], blocks[h] = bid, block
            last_commit = commit
        timer.restore()
        for undo in undo_keep:
            undo()

        # -- what the phase asserts ---------------------------------------
        got_events = []
        while (msg := sub.next(timeout=0)) is not None:
            got_events.append(msg.data.block.header.height)
        check(got_events == list(range(1, heights + 1)),
              f"blockexec: NewBlock events for heights {got_events}")
        ev_submitted = vstats.snapshot()["submitted"]["evidence_light"] - ev_submitted0
        check(ev_submitted == 4, f"blockexec: {ev_submitted} evidence signatures "
              f"through the scheduler at PRIO_EVIDENCE, want 2 + 2")
        ed_tiers, tree_tiers = ds.tier_counts(), ds.tier_counts(st.MERKLE)
        for what, counts in (("Ed25519 batches", ed_tiers), ("tree passes", tree_tiers)):
            check(counts["cuda"][0] > 0 and all(
                v == (0, 0) for t, v in counts.items() if t != "cuda"),
                f"blockexec: {what} served below the cuda tier: {counts}")
        check(ed_tiers["cuda"][0] == path_ed and tree_tiers["cuda"][0] == path_tree,
              f"blockexec: launches {path_ed} / {path_tree} != cuda batches "
              f"{ed_tiers['cuda']} / tree passes {tree_tiers['cuda']}")
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
        check(not leaked, f"blockexec: imported {leaked}")
        final = state
        applied = [r["apply_ms"] for r in rows]
        print(f"blockexec: {heights} blocks of {BLOCKEXEC_TXS} txs of "
              f"{BLOCKEXEC_TX_BYTES} bytes applied and persisted; block "
              f"{BLOCKEXEC_VAL_TX_AT} raised validator {BLOCKEXEC_CHANGED}'s power "
              f"to {BLOCKEXEC_CHANGED_POWER} (the set changed at height "
              f"{BLOCKEXEC_VAL_TX_AT + 2}), block {BLOCKEXEC_EVIDENCE_AT} carried a "
              f"duplicate vote of height {BLOCKEXEC_EVIDENCE_HEIGHT}; "
              f"{len(got_events)} NewBlock events; evidence checked in scheduler "
              f"flushes at PRIO_EVIDENCE ({ev_submitted} signatures); Ed25519 "
              f"batches by tier {ed_tiers}, tree passes by tier {tree_tiers} "
              f"(each part set one launch); launches on the path "
              f"Ed25519 {path_ed}, tree {path_tree}; jax not imported")
        print(f"blockexec: apply_block wall per height {applied} ms, median of "
              f"heights 2-{heights} {statistics.median(applied[1:])} ms {tag}")
        print(f"blockexec: signing (data set-up, not the path): "
              f"{ {h: round(s, 2) for h, s in sign_s.items()} } s per commit of "
              f"{n - 1} signatures on {workers} processes")

        # -- the kernels against their plain versions, on the path's inputs
        from cometbft_tpu_torch.ops import verify as ov

        worst_ed = worst_tree = 0
        for lanes, t in sorted(kept_ed.items()):
            kern, plain = cv.verify_core_cuda(**t), ov.verify_core(**t)
            worst_ed = max(worst_ed, int((kern.int() - plain.int()).abs().max()))
            check(torch.equal(kern, plain), f"blockexec: Ed25519 kernel != plain at {lanes} lanes")
        plain_tree_s, part_kernel_ms = time.perf_counter(), None
        for (kind, leaves, per), (data, offs) in sorted(kept_tree.items()):
            kern, plain = csh.tree_words(data, offs), st.tree_words_plain(data, offs)
            worst_tree = max(worst_tree, int((kern.long() - plain.long()).abs().max()))
            check(torch.equal(kern, plain), f"blockexec: tree kernel != plain at "
                  f"{leaves} leaves of ~{per} bytes ({kind})")
            if kind == "part set":
                part_kernel_ms = cuda_ms(torch, lambda: csh.tree_words(data, offs),
                                         runs=5, warmup=1, queued=True)
        plain_tree_s = time.perf_counter() - plain_tree_s
        check(part_kernel_ms is not None, "blockexec: no part set reached the tree kernel")
        print(f"blockexec: on the path's own inputs, the Ed25519 kernel == its plain "
              f"version bit for bit at {sorted(kept_ed)} lanes (max_abs_err "
              f"{worst_ed}) and the tree kernel at (kind, leaves, bytes a leaf) "
              f"{sorted(kept_tree)} (max_abs_err {worst_tree}; the plain trees "
              f"took {plain_tree_s:.1f} s); the part set's tree pass "
              f"{part_kernel_ms} ms on the card (CUDA events, queued) {tag}")

        # -- the stores reopened ------------------------------------------
        db.close()
        t0 = time.perf_counter()
        db = SqliteKV(path, surface="state")
        bstore, sstore = BlockStore(db), StateStore(db)
        open_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = sstore.load()
        load_state_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        vals4 = sstore.load_validators(BLOCKEXEC_VAL_TX_AT + 2)
        load_vals_ms = (time.perf_counter() - t0) * 1e3
        check(loaded.to_json() == final.to_json() and loaded.app_hash == app.app_hash
              and loaded.validators.hash() == final.validators.hash()
              and loaded.last_block_id == block_ids[heights],
              "blockexec: the reopened state store != the final state")
        powers = collections.Counter(v.voting_power for v in vals4.validators)
        _, v4 = vals4.get_by_address(changed.address())
        check(v4.voting_power == BLOCKEXEC_CHANGED_POWER and powers[1] == n - 1,
              f"blockexec: load_validators({BLOCKEXEC_VAL_TX_AT + 2}) powers {powers}")
        load_block_ms = []
        for h in range(1, heights + 1):
            t0 = time.perf_counter()
            b = bstore.load_block(h)
            load_block_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            check(b.hash() == block_ids[h].hash, f"blockexec: reopened block {h} hashes "
                  f"differently")
        check(bstore.height() == heights and bstore.base() == 1, "blockexec: store range")
        db.close()
        print(f"blockexec: reopened the SQLite store ({open_ms:.3f} ms): "
              f"StateStore.load() {load_state_ms:.3f} ms == the final state (app "
              f"hash, validators hash, last block id); load_validators("
              f"{BLOCKEXEC_VAL_TX_AT + 2}) {load_vals_ms:.3f} ms with validator "
              f"{BLOCKEXEC_CHANGED} at power {BLOCKEXEC_CHANGED_POWER}; "
              f"BlockStore.load_block per height {load_block_ms} ms, each hashing "
              f"to its block id {tag}")
        handed = True
    finally:
        timer.restore()
        for undo in undo_keep:
            undo()
        verifysched.reset_scheduler()
        pool_ex.shutdown(wait=True, cancel_futures=True)
        if not handed:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"ed25519": path_ed, "tree": path_tree, "dir": tmp, "db": path,
            "genesis": gdoc, "keys": keys, "app": app}


def sim_digest(res) -> dict:
    """What a scenario's card run and its CPU run must agree on: heights,
    events, the commit hash at every height, the trace line for line (with
    dial-storm's AEAD digests and light-stampede's proof-response digests),
    the scheduler's, proof plane's and transport plane's blocks of
    ``summary()``, but for one count: a restarted node's postmortem line counts the records
    of its black box, which holds the spans its verify path recorded (on
    the card the scheduler's flushes and the kernel's dispatches, on a CPU
    verifying on the host none), so ``records=`` is kept apart, in
    ``journal_records``."""
    top = max(res.heights)
    trace, records = [], []
    for ln in res.trace:
        m = re.search(r" postmortem: .*\brecords=(\d+)", ln)
        if m:
            records.append(int(m.group(1)))
            ln = ln.replace(f"records={m.group(1)}", "records=*")
        trace.append(ln)
    row = res.summary()
    return {"heights": res.heights, "events": res.events,
            "virtual_time": round(res.virtual_time, 6),
            "planes": {k: row.get(k) for k in ("sched", "proofs", "transport")},
            "commits": [res.cluster.commit_hash(h).hex() for h in range(1, top + 1)],
            "trace": trace, "journal_records": records,
            "violations": len(res.violations)}


def sim_child(path: str, names: str) -> int:
    """The sim phase's CPU side, in a fresh process with
    ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` (the verify scheduler's gate is
    process-wide: once the card's self-check has passed, an in-process run
    on the CPU would still send its votes to the card): each scenario of
    ``names`` (comma-separated, of SIM_AGAINST_CPU) at its seed, its
    ``sim_digest`` and the tiers that served its kernels' batches
    (``dispatch_stats``: never ``cuda`` here)."""
    from cometbft_tpu_torch.ops import dispatch_stats as ds
    from cometbft_tpu_torch.sim import run_scenario

    check(os.environ.get("COMETBFT_TPU_CRYPTO_BACKEND") == "cpu",
          "sim child: COMETBFT_TPU_CRYPTO_BACKEND is not cpu")
    runs = {name: (seed, kw) for name, seed, kw in SIM_SCENARIOS}
    out = {}
    for name in names.split(","):
        seed, kw = runs[name]
        ds.reset()
        with tempfile.TemporaryDirectory(prefix=f"sim-{name}-") as d:
            res = run_scenario(name, seed, root=d, keep_cluster=True, **kw)
            out[name] = dict(sim_digest(res), tiers={
                k: ds.tier_counts(t) for k, t in SIM_TIER_KEYS.items()})
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


class NodeTimer:
    """Wall ms of named calls of one validator, summed per (height, label):
    ``wrap`` replaces ``obj.name`` (an instance's attribute) with a timing
    wrapper keyed by the node's consensus height at the call."""

    def __init__(self):
        self.ms = collections.defaultdict(float)

    def wrap(self, cs, obj, name: str, label: str) -> None:
        real = getattr(obj, name)
        ms = self.ms

        def timed(*a, **kw):
            h = cs.rs.height
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                ms[(h, label)] += (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed)

    def medians(self, heights) -> dict:
        labels = sorted({k for _, k in self.ms})
        return {k: round(statistics.median(self.ms.get((h, k), 0.0) for h in heights), 3)
                for k in labels}


class ErrorLog:
    """The logger of a phase-18 validator: keeps its errors (a consensus
    failure logs one and carries on), drops the rest."""

    def __init__(self, index: int, into: list):
        self.index, self.into = index, into

    def error(self, msg: str, **kv) -> None:
        self.into.append((self.index, msg, kv.get("err", "")))

    def debug(self, msg: str, **kv) -> None:
        pass

    info = warn = debug


def consensus_phase(torch, dev, cbatch, cv, ds, sigcache, tag) -> dict:
    """Phase 18: the consensus core.  Part A: four threaded validators at
    CometBFT's default settings, each built by ``sim/node.build_node`` on
    the card with an on-disk root, wired by a loopback relay, full mempools
    before each height; one is stopped after CONSENSUS_HEIGHTS, rebuilt
    from its stores (its WAL replayed, the Handshaker replaying the app)
    and signs again.  (The seeded virtual-time network, card against CPU,
    is the sim phase's.)  Returns {"ed25519": launches, "tree": launches}."""
    import pathlib
    import threading

    import numpy as np

    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.config.config import ConsensusConfig, MempoolConfig
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage, VoteMessage)
    from cometbft_tpu_torch.consensus.types import STEP_COMMIT, STEP_PREVOTE
    from cometbft_tpu_torch.mempool.clist_mempool import MempoolError
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.sim.node import build_node, make_genesis
    from cometbft_tpu_torch.state.state import state_from_genesis
    from cometbft_tpu_torch.types.basic import BLOCK_ID_FLAG_COMMIT
    from cometbft_tpu_torch.types.block import commit_vote
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.verifysched import stats as vstats

    t_phase = time.perf_counter()
    n_nodes, who = CONSENSUS_NODES, CONSENSUS_RESTARTED
    cfg, mcfg = ConsensusConfig(), MempoolConfig()
    privs, gdoc = make_genesis(n_nodes, CONSENSUS_CHAIN)
    params = state_from_genesis(gdoc).consensus_params
    root = pathlib.Path(tempfile.mkdtemp(prefix="consensus-"))
    nodes: list = [None] * n_nodes
    timers = [NodeTimer() for _ in range(n_nodes)]
    errors: list = []  # (node, message, error) logged by the validators
    hook_errors: list = []  # what the phase's own hooks raised
    seen: set = set()  # distinct proposal and vote signatures on the wire
    catchups = collections.Counter()
    txs_cache, txs_lock, fed = {}, threading.Lock(), {}
    feed_ms = collections.defaultdict(list)
    admitted = collections.defaultdict(list)
    vote_lat: list = []
    kept_ed, kept_tree = {}, {}
    real_ed, real_tree, real_verify = cv.verify_core_cuda, csh.tree_words, Vote.verify
    stop_relay = threading.Event()
    relay = None

    def txs_at(h: int) -> list:
        with txs_lock:
            if h not in txs_cache:
                rng = np.random.default_rng([CONSENSUS_SEED, h])
                hexed = rng.bytes(CONSENSUS_TXS * CONSENSUS_TX_BYTES // 2).hex().encode()
                out = []
                for i in range(CONSENSUS_TXS):
                    head = b"c%d-%04d=" % (h, i)
                    o = i * CONSENSUS_TX_BYTES
                    out.append(head + hexed[o : o + CONSENSUS_TX_BYTES - len(head)])
                txs_cache[h] = out
            return txs_cache[h]

    def feed(node, h: int) -> None:
        """Offer ``node``'s mempool height ``h``'s txs (the relay stands in
        for the mempool reactor)."""
        if fed.get(node.index, 0) >= h:
            return
        fed[node.index] = h
        t0 = time.perf_counter()
        ok = 0
        for tx in txs_at(h):
            try:
                node.mempool.check_tx(tx)
                ok += 1
            except MempoolError:
                pass
        feed_ms[node.index].append(round((time.perf_counter() - t0) * 1e3, 3))
        admitted[node.index].append(ok)

    def wire(node) -> None:
        """The loopback relay (tests/net_harness.py's LoopbackNet): every
        message a validator makes goes to the other live validators'
        queues; after each height its mempool is offered the next
        height's txs; its apply path is timed call by call."""
        i = node.index

        def broadcast(msg):
            if isinstance(msg, ProposalMessage):
                seen.add(msg.proposal.signature)
            elif isinstance(msg, VoteMessage):
                seen.add(msg.vote.signature)
            for peer in list(nodes):
                if peer is not None and peer.index != i:
                    peer.cs.add_peer_message(msg, peer_id=f"node{i}")

        real_update = node.cs.update_to_state

        def update_to_state(state):
            real_update(state)
            try:
                feed(node, state.last_block_height + 1)
            except BaseException as e:  # noqa: BLE001 — the main loop raises it
                hook_errors.append((i, repr(e)))
                raise

        node.cs.broadcast_hook = broadcast
        node.cs.update_to_state = update_to_state
        node.cs.logger = ErrorLog(i, errors)
        tm, ex = timers[i], node.cs.block_exec
        for obj, name, label in (
                (ex, "apply_verified_block", "apply_verified_block"),
                (ex, "validate_block", "validate_block"),
                (node.app, "finalize_block", "finalize_block"),
                (ex, "_update_state", "update_state"),
                (ex, "_commit", "app_commit"),
                (node.evidence_pool, "update", "evidence_update"),
                (node.state_store, "save_finalize_block_response", "state_store_writes"),
                (node.state_store, "save", "state_store_writes"),
                (ex, "_fire_events", "events"),
                (node.block_store, "save_block", "save_block")):
            tm.wrap(node.cs, obj, name, label)

    def catchup_loop() -> None:
        """The reactor's gossipDataForCatchup, as the sim's catchup tick: a
        validator still working on a height another has stored gets that
        height's seen-commit votes and block parts, once it has been
        behind at two scans in a row (a validator a few ms behind its
        peers' commit gets nothing)."""
        behind: dict = {}
        while not stop_relay.wait(CONSENSUS_CATCHUP_S):
            live = [n for n in nodes if n is not None]
            for node in live:
                want = node.cs.rs.height
                helper = next((p for p in live if p.index != node.index
                               and p.block_store.height() >= want), None)
                was, behind[node.index] = behind.get(node.index), (
                    want if helper is not None else None)
                if helper is None or was != want:
                    continue
                commit = helper.block_store.load_seen_commit(want)
                meta = helper.block_store.load_block_meta(want)
                if commit is None or meta is None:
                    continue
                catchups[node.index] += 1
                peer = f"node{helper.index}"
                for idx in range(len(commit.signatures)):
                    vote = commit_vote(commit, idx)
                    if vote is not None:
                        node.cs.add_peer_message(VoteMessage(vote), peer_id=peer)
                for pi in range(meta.block_id.part_set_header.total):
                    part = helper.block_store.load_block_part(want, pi)
                    if part is not None:
                        node.cs.add_peer_message(
                            BlockPartMessage(height=want, round_=commit.round_, part=part),
                            peer_id=peer)

    def keep_ed(**t):
        kept_ed.setdefault(int(t["s_ok"].shape[0]), {k: v.clone() for k, v in t.items()})
        return real_ed(**t)

    def keep_tree(data, offs):
        kept_tree.setdefault(int(offs.shape[0]) - 1, (data.clone(), offs.clone()))
        return real_tree(data, offs)

    def timed_verify(self, chain_id, pub_key):
        t0 = time.perf_counter()
        try:
            return real_verify(self, chain_id, pub_key)
        finally:
            vote_lat.append(time.perf_counter() - t0)

    def live() -> list:
        return [n for n in nodes if n is not None]

    def heights() -> list:
        return [-1 if n is None else n.block_store.height() for n in nodes]

    rows, marks = [], {}

    def mark() -> None:
        """A row per height once every live validator has stored it: the
        wall and the launches since the previous one."""
        low = min(n.block_store.height() for n in live())
        while marks["h"] < low:
            h = marks["h"] = marks["h"] + 1
            now, cuda = time.perf_counter(), ds.tier_counts()["cuda"]
            meta = live()[0].block_store.load_block_meta(h)
            commit = live()[0].block_store.load_seen_commit(h)
            batches, lanes = cuda[0] - marks["cuda"][0], cuda[1] - marks["cuda"][1]
            rows.append({
                "height": h, "wall_ms": round((now - marks["t"]) * 1e3, 3),
                "rounds": commit.round_ + 1, "txs": meta.num_txs,
                "parts": meta.block_id.part_set_header.total,
                "ed25519_launches": cv.launches - marks["ed"],
                "lanes_per_launch": round(lanes / batches, 3) if batches else None,
                "tree_launches": csh.launches - marks["tree"]})
            print(f"consensus: height {json.dumps(rows[-1])} {tag}")
            marks.update(t=now, cuda=cuda, ed=cv.launches, tree=csh.launches)

    def run_until(done, what: str) -> None:
        deadline = time.perf_counter() + CONSENSUS_TIMEOUT_S
        while not done():
            check(not hook_errors, f"consensus: a feed raised: {hook_errors}")
            check(time.perf_counter() < deadline, f"consensus: {what} not reached in "
                  f"{CONSENSUS_TIMEOUT_S} s: heights {heights()}, consensus heights "
                  f"{[n.cs.rs.height for n in live()]}, errors {errors[:5]}")
            mark()
            time.sleep(0.01)
        mark()

    try:
        # -- part A: four threaded validators on the card -------------------
        t0 = time.perf_counter()
        for i in range(n_nodes):
            nodes[i] = build_node(i, privs[i], gdoc, root, config=cfg, threaded=True,
                                  mempool_config=mcfg)
        build_s = time.perf_counter() - t0
        active = verifysched.scheduler_active()
        check(active, "consensus: the verify scheduler is not active after build_node "
              "(its gate would send the first votes to verify_now on the host)")
        for node in nodes:
            wire(node)
            feed(node, 1)
        print(f"consensus: {n_nodes} validators (make_genesis, chain "
              f"{CONSENSUS_CHAIN!r}) built by sim/node.build_node on the card in "
              f"{build_s:.2f} s, each with an on-disk root (pv_key.json, "
              f"pv_state.json, cs.wal) and a MemKV; ConsensusConfig() (propose "
              f"{cfg.timeout_propose_ms} ms +{cfg.timeout_propose_delta_ms}, vote "
              f"{cfg.timeout_vote_ms} +{cfg.timeout_vote_delta_ms}, commit "
              f"{cfg.timeout_commit_ms}), MempoolConfig() (size {mcfg.size}, recheck "
              f"{mcfg.recheck}), block max_bytes {params.block.max_bytes}; the "
              f"scheduler active before the first start: {active}; each mempool "
              f"offered {CONSENSUS_TXS} txs of {CONSENSUS_TX_BYTES} bytes before "
              f"each height (seed {CONSENSUS_SEED})")
        cv.verify_core_cuda, csh.tree_words, Vote.verify = keep_ed, keep_tree, timed_verify
        ds.reset()
        vstats.reset()
        cv.reset_launches()
        csh.reset_launches()
        marks.update(h=0, t=time.perf_counter(), cuda=(0, 0), ed=0, tree=0)
        t_run = time.perf_counter()
        for node in nodes:
            node.cs.start()
        relay = threading.Thread(target=catchup_loop, name="relay-catchup", daemon=True)
        relay.start()
        run_until(lambda: min(heights()) >= CONSENSUS_HEIGHTS,
                  f"height {CONSENSUS_HEIGHTS} on every validator")
        first_wall = time.perf_counter() - t_run

        # -- stop one validator, rebuild it from its stores -----------------
        victim = nodes[who]
        home = root / f"node{who}"
        # mid-height, between its proposal and its commit: the WAL then holds
        # the proposal, parts and votes its replay verifies again.  Each
        # message takes far less than stop()'s 5 s join, so the receive
        # thread has left before stop() closes the WAL
        run_until(lambda: victim.cs.rs.height > CONSENSUS_HEIGHTS
                  and STEP_PREVOTE <= victim.cs.rs.step < STEP_COMMIT,
                  f"node{who} between a proposal and a commit")
        nodes[who] = None
        stopped_at = victim.block_store.height()
        victim.cs.stop()
        victim.app_conns.stop()
        check(victim.cs._thread is None or not victim.cs._thread.is_alive(),
              f"consensus: node{who}'s receive thread outlived stop()")
        pv_before = json.loads((home / "pv_state.json").read_text())
        sigcache.reset_cache()  # its replay verifies on the card again
        l0 = cv.launches
        t0 = time.perf_counter()
        node = build_node(who, privs[who], gdoc, root, config=cfg,
                          db=victim.block_store._db, threaded=True, mempool_config=mcfg)
        handshake_s = time.perf_counter() - t0
        records = len(node.cs.wal.replay_after_height(node.cs.state.last_block_height))
        replayed_blocks = node.block_store.height()
        fed.pop(who, None)
        wire(node)
        feed(node, node.cs.rs.height)
        t1 = time.perf_counter()
        node.cs.start()  # the WAL's catchup replay runs here
        wal_s = time.perf_counter() - t1
        replay_launches = cv.launches - l0
        nodes[who] = node
        print(f"consensus: node{who} stopped in height {stopped_at + 1} (pv_state "
              f"{pv_before['height']}/{pv_before['round']}/{pv_before['step']}); "
              f"signature cache cleared; rebuilt from its MemKV and root: "
              f"build_node (the Handshaker: InitChain and {replayed_blocks} blocks "
              f"replayed into a fresh app) {handshake_s * 1e3:.3f} ms, the WAL's "
              f"catchup replay of {records} records {wal_s * 1e3:.3f} ms, "
              f"{replay_launches} Ed25519 launches during the replay {tag}")
        run_until(lambda: node.cs.rs.height >= max(n.cs.rs.height for n in live()),
                  f"node{who} caught up")
        # the next height to start: node3 takes part in it from its proposal
        h0 = max(n.cs.rs.height for n in live()) + 1
        # one height more: block h + 1's LastCommit is the record of who
        # signed h (a precommit that lands after a node's +2/3 is not in
        # that node's seen commit, but the next proposer collects it)
        run_until(lambda: min(heights()) >= h0 + CONSENSUS_AFTER,
                  f"height {h0 + CONSENSUS_AFTER} on every validator")
        wall = time.perf_counter() - t_run
        stop_relay.set()
        relay.join(10)
        for n in live():
            n.cs.stop()
            n.app_conns.stop()
        ed_launches, tree_launches = cv.launches, csh.launches
        cv.verify_core_cuda, csh.tree_words, Vote.verify = real_ed, real_tree, real_verify
        snap = vstats.snapshot()
        top = min(heights())

        # -- what part A asserts --------------------------------------------
        for h in range(1, top + 1):
            ids = {n.block_store.load_block_meta(h).block_id.hash for n in nodes}
            apps = {(n.block_store.load_block_meta(h + 1).header.app_hash
                     if n.block_store.height() > h else n.state_store.load().app_hash)
                    for n in nodes}
            check(len(ids) == 1 and len(apps) == 1, f"consensus: height {h}: "
                  f"{len(ids)} block hashes, {len(apps)} app hashes across the nodes")
        st_json = node.state_store.load().to_json()
        last = node.block_store.load_block_meta(node.block_store.height())
        check(st_json == node.cs.state.to_json()
              and node.cs.state.last_block_height == node.block_store.height()
              and node.cs.state.last_block_id == last.block_id
              and node.cs.state.app_hash == node.app.app_hash,
              f"consensus: node{who}'s state != its stores")
        pv_after = json.loads((home / "pv_state.json").read_text())
        hrs = lambda d: (int(d["height"]), int(d["round"]), int(d["step"]))
        check(hrs(pv_after) >= hrs(pv_before), f"consensus: node{who}'s pv_state stepped "
              f"back: {hrs(pv_before)} -> {hrs(pv_after)}")
        addr = privs[who].pub_key().address()
        signed = {}

        def has(c) -> bool:
            return any(cs.validator_address == addr
                       and cs.block_id_flag == BLOCK_ID_FLAG_COMMIT for cs in c.signatures)

        for h in range(h0, h0 + CONSENSUS_AFTER):
            commits = [n.block_store.load_seen_commit(h) for n in nodes]
            in_last = has(nodes[0].block_store.load_block(h + 1).last_commit)
            signed[h] = {"last_commit": in_last, "seen_commits": sum(map(has, commits))}
            check(in_last or signed[h]["seen_commits"],
                  f"consensus: node{who} signed no commit of height "
                  f"{h}: pv_state {hrs(pv_after)}, its errors "
                  f"{[e for e in errors if e[0] == who][:5]}, flags "
                  f"{[[cs.block_id_flag for cs in c.signatures] for c in commits]}")
        evidence = [ev for n in nodes for h in range(1, top + 1)
                    for ev in n.block_store.load_block(h).evidence]
        pending = [len(n.evidence_pool.pending_evidence(1 << 30)[0]) for n in nodes]
        check(not evidence and not any(pending), f"consensus: evidence {evidence} "
              f"pending {pending}: a duplicate vote")
        submitted = snap["submitted"]["consensus"]
        check(submitted >= len(seen), f"consensus: {submitted} consensus-class "
              f"submissions < {len(seen)} distinct proposals and votes")
        check(snap["shed_fallback_total"] == 0, f"consensus: shed fallbacks {snap['shed_fallback']}")
        ed_tiers, tree_tiers = ds.tier_counts(), ds.tier_counts(st.MERKLE)
        oversize = ds.tier_counts(st.MERKLE_OVERSIZE)
        check(ed_tiers["cuda"][0] > 0 and ed_tiers["torch"] == (0, 0)
              and ed_tiers["host"] == (0, 0),
              f"consensus: Ed25519 batches below the cuda tier: {ed_tiers}")
        check(ed_tiers["cuda"][0] == ed_launches, f"consensus: {ed_launches} Ed25519 "
              f"launches != {ed_tiers['cuda'][0]} batches served (a batch raised)")
        check(tree_tiers["cuda"][0] == tree_launches > 0 and tree_tiers["torch"] == (0, 0)
              and tree_tiers["host"] == oversize["host"],
              f"consensus: tree passes {tree_tiers} (oversize {oversize}), launches "
              f"{tree_launches}")
        raised = [e for e in errors if "BackendError" in e[2] or "PoisonedInput" in e[2]]
        check(not raised, f"consensus: a verify raised: {raised[:3]}")
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
        check(not leaked, f"consensus: imported {leaked}")
        lat = np.array(vote_lat) * 1e3
        hist = snap["latency_hist"]["consensus"]
        print(f"consensus: heights 1-{top} committed by all {n_nodes} validators in "
              f"{wall:.2f} s ({CONSENSUS_HEIGHTS} in {first_wall:.2f} s before the "
              f"restart); one block hash and one app hash per height on every node; "
              f"node{who} resumed: state == its stores, pv_state {hrs(pv_before)} -> "
              f"{hrs(pv_after)}, signed heights {h0}-{h0 + CONSENSUS_AFTER - 1} (in "
              f"block h + 1's LastCommit, in how many seen commits): {signed}, no "
              f"evidence; catchup sends per node "
              f"{dict(catchups)}; {len(seen)} distinct proposals and votes, "
              f"{submitted} consensus-class submissions ({snap['submit_hits']['consensus']}"
              f" hits at submit, {snap['dedup_hits']} deduplicated in flushes), shed "
              f"fallbacks {snap['shed_fallback_total']}; Ed25519 batches by tier "
              f"{ed_tiers} = {ed_launches} launches; tree passes by tier {tree_tiers}, "
              f"{tree_launches} launches, merkle_oversize {oversize['host']}; "
              f"consensus failures logged {len(errors)} "
              f"{collections.Counter(e[2].split('(')[0] for e in errors)} (first "
              f"{errors[:3]}); jax not imported {tag}")
        wait, devh = (snap[k]["consensus"] for k in ("queue_wait_hist", "device_hist"))
        print(f"consensus: vote-verify latency (Vote.verify wall, {len(lat)} calls) "
              f"p50 {float(np.percentile(lat, 50))} ms, p99 "
              f"{float(np.percentile(lat, 99))} ms; verifysched/stats consensus class "
              f"(bucket bounds) submit to verdict p50 <= {hist['p50'] * 1e3} ms, p99 <= "
              f"{hist['p99'] * 1e3} ms, mean "
              f"{snap['latency_seconds']['consensus'] / max(1, snap['verdicts']['consensus']) * 1e3} ms "
              f"over {snap['verdicts']['consensus']} verdicts; of it the queue wait p50 <= "
              f"{wait['p50'] * 1e3}, p99 <= {wait['p99'] * 1e3} ms and dispatch to fetch "
              f"p50 <= {devh['p50'] * 1e3}, p99 <= {devh['p99'] * 1e3} ms {tag}")
        mid = [r["height"] for r in rows if 2 <= r["height"] <= top]
        for i in range(n_nodes):
            print(f"consensus: node{i} apply split, median of heights {mid[0]}-"
                  f"{mid[-1]} (ms; validate_block twice a height: the proposal and "
                  f"the commit): {json.dumps(timers[i].medians(mid))}; mempool feed "
                  f"ms {feed_ms[i]}, admitted {admitted[i]} {tag}")

        # -- the kernels against their plain versions, on the path's inputs
        worst_ed = worst_tree = 0
        for lanes, t in sorted(kept_ed.items()):
            kern, plain = cv.verify_core_cuda(**t), ov.verify_core(**t)
            worst_ed = max(worst_ed, int((kern.int() - plain.int()).abs().max()))
            check(torch.equal(kern, plain), f"consensus: Ed25519 kernel != plain at {lanes} lanes")
        for leaves, (data, offs) in sorted(kept_tree.items()):
            kern, plain = csh.tree_words(data, offs), st.tree_words_plain(data, offs)
            worst_tree = max(worst_tree, int((kern.long() - plain.long()).abs().max()))
            check(torch.equal(kern, plain), f"consensus: tree kernel != plain at {leaves} leaves")
        check(kept_ed and kept_tree, "consensus: no input reached a kernel")
        mean_lanes = ed_tiers["cuda"][1] / ed_tiers["cuda"][0]
        ed_lanes = min(kept_ed, key=lambda k: abs(k - mean_lanes))
        ed_ms = cuda_ms(torch, lambda: cv.verify_core_cuda(**kept_ed[ed_lanes]), 10, 2,
                        queued=True)
        tree_leaves = max(kept_tree)
        tree_ms = cuda_ms(torch, lambda: csh.tree_words(*kept_tree[tree_leaves]), 10, 2,
                          queued=True)
        busy = (ed_launches * ed_ms + tree_launches * tree_ms) / (wall * 1e3)
        print(f"consensus: on the path's own inputs, the Ed25519 kernel == its plain "
              f"version bit for bit at {sorted(kept_ed)} lanes (max_abs_err {worst_ed}) "
              f"and the tree kernel at {sorted(kept_tree)} leaves (max_abs_err "
              f"{worst_tree}); device time alone {ed_ms} ms at {ed_lanes} lanes and "
              f"{tree_ms} ms at {tree_leaves} leaves (CUDA events, queued): the card "
              f"busy ~{busy:.4%} of the run's {wall:.2f} s (derived: launches x those "
              f"times) {tag}")

        print(f"consensus: the phase took {time.perf_counter() - t_phase:.1f} s")
    finally:
        cv.verify_core_cuda, csh.tree_words, Vote.verify = real_ed, real_tree, real_verify
        stop_relay.set()
        for n in live():
            n.cs.stop()
            n.app_conns.stop()
        verifysched.reset_scheduler()
        shutil.rmtree(root, ignore_errors=True)
    return {"ed25519": ed_launches, "tree": tree_launches}


def sim_phase(torch, ds, tag) -> dict:
    """Phase 18b: the port's deterministic simulator on the card, through
    ``sim/scenarios.run_scenario`` with ``device=None`` (no stand-in at any
    seam: the kernels answer), the scenarios of SIM_SCENARIOS at their
    seeds; the CPU children of SIM_AGAINST_CPU run beside them.  Returns
    {"ed25519", "tree", "aead", "ladder": launches} of the phase."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.crypto.backend_health import BackendError
    from cometbft_tpu_torch.ops import cuda_aead, cuda_sha256, cuda_verify, cuda_x25519
    from cometbft_tpu_torch.ops import supervisor
    from cometbft_tpu_torch.sim import run_scenario

    t_phase = time.perf_counter()
    # the card's known-answer self-check (once a process; earlier phases
    # ran it) launches outside every scenario's count, so each kernel's
    # batches served on cuda equal its launches there
    cbatch.default_backend()
    kernels = {"ed25519": cuda_verify, "tree": cuda_sha256, "aead": cuda_aead,
               "ladder": cuda_x25519}
    tmp = tempfile.mkdtemp(prefix="sim-phase-")
    env = dict(os.environ, COMETBFT_TPU_CRYPTO_BACKEND="cpu")
    children = []  # (process, output path)
    for i, names in enumerate(SIM_CHILDREN):
        out_path = os.path.join(tmp, f"cpu{i}.json")
        children.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sim-child", out_path,
             ",".join(names)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), out_path))
    # the brownout's accounting, batch by batch (the scheduler is off there
    # and the sim is one thread, so a supervised verify's injected faults
    # are its own): raised with a fault injected in it (bisection's halves
    # included), raised with none (an open breaker refused it), served
    # with a fault injected in it (must not happen: nothing answers below
    # the kernel)
    acct = collections.Counter()
    shims = []
    real_sup = supervisor.verify_supervised
    real_shim = supervisor.FaultyBackend

    def faults() -> int:
        return sum(sh.faults for sh in shims)

    depth = threading.local()

    def counted_sup(*a, **kw):
        # the outermost call alone: the mesh's floor re-enters here
        if getattr(depth, "n", 0):
            return real_sup(*a, **kw)
        depth.n = 1
        before = faults()
        try:
            out = real_sup(*a, **kw)
        except BackendError:
            acct["raised_faulted" if faults() > before else "raised_refused"] += 1
            raise
        finally:
            depth.n = 0
        if faults() > before:
            acct["served_faulted"] += 1
        return out

    class Shim(real_shim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            shims.append(self)

    totals = collections.Counter()
    digests = {}
    try:
        supervisor.verify_supervised = counted_sup
        supervisor.FaultyBackend = Shim
        for name, seed, kw in SIM_SCENARIOS:
            for mod in kernels.values():
                mod.reset_launches()
            ds.reset()
            sigcache.reset_cache()
            acct.clear()
            shims.clear()
            t0 = time.perf_counter()
            res = run_scenario(name, seed, root=os.path.join(tmp, name), keep_cluster=True,
                               **kw)
            wall = time.perf_counter() - t0
            launches = {k: mod.launches for k, mod in kernels.items()}
            totals.update(launches)
            tiers = {k: ds.tier_counts(t) for k, t in SIM_TIER_KEYS.items()}
            ok = not res.violations
            check(res.reached and ok, f"sim: {name} seed {seed} reached {res.reached}, "
                  f"heights {res.heights}, violations {res.violations[:3]}")
            for k, t in tiers.items():
                # a mesh batch is a launch a shard (and a probe one more)
                served = (t["cuda"][0] <= launches[k] if name in SIM_MESH and k == "ed25519"
                          else t["cuda"][0] == launches[k])
                check(t["torch"] == (0, 0) and t["host"] == (0, 0) and served,
                      f"sim: {name}: {k} batches off the kernel: {t}, {launches[k]} launches")
            print(f"sim: {name} seed {seed}: virtual {res.virtual_time:.3f} s, wall "
                  f"{wall:.2f} s, {res.events} events, heights {res.heights}, launches "
                  f"Ed25519 {launches['ed25519']} tree {launches['tree']} AEAD "
                  f"{launches['aead']} ladder {launches['ladder']}, tiers (batches, "
                  f"items) {json.dumps({k: t['cuda'] for k, t in tiers.items()})} on cuda, "
                  f"reached {res.reached}, invariants_ok {ok} {tag}")
            if name in SIM_AGAINST_CPU:
                digests[name] = json.loads(json.dumps(sim_digest(res)))
                check(launches["ed25519"] > 0, f"sim: {name} launched no Ed25519 kernel")
            if name in SIM_MESH:
                b = res.backend
                check(b["fallback_signatures"] == 0 and b.get("mesh_shrinks", 0) >= 1
                      and launches["ed25519"] > tiers["ed25519"]["cuda"][0],
                      f"sim: {name}: backend {b}, launches {launches}")
                reconf = [ln for ln in res.trace if "scenario: " in ln and (
                    "mesh" in ln or "probe" in ln)]
                for ln in reconf:
                    print(f"sim: {name}: {ln}")
                print(f"sim: {name} on four virtual ordinals of the card (a kernel launch a "
                      f"shard, no runner): {tiers['ed25519']['cuda'][0]} Ed25519 batches "
                      f"served by cuda with {launches['ed25519']} launches; mesh width at the "
                      f"end {b.get('mesh_width')}, shrinks {b.get('mesh_shrinks')}, restores "
                      f"{b.get('mesh_restores')}; breakers {b['breakers']} {tag}")
            if name == "combined-storm":
                b = res.backend
                raised = acct["raised_faulted"] + acct["raised_refused"]
                check(acct["served_faulted"] == 0 and res.sched["shed"]["consensus"] == 0,
                      f"sim: combined-storm batches {dict(acct)}, sched {res.sched['shed']}")
                print(f"sim: combined-storm under the card's rule: {raised} supervised "
                      f"batches raised = {acct['raised_faulted']} in which the injector fired "
                      f"({faults()} faults) + {acct['raised_refused']} an open breaker "
                      f"refused, none answered below the kernel (fallback signatures "
                      f"{b['fallback_signatures']}); sched shed {res.sched['shed']}; heights "
                      f"{res.heights} (target {res.target_height}) {tag}")
            if name == "backend-brownout":
                b = res.backend
                raised = acct["raised_faulted"] + acct["raised_refused"]
                check(acct["raised_faulted"] > 0 and acct["served_faulted"] == 0,
                      f"sim: backend-brownout batches {dict(acct)}, {faults()} faults")
                check(b["fallback_signatures"] == 0 and b["breaker_opens"] >= 1
                      and b["repromotions"] >= 1 and b["breakers"].get("cuda") == "closed",
                      f"sim: backend-brownout breakers {b}")
                print(f"sim: backend-brownout under the card's rule: {tiers['ed25519']['cuda'][0]} "
                      f"Ed25519 batches served by cuda (none with a fault injected), "
                      f"{raised} raised = {acct['raised_faulted']} in which the injector "
                      f"fired ({faults()} faults, bisection's halves included) + "
                      f"{acct['raised_refused']} an open breaker refused, none answered "
                      f"below the kernel; breakers: {b['breaker_opens']} opens, "
                      f"{b['demotions']} demotions, {b['repromotions']} repromotions, end "
                      f"states {b['breakers']}; heights {res.heights} (target "
                      f"{res.target_height}) {tag}")
            if name == "dial-storm":
                check(launches["aead"] > 0 and launches["ladder"] > 0,
                      f"sim: dial-storm launches {launches}")
                waves = [ln for ln in res.trace if "dial storm wave" in ln
                         or "kill-switch parity ok" in ln]
                for ln in waves:
                    print(f"sim: dial-storm: {ln}")
                check(len(waves) == 4, f"sim: dial-storm trace lines {waves}")
            if name == "light-stampede":
                check(launches["tree"] > 0 and res.sched["shed"]["consensus"] == 0,
                      f"sim: light-stampede tree launches {launches['tree']}, sched "
                      f"{res.sched}")
                for ln in res.trace:
                    if "scenario: proof stampede" in ln:
                        print(f"sim: light-stampede: {ln}")
                print(f"sim: light-stampede: proofs {json.dumps(res.summary()['proofs'])}, "
                      f"consensus-class shed {res.sched['shed']['consensus']}")
            if name == "gossip-burst":
                check(res.sched["shed"]["consensus"] == 0 and res.sched["shed"]["bulk"] > 0,
                      f"sim: gossip-burst sched {res.summary()['sched']}")
                print(f"sim: gossip-burst: sched {json.dumps(res.summary()['sched'])}")
        cpu = {}
        for child, out_path in children:
            try:
                _, err = child.communicate(timeout=SIM_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                child.kill()
                _, err = child.communicate()
            check(child.returncode == 0, f"sim: a CPU child failed: {err[-2000:]}")
            with open(out_path) as f:
                cpu.update(json.load(f))
        for name in SIM_AGAINST_CPU:
            card, host = digests[name], cpu[name]
            host_tiers = host.pop("tiers")
            check(all(t["cuda"] == [0, 0] for t in host_tiers.values()),
                  f"sim: {name}: the CPU child reached the cuda tier: {host_tiers}")
            apart = [(a, b) for a, b in zip(card["trace"], host["trace"]) if a != b]
            differ = [k for k in card if k != "journal_records" and card[k] != host[k]]
            check(not differ, f"sim: {name}: the card's run differs from the CPU child's: "
                  f"{differ}, trace lines {len(card['trace'])} / {len(host['trace'])}, "
                  f"the first apart {apart[:3]}")
            sha = hashlib.sha256("\n".join(card["trace"]).encode()).hexdigest()
            print(f"sim: {name}: the card's trace ({len(card['trace'])} lines, sha256 "
                  f"{sha[:16]}), heights, events, the commit hash at each of "
                  f"{len(card['commits'])} heights and the sched/proofs/transport blocks "
                  f"equal the CPU child's (COMETBFT_TPU_CRYPTO_BACKEND=cpu, no batch on "
                  f"cuda there); restarted nodes' journal records "
                  f"{card['journal_records']} on the card, {host['journal_records']} on the "
                  f"CPU {tag}")
    finally:
        supervisor.verify_supervised = real_sup
        supervisor.FaultyBackend = real_shim
        for child, _ in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"sim: the phase took {time.perf_counter() - t_phase:.1f} s; launches Ed25519 "
          f"{totals['ed25519']}, tree {totals['tree']}, AEAD {totals['aead']}, ladder "
          f"{totals['ladder']}")
    return dict(totals)


def mesh_device_ms(torch, cv, parts, streams, runs: int) -> float:
    """Median device time, CUDA events, of one sharded verify from inputs
    on the card: each shard a launch on its ordinal's stream, every stream
    waiting on a start event and joined by the current one before the end
    event."""
    cur = torch.cuda.current_stream()
    ts = []
    for i in range(runs + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(cur)
        for t, st in zip(parts, streams):
            st.wait_event(start)
            with torch.cuda.stream(st):
                cv.verify_core_cuda(**t)
                done = torch.cuda.Event()
                done.record(st)
            cur.wait_event(done)
        end.record(cur)
        end.synchronize()
        if i >= 2:
            ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def mesh_phase(torch, ov, cv, ds, commit_triples, bad, mixed, tag) -> dict:
    """Phase 18c: the elastic mesh (``parallel/mesh``, ``parallel/elastic``)
    on the card.  (a) ``__graft_entry__.dryrun_multichip``'s counterpart: an
    uneven batch of 2W+3 triples with two invalid lanes and config 2's
    10,240-signature commit with bad ``bad`` through
    ``mesh.verify_batch_sharded``, at W = the card count and at
    MESH_VIRTUAL virtual ordinals of cuda:0: bits equal to one launch's and
    the plain version's, the host-summed count their sum, W ``mesh.shard``
    spans and W launches.  (b) the elastic supervisor with no runner at
    MESH_VIRTUAL ordinals, each ``FaultyDevice`` mode on ordinal 2 through
    ``ops.verify.verify_batch``: a shrink 4 -> 3 and ``mesh_dev2`` open, a
    half-open probe restores it, every verdict the plain version's, no
    batch served by ``torch`` or ``host``.  Then the sharded launches
    against one launch of the same 10,240 lanes, in turns.  Returns
    {"launches", "ms", "one_ms", ...}."""
    from cometbft_tpu_torch.crypto import backend_health
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.parallel import elastic
    from cometbft_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    pubs, msgs, sigs = commit_triples
    bad_sigs = list(sigs)
    for i in bad:
        bad_sigs[i] = bad_sigs[i][:-1] + bytes([bad_sigs[i][-1] ^ 1])
    launches = 0

    def one_and_plain(p, m, g):
        arrays, n, structural = ov.prepare_batch(p, m, g)
        t = ov.batch_to_device(arrays, card)
        one = (cv.verify_core_cuda(**t).cpu().numpy() & structural)[:n]
        plain = (ov.verify_core(**t).cpu().numpy() & structural)[:n]
        return one, plain

    # (a) the dry run: at the card count and at MESH_VIRTUAL virtual ordinals
    commit_want = one_and_plain(pubs, msgs, bad_sigs)
    for mesh in (pmesh.make_mesh(), pmesh.make_mesh([card] * MESH_VIRTUAL)):
        w = mesh.size
        k = 2 * w + 3
        p, m, g = list(pubs[:k]), list(msgs[:k]), list(sigs[:k])
        g[1] = bytes(64)  # a degenerate signature
        p[k - 1] = p[k - 1][:16]  # a short key: structurally invalid
        for what, (bp, bm, bg), want in (
                (f"{k} uneven triples", (p, m, g), one_and_plain(p, m, g)),
                (f"the {len(pubs)}-signature commit", (pubs, msgs, bad_sigs), commit_want)):
            tracing.reset_tracer()
            cv.reset_launches()
            bits, n_ok = pmesh.verify_batch_sharded(bp, bm, bg, mesh, count=True)
            got = cv.launches
            launches += got
            shards = [x for x in tracing.get_tracer().tail(0) if x["stage"] == "mesh.shard"]
            false_at = [i for i in range(len(bits)) if not bits[i]]
            check((bits == want[0]).all() and (bits == want[1]).all(),
                  f"mesh: W={w} {what}: sharded bits != one launch / plain")
            check(n_ok == int(bits.sum()) and got == w and len(shards) == w
                  and sorted(x["attrs"]["device"] for x in shards) == sorted(mesh.ordinals),
                  f"mesh: W={w} {what}: count {n_ok}, launches {got}, spans {len(shards)}")
            if "commit" in what:
                check(false_at == list(bad), f"mesh: W={w}: rejected {false_at}")
            print(f"mesh: W={w} ({[str(d) for d in mesh.devices]}, ordinals "
                  f"{mesh.ordinals}): {what}: bits == one launch == plain version, "
                  f"rejected {false_at[:8]}, host-summed accept count {n_ok} == the bits' "
                  f"sum, {got} launches, {len(shards)} mesh.shard spans {tag}")

    # (b) the elastic supervisor under each fault mode, no runner
    fp, fm, fs = (list(x[:MESH_FAULT_LANES]) for x in mixed)
    _, plain_bits = one_and_plain(fp, fm, fs)
    clock = [1_000.0]
    ordinals = pmesh.make_mesh([card] * MESH_VIRTUAL).ordinals
    dead = ordinals[2]
    modes = {}
    try:
        with environ({"COMETBFT_TPU_BREAKER_THRESHOLD": "1",
                      "COMETBFT_TPU_DISPATCH_TIMEOUT_MS": str(MESH_HANG_DEADLINE_MS)}):
            for mode in ("raise", "hang", "wrong_shape", "flap"):
                elastic.clear()
                backend_health.reset()
                backend_health.registry().set_clock(lambda: clock[0])
                ds.reset()
                elastic.configure(ordinals)
                elastic.set_fault_injector(elastic.FaultyDevice(
                    mode, ordinals=(dead,), hang_s=MESH_HANG_S, fail_n=1, pass_n=3))
                cv.reset_launches()
                t0 = time.perf_counter()
                first = ov.verify_batch(fp, fm, fs)
                width1 = ds.mesh_width()
                state1 = backend_health.registry().breaker(f"mesh_dev{dead}").state
                elastic.clear_fault_injector()
                clock[0] += 10.0  # past the backoff: the next membership walk probes
                second = ov.verify_batch(fp, fm, fs)
                wall = time.perf_counter() - t0
                got = cv.launches
                launches += got
                snap = ds.snapshot()
                tiers = ds.tier_counts()
                check((first == plain_bits).all() and (second == plain_bits).all(),
                      f"mesh: {mode}: verdicts != the plain version's")
                check(width1 == MESH_VIRTUAL - 1 and state1 == "open"
                      and snap["mesh_width"] == MESH_VIRTUAL and snap["mesh_shrinks"] == 1
                      and snap["mesh_restores"] == 1,
                      f"mesh: {mode}: width {width1} -> {snap['mesh_width']}, mesh_dev{dead} "
                      f"{state1}, shrinks {snap['mesh_shrinks']}, restores "
                      f"{snap['mesh_restores']}")
                check(tiers["torch"] == (0, 0) and tiers["host"] == (0, 0)
                      and tiers["cuda"][0] == 2,
                      f"mesh: {mode}: batches by tier {tiers}")
                modes[mode] = {"launches": got, "wall_s": round(wall, 3)}
                print(f"mesh: {mode} on ordinal {dead} of {MESH_VIRTUAL} virtual ordinals "
                      f"(no runner): width {MESH_VIRTUAL} -> {width1}, mesh_dev{dead} "
                      f"{state1}; a half-open probe restored it (width "
                      f"{snap['mesh_width']}, {snap['mesh_restores']} restore); both "
                      f"batches' {MESH_FAULT_LANES} verdicts == the plain version's; "
                      f"batches by tier {tiers}; {got} launches; {wall:.2f} s {tag}")
    finally:
        elastic.clear()
        backend_health.registry().set_clock(time.monotonic)
        backend_health.reset()

    # the sharded launches against one launch of the same lanes, in turns
    arrays, n, _ = ov.prepare_batch(pubs, msgs, sigs)
    mesh = pmesh.make_mesh([card] * MESH_VIRTUAL)
    per = n // MESH_VIRTUAL
    whole = ov.batch_to_device(arrays, card)
    parts = [{k: v[i * per:(i + 1) * per].contiguous() for k, v in whole.items()}
             for i in range(MESH_VIRTUAL)]
    streams = [ov._stream(card, o) for o in mesh.ordinals]
    sharded, one = [], []
    for i in range(4):
        for side in (("sharded", "one") if i % 2 == 0 else ("one", "sharded")):
            if side == "sharded":
                sharded.append(mesh_device_ms(torch, cv, parts, streams, MESH_RUNS))
            else:
                one.append(cuda_ms(torch, lambda: cv.verify_core_cuda(**whole), MESH_RUNS, 2))
    ms, one_ms = statistics.median(sharded), statistics.median(one)
    print(f"mesh: time: {n} lanes as {MESH_VIRTUAL} shards of {per} on {MESH_VIRTUAL} "
          f"virtual ordinals of one card (a stream each) {ms} ms, one {n}-lane launch "
          f"{one_ms} ms (medians of 4 turns x {MESH_RUNS} samples, CUDA events; all "
          f"{sharded} / {one}): virtual ordinals share the card's SMs, so this is not a "
          f"multi-card number {tag}")
    print(f"mesh: the phase took {time.perf_counter() - t_phase:.1f} s; {launches} Ed25519 "
          f"launches on its path; fault modes {json.dumps(modes)}")
    return {"launches": launches, "ms": ms, "one_ms": one_ms, "modes": modes}


def load_torch_net():
    """``tests/torch_net.py``, the node wiring that the CPU tests use,
    loaded by path, so that the card's run and the tests cannot drift
    apart."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_net.py")
    spec = importlib.util.spec_from_file_location("torch_net", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NetLog:
    """The logger of a phase-19 node: keeps its errors as (node, module,
    message, error), drops the rest; ``with_`` names the module."""

    def __init__(self, node: str, into: list, module: str = "", trace=None):
        self.node, self.into, self.module, self.trace = node, into, module, trace

    def with_(self, module: str = "", **kv) -> "NetLog":
        return NetLog(self.node, self.into, module, self.trace)

    def error(self, msg: str, **kv) -> None:
        self.into.append((self.node, self.module, msg, str(kv.get("err", ""))))
        self.debug(msg, **kv)

    def debug(self, msg: str, **kv) -> None:
        """With ``trace`` (a deque), every line is kept for a failure's
        message."""
        if self.trace is not None:
            self.trace.append((round(time.perf_counter(), 3), self.node, self.module, msg,
                               {k: str(v)[:80] for k, v in kv.items()}))

    info = warn = debug


BLOCKSYNC_ERRORS = ("blocksync pool error", "fused verify prefetch failed",
                    "blocksync prefetch error")


def net_counts(cv, csh, cuda_aead, cuda_x25519) -> dict:
    return {"ed25519": cv.launches, "tree": csh.launches, "aead": cuda_aead.launches,
            "ladder": cuda_x25519.launches}


def net_settled(cv, csh, cuda_aead, cuda_x25519, ds, timeout_s: float = 10.0) -> dict:
    """The launch counts once the stopped nodes' last passes have landed:
    the connections' threads are not joined, so read until two reads
    0.2 s apart agree, launches and tier counts alike."""
    def read():
        return net_counts(cv, csh, cuda_aead, cuda_x25519), json.dumps(ds.snapshot(),
                                                                      sort_keys=True)

    deadline = time.perf_counter() + timeout_s
    last = read()
    while True:
        torch_sync = sys.modules.get("torch")
        if torch_sync is not None:
            torch_sync.cuda.synchronize()
        time.sleep(0.2)
        now = read()
        if now == last:
            return now[0]
        check(time.perf_counter() < deadline, "network: the counts did not settle "
              f"{timeout_s} s after the nodes stopped")
        last = now


def net_probe(torch, where: str) -> None:
    """This process's costs that a transfer's passes pay: one supervised
    AEAD pass of 10 frames on the card, a thread's start and join, and a
    0.05 s sleep (median ms of 20)."""
    import threading

    from cometbft_tpu_torch.ops import chacha_aead as ca

    frames = [(bytes(32), (7).to_bytes(12, "little"), bytes(1024)) for _ in range(10)]
    pass_ms = median_ms(lambda: ca.seal_frames(frames), 20)
    thread_ms = median_ms(lambda: (lambda t: (t.start(), t.join()))(
        threading.Thread(target=lambda: None)), 20)
    sleep_ms = median_ms(lambda: time.sleep(0.05), 5)
    print(f"network: {where}: this process's AEAD pass of 10 frames {pass_ms:.3f} ms, a "
          f"thread's start and join {thread_ms:.3f} ms, a 0.05 s sleep {sleep_ms:.3f} ms, "
          f"{threading.active_count()} threads", flush=True)


def net_tiers(ds, where: str) -> dict:
    """Every Ed25519 batch, tree pass, AEAD pass and ladder flush since the
    last reset on the cuda tier (tree passes on the host only for trees
    over the card's leaf size, as in phase 18)."""
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import x25519_ladder as xl

    tiers = {"ed25519": ds.tier_counts(), "tree": ds.tier_counts(st.MERKLE),
             "aead": ds.tier_counts(ca.AEAD), "ladder": ds.tier_counts(xl.X25519)}
    oversize = ds.tier_counts(st.MERKLE_OVERSIZE)
    for what, counts in tiers.items():
        host_ok = oversize["host"] if what == "tree" else (0, 0)
        check(counts["torch"] == (0, 0) and counts["host"] == host_ok,
              f"network: {where}: {what} served below the cuda tier: {counts} "
              f"(tree oversize {oversize})")
    return tiers


def kept_against_plain(torch, where: str, kept_ed: dict, ed_lanes, kept_tree: dict,
                       tree_keys, kept_aead: dict, kept_ladder: dict) -> tuple:
    """The four kernels held to their plain versions, bit for bit, on
    inputs a path gave them (``keeping_inputs``): the Ed25519 launches of
    ``ed_lanes`` lanes, the trees of ``tree_keys``, every AEAD and ladder
    shape kept; each timed on the card (CUDA events, queued).  Returns
    (max_abs_err by kernel, {kernel: {shape: ms}})."""
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.ops import x25519_ladder as xl

    worst, ms = collections.Counter(), collections.defaultdict(dict)
    for lanes in ed_lanes:
        t = kept_ed[lanes]
        kern, plain = cv.verify_core_cuda(**t), ov.verify_core(**t)
        worst["ed25519"] = max(worst["ed25519"], int((kern.int() - plain.int()).abs().max()))
        check(torch.equal(kern, plain), f"{where}: Ed25519 kernel != plain at {lanes} lanes")
        ms["ed25519"][lanes] = cuda_ms(torch, lambda: cv.verify_core_cuda(**t), 10, 2,
                                       queued=True)
    for key in tree_keys:
        (data, offs), _ = kept_tree[key]
        kern, plain = csh.tree_words(data, offs), st.tree_words_plain(data, offs)
        worst["tree"] = max(worst["tree"], int((kern.long() - plain.long()).abs().max()))
        check(torch.equal(kern, plain), f"{where}: tree kernel != plain at (leaves, bytes "
              f"a leaf) {key}")
        ms["tree"][key] = cuda_ms(torch, lambda: csh.tree_words(data, offs), 10, 2,
                                  queued=True)
    check(any(k[0] == "seal" for k in kept_aead) and any(k[0] == "open" for k in kept_aead),
          f"{where}: the AEAD kernel's shapes {sorted(kept_aead)}")
    for key, (args, kw) in sorted(kept_aead.items()):
        got, want = cuda_aead.aead(*args, **kw), ca.aead_core(*args, **kw)
        torch.cuda.synchronize()
        worst["aead"] = max(worst["aead"], *(int((g.long() - w.long()).abs().max())
                                             for g, w in zip(got, want)))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{where}: AEAD kernel != plain on an MConnection flush {key}")
        ms["aead"][key] = cuda_ms(torch, lambda: cuda_aead.aead(*args, **kw), 10, 2,
                                  queued=True)
    check(kept_ladder, f"{where}: no dial reached the ladder kernel")
    for lanes, (args, _) in sorted(kept_ladder.items()):
        got, want = cuda_x25519.ladder(*args), xl.ladder_plain(*args)
        torch.cuda.synchronize()
        worst["ladder"] = max(worst["ladder"], int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"{where}: ladder kernel != plain on a dial flush of "
              f"{lanes} lanes")
        ms["ladder"][lanes] = cuda_ms(torch, lambda: cuda_x25519.ladder(*args), 10, 2,
                                      queued=True)
    return worst, ms


def network_phase(torch, dev, cbatch, cv, ds, sigcache, chain, tag) -> dict:
    """Phase 19: the peer-to-peer network and its reactors.  Part A: a
    four-validator localnet over SecretConnection switches and a fifth node
    that blocksyncs, switches to consensus and learns peers by PEX, each
    node a process of its own.  Part B, in this process after part A and
    every earlier phase: a joiner blocksyncs phase 17's 10,240-validator
    chain (``chain``, blockexec_phase's hand-over, removed here) from a
    serving node, then the four kernels are held to their plain versions
    on part B's inputs (phase 20 extends the chain; the caller removes
    it).  Returns the launches of both parts per kernel."""
    import pathlib

    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="network-"))
    procs: list = []  # part A's processes, stopped in the finally
    out = {}
    try:
        out["A"] = network_localnet(tag, root, procs)
        out["B"] = network_part_b(torch, cbatch, cv, ds, sigcache, chain, tag)
        print(f"network: the phase took {time.perf_counter() - t_phase:.1f} s")
    finally:
        for _, p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    return {k: out["A"]["launches"][k] + out["B"]["launches"][k]
            for k in ("ed25519", "tree", "aead", "ladder")}


def network_part_b(torch, cbatch, cv, ds, sigcache, chain, tag) -> dict:
    """Part B of phase 19 in this process: the serving node and the joiner
    over one link, then the four kernels against their plain versions on
    the inputs part B gave them; prints its lines and returns its
    launches, wall and validators."""
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.p2p.secret_connection import SecretConnection

    tn = load_torch_net()
    net_probe(torch, "this process, before part B")
    gc_pauses = []  # (generation, seconds) of each collection in part B
    gc_t0 = [0.0]

    def gc_watch(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], time.perf_counter() - gc_t0[0]))

    cpu0, load0 = os.times(), os.getloadavg()
    errors: list = []
    nets: list = []
    kept_ed = {}
    moved = [0]  # bytes part B's SecretConnections wrote to sockets
    real_ed, real_send_raw = cv.verify_core_cuda, SecretConnection._send_raw

    def keep_ed(**t):
        kept_ed.setdefault(int(t["s_ok"].shape[0]), {k: v.clone() for k, v in t.items()})
        return real_ed(**t)

    def send_raw(self, data):
        moved[0] += len(data)
        return real_send_raw(self, data)

    try:
        with keeping_inputs(cuda_aead, "aead", lambda a, kw: (
                "seal" if kw["seal"] else "open", a[2].shape[1], a[2].shape[0])) as kept_aead, \
                keeping_inputs(cuda_x25519, "ladder", lambda a, kw: a[0].shape[0]) as kept_ladder, \
                keeping_inputs(csh, "tree_words", lambda a, kw: (
                    int(a[1].shape[0]) - 1,
                    int(a[0].numel()) * a[0].element_size()
                    // max(int(a[1].shape[0]) - 1, 1))) as kept_tree:
            cv.verify_core_cuda, SecretConnection._send_raw = keep_ed, send_raw
            gc.callbacks.append(gc_watch)
            out = network_blocksync(torch, cbatch, cv, ds, sigcache, tag, tn, tn.PORT, chain,
                                    errors, nets, moved)
    finally:
        if gc_watch in gc.callbacks:
            gc.callbacks.remove(gc_watch)
        cv.verify_core_cuda, SecretConnection._send_raw = real_ed, real_send_raw
        for n in nets:
            n.stop()
    cpu1, load1 = os.times(), os.getloadavg()
    full = [t for g, t in gc_pauses if g == 2]
    print(f"network: part B in this process: {len(gc_pauses)} collections "
          f"({sum(t for _, t in gc_pauses):.3f} s in all; {len(full)} full, "
          f"{sum(full):.3f} s, the longest {max(full, default=0.0):.3f} s; "
          f"{len(gc.get_objects())} objects tracked after), this process's CPU "
          f"{cpu1.user + cpu1.system - cpu0.user - cpu0.system:.2f} s over "
          f"{out['wall_s']:.2f} s, load average {load0[0]:.2f} -> {load1[0]:.2f} "
          f"on {os.cpu_count()} CPUs", flush=True)
    net_probe(torch, "this process, after part B")

    # -- the kernels against their plain versions, on part B's inputs
    ed_b = max(kept_ed, default=None)
    check(ed_b is not None, "network: no part B launch reached the Ed25519 kernel")
    # (leaves, bytes a leaf): a validator's leaf is ~40 bytes, a tx's 256
    valset = [k for k in kept_tree if k[0] == out["validators"] and k[1] < 128]
    check(valset, f"network: no validator-set hash of {out['validators']} leaves "
          f"reached the tree kernel: {sorted(kept_tree)}")
    worst, ms = kept_against_plain(torch, "network", kept_ed, [ed_b], kept_tree, valset[:1],
                                   kept_aead, kept_ladder)
    ed_ms, tree_ms = ms["ed25519"][ed_b], ms["tree"][valset[0]]
    aead_ms, ladder_ms = ms["aead"], ms["ladder"]
    print(f"network: on part B's own inputs, bit for bit: the Ed25519 kernel == "
          f"its plain version on its launch of {ed_b} lanes (all of them; "
          f"{ed_ms} ms on the card), the tree kernel on a synced block's "
          f"validator-set hash (leaves, bytes a leaf) {valset[0]} ({tree_ms} ms), the AEAD "
          f"kernel on the first MConnection flush of each (op, lanes, blocks) "
          f"{sorted(kept_aead)} ({ {f'{k[0]} {k[1]}x{k[2]}': v for k, v in aead_ms.items()} } ms), the "
          f"ladder kernel on the first dial flush of each lane bucket "
          f"{sorted(kept_ladder)} ({ladder_ms} ms); max_abs_err {dict(worst)}; "
          f"device times by CUDA events, queued {tag}")
    per_aead = statistics.median(aead_ms.values())
    per_ladder = statistics.median(ladder_ms.values())
    c, wall = out["launches"], out["wall_s"]
    busy = (c["ed25519"] * ed_ms + c["tree"] * tree_ms + c["aead"] * per_aead
            + c["ladder"] * per_ladder) / (wall * 1e3)
    print(f"network: part B: the card busy ~{busy:.4%} of its {wall:.2f} s (idle "
          f"~{1 - busy:.4%}; derived: launches {c} x device times Ed25519 {ed_ms:.4f}, "
          f"tree {tree_ms:.4f}, AEAD {per_aead:.4f}, ladder {per_ladder:.4f} ms) {tag}")
    return {**out, "busy": busy, "max_abs_err": dict(worst)}


def net_write(path, doc) -> None:
    """Write ``doc`` as JSON to ``path`` whole (a rename), for another
    process to poll."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def net_read(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def net_node_child(cfg_path: str) -> int:
    """One node of phase 19's part A in a process of its own (a localnet
    node is a process): ``sim/node.build_node`` on the card, wired by
    ``tests/torch_net.py``.  It polls the run directory for its peers and
    for the stop, writes its status as it goes, and at the stop a report:
    its chain, its counts and tiers, its transport counters, its vote
    latencies, its errors, and its kernels held to their plain versions
    on the inputs its path gave them."""
    import collections as co
    import pathlib

    import numpy as np
    import torch

    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.blocksync import stats as bstats
    from cometbft_tpu_torch.config.config import ConsensusConfig, MempoolConfig, P2PConfig
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.mempool.clist_mempool import MempoolError
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import dispatch_stats as ds
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.ops import x25519_ladder as xl
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats
    from cometbft_tpu_torch.p2p.secret_connection import SecretConnection
    from cometbft_tpu_torch.sim.node import build_node, make_genesis
    from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE, BlockID, PartSetHeader
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence, evidence_list_hash
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.verifysched import stats as vstats

    cfg = net_read(cfg_path)
    run = pathlib.Path(cfg["run"])
    i, name, joiner = cfg["index"], cfg["name"], cfg["role"] == "joiner"
    status_path, report_path = run / f"status-{name}.json", run / f"report-{name}.json"
    tn = load_torch_net()
    privs, gdoc = make_genesis(NETWORK_NODES, NETWORK_CHAIN)
    priv = (Ed25519PrivKey.from_seed(hashlib.sha256(b"netval%d" % i).digest())
            if joiner else privs[i])
    mcfg = MempoolConfig()
    t_boot = time.perf_counter()
    h = build_node(i, priv, gdoc, run, config=ConsensusConfig(), threaded=True,
                   mempool_config=mcfg)
    errors: list = []
    h.cs.logger = NetLog(name, errors).with_(module="consensus")
    net = tn.from_handle(tn.PORT, h, tn.node_key(tn.PORT, b"network-" + name.encode()),
                         NETWORK_CHAIN, p2p_config=P2PConfig(), mempool_config=mcfg,
                         home=str(run / f"node{i}"), moniker=name,
                         logger=NetLog(name, errors))
    check(net.transport.device is None and verifysched.scheduler_active(),
          f"network: {name} is not on the card")
    boot_s = time.perf_counter() - t_boot

    fed, feed_ms = {"h": 0}, []

    def feed(height: int) -> None:
        """Node 0's mempool offered height ``height``'s txs; the mempool
        reactor carries them to the others."""
        if fed["h"] >= height:
            return
        fed["h"] = height
        rng = np.random.default_rng([NETWORK_SEED, height])
        hexed = rng.bytes(NETWORK_TXS * NETWORK_TX_BYTES // 2).hex().encode()
        t0 = time.perf_counter()
        ok = 0
        for k in range(NETWORK_TXS):
            head = b"n%d-%04d=" % (height, k)
            o = k * NETWORK_TX_BYTES
            try:
                h.mempool.check_tx(head + hexed[o : o + NETWORK_TX_BYTES - len(head)])
                ok += 1
            except MempoolError:
                pass
        feed_ms.append((height, round((time.perf_counter() - t0) * 1e3, 3), ok))

    if cfg["feed"]:
        real_update = h.cs.update_to_state

        def update_to_state(state):
            real_update(state)
            feed(state.last_block_height + 1)

        h.cs.update_to_state = update_to_state
        feed(1)

    kept_ed, vote_lat, moved = {}, [], [0]
    real_ed, real_verify, real_send = cv.verify_core_cuda, Vote.verify, SecretConnection._send_raw

    def keep_ed(**t):
        kept_ed.setdefault(int(t["s_ok"].shape[0]), {k: v.clone() for k, v in t.items()})
        return real_ed(**t)

    def timed_verify(self, chain_id, pub_key):
        t0 = time.perf_counter()
        try:
            return real_verify(self, chain_id, pub_key)
        finally:
            vote_lat.append((time.perf_counter() - t0) * 1e3)

    def send_raw(self, data):
        moved[0] += len(data)
        return real_send(self, data)

    with keeping_inputs(cuda_aead, "aead", lambda a, kw: (
            "seal" if kw["seal"] else "open", a[2].shape[1], a[2].shape[0])) as kept_aead, \
            keeping_inputs(cuda_x25519, "ladder", lambda a, kw: a[0].shape[0]) as kept_ladder, \
            keeping_inputs(csh, "tree_words", lambda a, kw: int(a[1].shape[0]) - 1) as kept_tree:
        cv.verify_core_cuda, Vote.verify, SecretConnection._send_raw = keep_ed, timed_verify, send_raw
        ds.reset()
        vstats.reset()
        tstats.reset()
        bstats.reset()
        handshake_pool.reset_pool()
        for w in (cv, csh, cuda_aead, cuda_x25519):
            w.reset_launches()
        commits, ev = {}, {}  # height -> (unix time, counts when stored)
        seen_ev, want, no_evidence = {}, None, evidence_list_hash([])
        bs, cr = net.reactors["BLOCKSYNC"], net.reactors["CONSENSUS"]
        started = sync_s = switched_at = None
        t0 = time.perf_counter()
        status = {}
        while True:
            if started is None:
                peers = net_read(run / f"peers-{name}.json")
                if peers is not None:
                    net.start(peers)
                    started = time.perf_counter()
            height = h.block_store.height()
            for hh in range(len(commits) + 1, height + 1):
                commits[hh] = (time.time(), net_counts(cv, csh, cuda_aead, cuda_x25519))
                if h.block_store.load_block_meta(hh).header.evidence_hash != no_evidence:
                    for x in h.block_store.load_block(hh).evidence:
                        seen_ev[x.hash().hex()] = x
            if joiner and sync_s is None and started is not None and not cr.wait_sync \
                    and h.cs._started:
                sync_s, switched_at = time.perf_counter() - started, height
                synced = dict(bstats.snapshot())
                sync_counts = net_counts(cv, csh, cuda_aead, cuda_x25519)
            if cfg["evidence_at"] and not ev and h.cs.rs.height >= cfg["evidence_at"] \
                    and height >= cfg["evidence_at"] - 1:
                ev_h = cfg["evidence_at"] - 1
                vals = h.state_store.load_validators(ev_h)
                meta = h.block_store.load_block_meta(ev_h)
                who = vals.validators[NETWORK_EQUIVOCATOR]
                key = next(p for p in privs if p.pub_key().address() == who.address)
                votes = []
                for c in (0xA0, 0xB0):
                    bid = BlockID(bytes([c]) * 32, PartSetHeader(1, bytes([c + 1]) * 32))
                    v = Vote(PRECOMMIT_TYPE, ev_h, 0, bid, meta.header.time, who.address,
                             NETWORK_EQUIVOCATOR)
                    v.signature = key.sign(v.sign_bytes(NETWORK_CHAIN))
                    votes.append(v)
                e = DuplicateVoteEvidence.from_votes(*votes, meta.header.time,
                                                     who.voting_power, vals.total_voting_power())
                s0 = vstats.snapshot()["submitted"]["evidence_light"]
                h.evidence_pool.add_evidence(e)
                ev = {"hash": e.hash().hex(), "height": ev_h, "at": h.cs.rs.height,
                      "submitted": vstats.snapshot()["submitted"]["evidence_light"] - s0,
                      "pending": len(h.evidence_pool.all_pending())}
            if want is None:
                want = (net_read(run / "evidence.json") or {}).get("hash")
            committed = want in seen_ev and h.evidence_pool._is_committed(seen_ev[want])
            new = {"address": net.address, "node_id": net.node_id, "height": height,
                   "cs_height": h.cs.rs.height, "peers": len(net.switch.peers_list()),
                   "started": started is not None, "syncing": bs.syncing,
                   "wait_sync": cr.wait_sync, "switched_at": switched_at,
                   "evidence": ev, "evidence_committed": committed,
                   "book": sorted([nid, ka.src] for nid, ka in net.addr_book._addrs.items())
                   if net.addr_book is not None else [],
                   "errors": len(errors), "boot_s": boot_s}
            if new != status:
                status = new
                net_write(status_path, status)
            if (run / "stop").exists() or time.perf_counter() - t0 > cfg["deadline_s"]:
                break
            time.sleep(0.05)
        wall = time.perf_counter() - (started or t0)
        net.stop()
        h.cs.stop()
        h.app_conns.stop()
        launches = net_settled(cv, csh, cuda_aead, cuda_x25519, ds)
        cv.verify_core_cuda, Vote.verify, SecretConnection._send_raw = real_ed, real_verify, real_send
        snap, ts = vstats.snapshot(), tstats.snapshot()
        from cometbft_tpu_torch.ops import chacha_aead as ca_
        tiers = {"ed25519": ds.tier_counts(), "tree": ds.tier_counts(st.MERKLE),
                 "aead": ds.tier_counts(ca_.AEAD), "ladder": ds.tier_counts(xl.X25519),
                 "tree_oversize": ds.tier_counts(st.MERKLE_OVERSIZE)}
        top = h.block_store.height()
        chain = {}
        for hh in range(1, top + 1):
            meta = h.block_store.load_block_meta(hh)
            app = (h.block_store.load_block_meta(hh + 1).header.app_hash if hh < top
                   else h.state_store.load().app_hash)
            seen = h.block_store.load_seen_commit(hh)
            chain[hh] = {"block": meta.block_id.hash.hex(), "app": app.hex(),
                         "txs": meta.num_txs, "round": seen.round_ if seen else None,
                         "evidence": [x.hash().hex() for x in h.block_store.load_block(hh).evidence]}
        # the kernels against their plain versions on this node's inputs,
        # and their device times for the busy share (not counted launches)
        worst, dev_ms = co.Counter(), {}
        for lanes, t in sorted(kept_ed.items())[:3]:
            kern, plain = cv.verify_core_cuda(**t), ov.verify_core(**t)
            worst["ed25519"] = max(worst["ed25519"], int((kern.int() - plain.int()).abs().max()))
            check(torch.equal(kern, plain), f"network: {name}: Ed25519 kernel != plain at {lanes}")
        if kept_ed:
            k = min(kept_ed)
            dev_ms["ed25519"] = cuda_ms(torch, lambda: cv.verify_core_cuda(**kept_ed[k]), 5, 1,
                                        queued=True)
        for leaves, (args, _) in sorted(kept_tree.items())[-2:]:
            kern, plain = csh.tree_words(*args), st.tree_words_plain(*args)
            worst["tree"] = max(worst["tree"], int((kern.long() - plain.long()).abs().max()))
            check(torch.equal(kern, plain), f"network: {name}: tree kernel != plain at {leaves}")
            dev_ms["tree"] = cuda_ms(torch, lambda: csh.tree_words(*args), 5, 1, queued=True)
        aead_ms = []
        for key, (args, kw) in sorted(kept_aead.items()):
            got, want_ = cuda_aead.aead(*args, **kw), ca.aead_core(*args, **kw)
            torch.cuda.synchronize()
            worst["aead"] = max(worst["aead"], *(int((g.long() - w.long()).abs().max())
                                                 for g, w in zip(got, want_)))
            check(all(torch.equal(g, w) for g, w in zip(got, want_)),
                  f"network: {name}: AEAD kernel != plain on a flush {key}")
            aead_ms.append(cuda_ms(torch, lambda: cuda_aead.aead(*args, **kw), 5, 1, queued=True))
        dev_ms["aead"] = statistics.median(aead_ms) if aead_ms else 0.0
        for lanes, (args, _) in sorted(kept_ladder.items()):
            got, want_ = cuda_x25519.ladder(*args), xl.ladder_plain(*args)
            torch.cuda.synchronize()
            worst["ladder"] = max(worst["ladder"], int((got.long() - want_.long()).abs().max()))
            check(torch.equal(got, want_), f"network: {name}: ladder kernel != plain at {lanes}")
            dev_ms["ladder"] = cuda_ms(torch, lambda: cuda_x25519.ladder(*args), 5, 1,
                                       queued=True)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    report = {
        "name": name, "launches": launches, "tiers": tiers, "wall_s": wall,
        "shed_fallback_total": snap["shed_fallback_total"],
        "transport": {"frames": ts["frames"], "batches": ts["batches"],
                      "dispatches": ts["dispatches"], "hs_flushes": ts["hs_flushes"],
                      "hs_shed": ts["hs_shed"], "handshakes": ts["handshakes"]},
        "moved": moved[0], "vote_ms": vote_lat, "chain": chain,
        "commits": {hh: [t, c] for hh, (t, c) in commits.items()},
        "evidence": ev, "feed_ms": feed_ms,
        "evidence_committed": want in seen_ev and h.evidence_pool._is_committed(seen_ev[want]),
        "errors": [list(e) for e in errors], "kept": {
            "ed25519": sorted(kept_ed), "tree": sorted(kept_tree),
            "aead": sorted(list(k) for k in kept_aead), "ladder": sorted(kept_ladder)},
        "max_abs_err": dict(worst), "device_ms": dev_ms, "leaked": leaked,
        "sync": ({"sync_s": sync_s, "switched_at": switched_at, "counters": synced,
                  "launches": sync_counts} if joiner and sync_s is not None else None),
    }
    net_write(report_path, report)
    return 0


def network_localnet(tag, root, procs) -> dict:
    """Part A of phase 19: four validators and a joiner, each node a
    process of its own (``net_node_child``; a localnet node is a process,
    and five nodes under one GIL starve consensus), joined over
    SecretConnection links on 127.0.0.1.  This process starts them, hands
    out the peers, waits on their status files and reads their reports.
    Returns {"launches": {...}, "wall_s": s, "busy": share}."""
    import numpy as np

    script = os.path.abspath(__file__)
    env = dict(os.environ, COMETBFT_TPU_WARMBOOT="0")
    names = [f"node{i}" for i in range(NETWORK_NODES)]
    everyone = names + ["joiner"]

    def spawn(i: int, name: str, role: str) -> None:
        path = root / f"cfg-{name}.json"
        net_write(path, {"run": str(root), "index": i, "name": name, "role": role,
                         "feed": i == 0,
                         "evidence_at": NETWORK_EVIDENCE_AT if i == 1 else 0,
                         "deadline_s": 4 * NETWORK_TIMEOUT_S})
        log = open(root / f"{name}.log", "w")
        # the joiner is never alone: its peer comes once the chain stored
        # NETWORK_SYNC_MIN + 1, which on a slow host can be later than the
        # blocksync's 10 s solo grace after its build (then it would switch
        # to consensus having synced nothing)
        child_env = (dict(env, COMETBFT_TPU_BSYNC_SOLO_GRACE=str(NETWORK_TIMEOUT_S))
                     if role == "joiner" else env)
        procs.append((name, subprocess.Popen(
            [sys.executable, script, "--net-node", str(path)], cwd=os.path.dirname(script),
            env=child_env, stdout=log, stderr=subprocess.STDOUT), log))

    def status(name: str) -> dict:
        return net_read(root / f"status-{name}.json") or {}

    def tail(name: str) -> str:
        try:
            return (root / f"{name}.log").read_text()[-3000:]
        except OSError:
            return ""

    def wait(cond, what: str, timeout_s: float = NETWORK_TIMEOUT_S) -> None:
        deadline = time.perf_counter() + timeout_s
        while not cond():
            for name, p, _ in procs:
                check(name not in everyone or p.poll() is None, f"network: {name} exited "
                      f"(rc {p.returncode}) before {what}: {tail(name)}")
            check(time.perf_counter() < deadline, f"network: {what} not reached in "
                  f"{timeout_s} s: " + json.dumps({n: {k: status(n).get(k) for k in (
                      "height", "cs_height", "peers", "syncing", "errors")} for n in everyone}))
            time.sleep(0.05)

    marks = {}

    def mark(what: str) -> None:
        marks[what] = round(time.perf_counter() - t_run, 3)
        print(f"network: part A: {what} at {marks[what]} s, heights "
              f"{[status(n).get('height') for n in everyone]}", flush=True)

    t_run = None
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        spawn(i, name, "validator")
    wait(lambda: all(status(n).get("address") for n in names), "the four validators built")
    boot_s = time.perf_counter() - t0
    addrs = {n: status(n)["address"] for n in names}
    ids = {n: status(n)["node_id"] for n in names}
    t_run = time.perf_counter()
    for i, name in enumerate(names):
        # every pair joined once: node i dials the nodes before it, each a
        # persistent peer (a reconnect redials it)
        net_write(root / f"peers-{name}.json", [addrs[m] for m in names[:i]])
    wait(lambda: all(status(n).get("peers", 0) >= NETWORK_NODES - 1 for n in names),
         "every validator connected to the three others")
    connect_s = time.perf_counter() - t_run
    mark("connected")
    wait(lambda: status("node1").get("evidence"), "the duplicate vote in node1's pool")
    mark("evidence in node1's pool")
    ev = status("node1")["evidence"]
    net_write(root / "evidence.json", ev)
    check(ev["submitted"] == 2 and ev["pending"] == 1, f"network: node1's evidence {ev}")
    wait(lambda: min(status(n).get("height", 0) for n in names) >= NETWORK_JOIN_AFTER,
         f"height {NETWORK_JOIN_AFTER} on every validator")
    mark(f"height {NETWORK_JOIN_AFTER} everywhere")
    spawn(NETWORK_NODES, "joiner", "joiner")
    wait(lambda: status("joiner").get("address"), "the joiner built")
    mark("joiner built")
    # blocksync stops one height short of its best peer (it needs the next
    # block's commit), so the joiner dials node0 only once every validator
    # stored NETWORK_SYNC_MIN + 1: it then syncs at least NETWORK_SYNC_MIN
    # heights however slowly the chain moved while it built
    wait(lambda: min(status(n).get("height", 0) for n in names) > NETWORK_SYNC_MIN,
         f"height {NETWORK_SYNC_MIN + 1} on every validator")
    mark(f"height {NETWORK_SYNC_MIN + 1} everywhere")
    net_write(root / "peers-joiner.json", [addrs["node0"]])
    wait(lambda: status("joiner").get("switched_at") is not None,
         "the joiner's blocksync and its switch to consensus")
    mark("joiner switched")
    switched = status("joiner")["switched_at"]
    wait(lambda: status("joiner").get("height", 0) >= switched + NETWORK_FOLLOW,
         f"the joiner at height {switched + NETWORK_FOLLOW} by consensus")
    mark(f"joiner followed {NETWORK_FOLLOW}")
    learned = lambda: sorted(nid for nid, src in status("joiner").get("book", [])
                             if nid in (ids["node1"], ids["node2"], ids["node3"]))
    wait(lambda: len(learned()) >= NETWORK_PEX, f"{NETWORK_PEX} peers learned by PEX")
    mark("PEX")
    wait(lambda: all(status(n).get("evidence_committed") for n in everyone),
         "the evidence committed in every pool")
    mark("evidence committed everywhere")
    wall = time.perf_counter() - t_run
    print(f"network: part A: milestones (s from the dials) {marks} {tag}")
    (root / "stop").touch()
    for name, p, log in [x for x in procs if x[0] in everyone]:
        try:
            p.wait(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        check(p.returncode == 0, f"network: {name} failed (rc {p.returncode}): {tail(name)}")
    reps = {n: net_read(root / f"report-{n}.json") for n in everyone}
    check(all(reps.values()), f"network: reports missing: {[n for n in reps if not reps[n]]}")

    # -- what part A asserts ----------------------------------------------
    top = min(max(map(int, r["chain"]), default=0) for r in reps.values())
    for hh in map(str, range(1, top + 1)):
        blocks = {r["chain"][hh]["block"] for r in reps.values()}
        apps = {r["chain"][hh]["app"] for r in reps.values()}
        check(len(blocks) == 1 and len(apps) == 1, f"network: height {hh}: {len(blocks)} block "
              f"hashes, {len(apps)} app hashes across the five nodes")
    c0 = reps["node0"]["chain"]
    ev_at = [int(hh) for hh, c in c0.items() if ev["hash"] in c["evidence"]]
    check(ev_at and all(r["evidence_committed"] for r in reps.values()),
          f"network: the evidence in blocks {ev_at}, committed in "
          f"{[n for n, r in reps.items() if r['evidence_committed']]}")
    sync = reps["joiner"]["sync"]
    check(sync and sync["counters"]["heights_synced"] >= NETWORK_SYNC_MIN,
          f"network: the joiner's sync {sync}")
    launches = collections.Counter()
    for n, r in reps.items():
        t = r["tiers"]
        for what in ("ed25519", "tree", "aead", "ladder"):
            host_ok = t["tree_oversize"]["host"] if what == "tree" else [0, 0]
            check(t[what]["torch"] == [0, 0] and t[what]["host"] == host_ok,
                  f"network: {n}: {what} served below the cuda tier: {t[what]}")
            check(t[what]["cuda"][0] == r["launches"][what],
                  f"network: {n}: {r['launches'][what]} {what} launches != cuda passes "
                  f"{t[what]['cuda']}")
            launches[what] += r["launches"][what]
        check(r["shed_fallback_total"] == 0, f"network: {n}: shed fallbacks")
        check(r["transport"]["dispatches"]["host"] == 0, f"network: {n}: host AEAD passes")
        check(not r["leaked"], f"network: {n} imported {r['leaked']}")
        bad = [e for e in r["errors"] if any(b in e[2] for b in BLOCKSYNC_ERRORS)
               or "BackendError" in e[3] or "PoisonedInput" in e[3]]
        check(not bad, f"network: {n} logged {bad[:3]}")
    check(all(launches[k] > 0 for k in ("ed25519", "tree", "aead", "ladder")),
          f"network: part A's launches {dict(launches)}")

    # -- what part A prints -----------------------------------------------
    rows = []
    # node 0 stamps a height when its status loop sees it stored; the
    # last height or two may have landed after its last look
    for hh in range(1, min(top, max(map(int, reps["node0"]["commits"]))) + 1):
        k = str(hh)
        row = {"height": hh, "block_ms": (round((reps["node0"]["commits"][k][0]
                                                 - reps["node0"]["commits"][str(hh - 1)][0])
                                                * 1e3, 3) if hh > 1 else None),
               "rounds": c0[k]["round"] + 1, "txs": c0[k]["txs"],
               "evidence": len(c0[k]["evidence"])}
        for what in ("ed25519", "tree", "aead", "ladder"):
            row[f"{what}_launches"] = sum(
                r["commits"][k][1][what] - (r["commits"][str(hh - 1)][1][what] if hh > 1 else 0)
                for r in reps.values() if k in r["commits"] and (hh == 1 or str(hh - 1) in r["commits"]))
        rows.append(row)
        print(f"network: part A height {json.dumps(row)} (launches: every node's between "
              f"its stores of h - 1 and h) {tag}")
    lat = np.array([x for r in reps.values() for x in r["vote_ms"]])
    frames = collections.Counter()
    passes = collections.Counter()
    hs = collections.Counter()
    for r in reps.values():
        frames.update(r["transport"]["frames"])
        passes.update(r["transport"]["batches"])
        hs.update(r["transport"]["hs_flushes"])
    moved = sum(r["moved"] for r in reps.values()) / 1e6
    busy = sum(r["launches"][k] * r["device_ms"].get(k, 0.0) for r in reps.values()
               for k in ("ed25519", "tree", "aead", "ladder")) / (wall * 1e3)
    errs = collections.Counter(e[2] for r in reps.values() for e in r["errors"])
    print(f"network: part A: {NETWORK_NODES} validators (make_genesis, chain "
          f"{NETWORK_CHAIN!r}), each a process of its own built by sim/node.build_node on the "
          f"card and wired by tests/torch_net.py ({boot_s:.2f} s to boot all four): NodeKey, "
          f"Transport (device None) and Switch on 127.0.0.1:0, the consensus, blocksync, "
          f"mempool, evidence and PEX reactors; ConsensusConfig(), MempoolConfig() and "
          f"P2PConfig() defaults; {NETWORK_NODES * (NETWORK_NODES - 1) // 2} links up in "
          f"{connect_s * 1e3:.1f} ms; node 0's mempool offered {NETWORK_TXS} txs of "
          f"{NETWORK_TX_BYTES} bytes before each height (seed {NETWORK_SEED}; feeds "
          f"{reps['node0']['feed_ms']} as (height, ms, admitted)) {tag}")
    print(f"network: part A: heights 1-{top} on all five nodes in {wall:.2f} s, one block "
          f"hash and one app hash per height; txs a block {[c0[str(x)]['txs'] for x in range(1, top + 1)]}; "
          f"the duplicate vote of validator {NETWORK_EQUIVOCATOR} at height {ev['height']} put "
          f"in node1's pool at height {ev['at']} ({ev['submitted']} evidence-class signatures "
          f"on the card), gossiped, committed in block {ev_at}, marked committed in all five "
          f"pools; served by tier: every Ed25519 batch, tree pass, AEAD pass and ladder flush "
          f"on cuda in all five processes, 0 shed fallbacks; errors logged {dict(errs)} {tag}")
    print(f"network: part A: the joiner (a non-validator, its only peer node0, PEX on) "
          f"blocksynced to height {sync['switched_at']} in {sync['sync_s'] * 1e3:.1f} ms "
          f"(counters {sync['counters']}), its own launches in that time {sync['launches']}; "
          f"switched to consensus, followed to height "
          f"{max(map(int, reps['joiner']['chain']))}; learned by PEX {len(learned())} "
          f"validators' addresses {[x[:8] for x in learned()]} {tag}")
    print(f"network: part A: vote-verify latency (Vote.verify wall, {len(lat)} calls over the "
          f"five processes) p50 {float(np.percentile(lat, 50))} ms, p99 "
          f"{float(np.percentile(lat, 99))} ms {tag}")
    print(f"network: part A: transport: {frames['batched']} frames in "
          f"{sum(passes.values())} AEAD passes {dict(passes)} "
          f"({frames['batched'] / max(1, sum(passes.values())):.2f} frames a pass, "
          f"{launches['aead']} launches), {frames['serial']} frames serial (flushes under "
          f"the plane's minimum of 4); {moved:.3f} MB written to sockets "
          f"({moved / wall:.3f} MB/s over the run); ladder flushes {sum(hs.values())} "
          f"{dict(hs)} ({launches['ladder']} launches) {tag}")
    blocks_ms = [r["block_ms"] for r in rows[1:]]
    print(f"network: part A: block time per height (ms) {[r['block_ms'] for r in rows]}, "
          f"median of heights 2-{rows[-1]['height']} "
          f"{statistics.median(blocks_ms) if blocks_ms else None} ms; "
          f"rounds {[r['rounds'] for r in rows]}; launches {dict(launches)}; the card busy "
          f"~{busy:.4%} of the run (idle ~{1 - busy:.4%}; derived: each process's launches x "
          f"the device times of its own kept inputs, CUDA events, queued) {tag}")
    return {"launches": dict(launches), "wall_s": wall, "busy": busy}


def network_blocksync(torch, cbatch, cv, ds, sigcache, tag, tn, PORT, chain, errors,
                      nets, moved) -> dict:
    """Part B of phase 19.  Returns {"launches": {...}, "wall_s": s,
    "validators": n}."""
    from cometbft_tpu_torch.abci import types as at
    from cometbft_tpu_torch.abci.client import LocalClient
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.blocksync import stats as bstats
    from cometbft_tpu_torch.config.config import P2PConfig
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.mempool.clist_mempool import NopMempool
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats
    from cometbft_tpu_torch.state import execution
    from cometbft_tpu_torch.state.state import _params_to_json, state_from_genesis
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV
    from cometbft_tpu_torch.types import codec, validation
    from cometbft_tpu_torch.verifysched import stats as vstats

    gdoc = chain["genesis"]
    sdb = SqliteKV(chain["db"], surface="state")
    jdb = None
    try:
        sbstore, ssstore = BlockStore(sdb), StateStore(sdb)
        sstate = ssstore.load()
        top = sbstore.height()
        n = len(sstate.validators.validators)
        trace = collections.deque(maxlen=80)  # the nodes' last log lines
        server = tn.build(PORT, tn.node_key(PORT, b"network-server"), gdoc.chain_id,
                          p2p_config=P2PConfig(pex=False), state=sstate, block_store=sbstore,
                          block_sync=False, moniker="server",
                          logger=NetLog("server", errors, trace=trace))
        nets.append(server)
        # the joiner: genesis, a fresh app after InitChain, its own stores
        state = state_from_genesis(gdoc)
        app = KVStoreApplication()
        client = LocalClient(app)
        res = client.init_chain(at.InitChainRequest(
            time_unix_ns=gdoc.genesis_time.to_ns(), chain_id=gdoc.chain_id,
            consensus_params=_params_to_json(gdoc.consensus_params),
            validators=[at.ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power)
                        for v in gdoc.validators],
            app_state_bytes=gdoc.app_state, initial_height=gdoc.initial_height))
        state.app_hash = res.app_hash
        jdb = SqliteKV(os.path.join(chain["dir"], "joiner.db"), surface="state")
        jbstore, jsstore = BlockStore(jdb), StateStore(jdb)
        jsstore.bootstrap(state)
        evpool = EvidencePool(jdb, jsstore, jbstore)
        ex = execution.BlockExecutor(jsstore, jbstore, client, NopMempool(),
                                     evidence_pool=evpool)
        joiner = tn.build(PORT, tn.node_key(PORT, b"network-bsync-joiner"), gdoc.chain_id,
                          p2p_config=P2PConfig(pex=False), state=state, block_store=jbstore,
                          block_exec=ex, block_sync=True, moniker="joiner",
                          logger=NetLog("bsync-joiner", errors, trace=trace))
        nets.append(joiner)
        bs = joiner.reactors["BLOCKSYNC"]
        check(bs.device is None and joiner.transport.device is None,
              "network: part B's joiner is not on the card")

        # per height: apply and verify walls, launches and lanes; each
        # prefetch call's path
        per = collections.defaultdict(dict)
        calls = []
        prepared = []
        real = {"apply": ex.apply_verified_block, "light": validation.verify_commit_light,
                "prepare": validation.prepare_commit_light, "segments": ov.verify_segments,
                "validate": ex.validate_block}
        mark = {"cuda": (0, 0), "ed": 0}

        def apply_verified_block(st_, bid, block):
            t0 = time.perf_counter()
            try:
                return real["apply"](st_, bid, block)
            finally:
                h = block.header.height
                cuda = ds.tier_counts()["cuda"]
                b, l = cuda[0] - mark["cuda"][0], cuda[1] - mark["cuda"][1]
                per[h].update(apply_ms=round((time.perf_counter() - t0) * 1e3, 3),
                              ed25519_launches=cv.launches - mark["ed"],
                              lanes_per_launch=round(l / b, 1) if b else None)
                mark.update(cuda=cuda, ed=cv.launches)

        def verify_commit_light(chain_id, vals, block_id, height, commit, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real["light"](chain_id, vals, block_id, height, commit, *a, **kw)
            finally:
                per[height]["verify_ms"] = round((time.perf_counter() - t0) * 1e3, 3)

        def validate_block(st_, block):
            t0 = time.perf_counter()
            try:
                return real["validate"](st_, block)
            finally:
                per[block.header.height]["validate_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3)

        def prepare_commit_light(chain_id, vals, block_id, height, commit, **kw):
            prepared.append(height)
            return real["prepare"](chain_id, vals, block_id, height, commit, **kw)

        def verify_segments(work, device=None):
            lanes = sum(len(p) for p, _, _ in work)
            path = "fused" if lanes <= ov._BUCKETS[-1] else "verify_batches_overlapped"
            t0 = time.perf_counter()
            try:
                return real["segments"](work, device)
            finally:
                calls.append({"heights": list(prepared), "segments": len(work),
                              "lanes": lanes, "path": path,
                              "ms": round((time.perf_counter() - t0) * 1e3, 3)})
                prepared.clear()

        ex.apply_verified_block, ex.validate_block = apply_verified_block, validate_block
        validation.verify_commit_light = verify_commit_light
        validation.prepare_commit_light = prepare_commit_light
        ov.verify_segments = verify_segments
        try:
            sigcache.get_cache().clear()  # a joiner never saw the votes
            ds.reset()
            vstats.reset()
            tstats.reset()
            bstats.reset()
            handshake_pool.reset_pool()
            cv.reset_launches()
            csh.reset_launches()
            cuda_aead.reset_launches()
            cuda_x25519.reset_launches()
            moved[0] = 0
            t0 = time.perf_counter()
            server.start()
            joiner.start([server.address])
            deadline = time.perf_counter() + NETWORK_SYNC_TIMEOUT_S
            while bs.syncing:
                check(time.perf_counter() < deadline, f"network: part B's joiner at height "
                      f"{jbstore.height()} after {NETWORK_SYNC_TIMEOUT_S} s: peers "
                      f"{len(joiner.switch.peers_list())}, counters {bstats.snapshot()}, "
                      f"requests {sorted(bs.pool.requests)}, transport "
                      f"{ {k: v for k, v in tstats.snapshot().items() if k in ('frames', 'batches', 'dispatches', 'handshakes', 'bad_tags')} }, "
                      f"errors {errors[-5:]}, the nodes' last lines {list(trace)[-40:]}")
                time.sleep(0.01)
            wall = time.perf_counter() - t0
            joiner.stop()
            server.stop()
            launches = net_settled(cv, csh, cuda_aead, cuda_x25519, ds)
            snap, ts, synced = vstats.snapshot(), tstats.snapshot(), bstats.snapshot()
            dsnap = ds.snapshot()
            tiers = net_tiers(ds, "part B")
        finally:
            validation.verify_commit_light = real["light"]
            validation.prepare_commit_light = real["prepare"]
            ov.verify_segments = real["segments"]

        # -- what part B asserts ------------------------------------------
        check(jbstore.height() == top - 1, f"network: part B's joiner at height "
              f"{jbstore.height()}, want {top - 1} (block {top}'s LastCommit proves "
              f"{top - 1})")
        for h in range(1, top):
            check(codec.encode_block(jbstore.load_block(h)) == codec.encode_block(
                sbstore.load_block(h)), f"network: part B's block {h} differs from the server's")
        final = bs.state
        check(final.app_hash == sbstore.load_block(top).header.app_hash
              and jsstore.load().app_hash == final.app_hash,
              "network: part B's app hash != block 5's header app_hash")
        _, changed = final.validators.get_by_address(
            gdoc.validators[BLOCKEXEC_CHANGED].pub_key.address())
        check(final.last_block_height == top - 1
              and changed.voting_power == BLOCKEXEC_CHANGED_POWER,
              f"network: part B's validator set at height {top} does not carry the "
              f"height-{BLOCKEXEC_VAL_TX_AT} power change")
        ev_sub = snap["submitted"]["evidence_light"]
        check(ev_sub == 2, f"network: part B's evidence took {ev_sub} evidence-class "
              f"signatures on the card, want 2 (one flush at PRIO_EVIDENCE)")
        check(tiers["ed25519"]["cuda"][0] == launches["ed25519"] > 0
              and tiers["tree"]["cuda"][0] == launches["tree"] > 0,
              f"network: part B's launches {launches} != cuda batches {tiers}")
        check(tiers["aead"]["cuda"][0] == launches["aead"] > 0
              and ts["dispatches"]["host"] == 0 and tiers["ladder"]["cuda"][0]
              == launches["ladder"] > 0, f"network: part B's transport {tiers} {ts['dispatches']}")
        check(synced["heights_synced"] == top - 1, f"network: part B's counters {synced}")
        bad = [e for e in errors if any(b in e[2] for b in BLOCKSYNC_ERRORS)]
        check(not bad, f"network: blocksync logged {bad[:3]}")
        for h in range(1, top):
            row = {"height": h, **per[h]}
            call = next((c for c in calls if h in c["heights"]), None)
            row["prefetch"] = call["path"] if call else "none (the two-block pipeline)"
            print(f"network: part B height {json.dumps(row)} {tag}")
        mb = moved[0] / 1e6
        print(f"network: part B: phase 17's chain ({n} validators, {top} blocks) served by "
              f"a BlocksyncReactor behind a Switch; a fresh non-validator joiner "
              f"(InitChain on a new KVStore app, its own SQLite stores, BlockExecutor "
              f"and EvidencePool on the card, signature cache cleared) dialed it at "
              f"{P2PConfig().recv_rate} B/s and blocksynced heights 1-{top - 1} in "
              f"{wall:.2f} s: blocks byte for byte the server's, app hash == block "
              f"{top}'s header app_hash, validator {BLOCKEXEC_CHANGED} at power "
              f"{BLOCKEXEC_CHANGED_POWER} at height {top}, the height-"
              f"{BLOCKEXEC_EVIDENCE_AT} evidence checked on the card ({ev_sub} "
              f"evidence-class signatures); counters {synced}; prefetch calls {calls}; "
              f"fused_batches {dsnap['fused_batches']} (segments "
              f"{dsnap['fused_segments']}); launches {launches}; served by tier "
              f"{tiers}; no blocksync error logged {tag}")
        print(f"network: part B: transfer {mb:.3f} MB written to sockets through "
              f"{launches['aead']} AEAD launches ({ts['frames_per_batch']:.2f} frames a "
              f"pass, {ts['frames']['serial']} frames serial) = {mb / wall:.3f} MB/s over "
              f"the sync's wall of {wall:.2f} s {tag}")
        return {"launches": launches, "wall_s": wall, "validators": n}
    finally:
        sdb.close()
        if jdb is not None:
            jdb.close()

def _sign_secp_chunk(jobs):
    """Worker of phase 20: (secp256k1 secret, message) pairs -> signatures
    (RFC 6979, the port's pure-Python signer)."""
    from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey

    return [Secp256k1PrivKey.from_secret(sk).sign(msg) for sk, msg in jobs]


def abci_app_child(run_dir: str) -> int:
    """Phase 20's out-of-process app: a port ``KVStoreApplication`` behind
    ``abci/server.ABCIServer`` on 127.0.0.1 (a free port, written to
    ``abci-port.json`` in ``run_dir``), until ``stop`` appears there or
    the parent is gone."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.server import ABCIServer

    parent = os.getppid()
    srv = ABCIServer(KVStoreApplication(), "tcp://127.0.0.1:0")
    srv.start()
    net_write(os.path.join(run_dir, "abci-port.json"), {"port": srv.bound_port,
                                                        "pid": os.getpid()})
    try:
        while not os.path.exists(os.path.join(run_dir, "stop")) and os.getppid() == parent:
            time.sleep(0.1)
    finally:
        srv.stop()
    return 0


class LogLines(logging.Handler):
    """Keeps the records of a logger whose message holds one of ``marks``."""

    def __init__(self, marks):
        super().__init__(logging.DEBUG)
        self.marks, self.lines = marks, []

    def emit(self, record) -> None:
        msg = record.getMessage()
        if any(m in msg for m in self.marks):
            self.lines.append(msg)


class EnvCounter:
    """Counts envelopes through ``txingest.envelope.verify_envelopes`` made
    inside a marked call (a thread flag): entries, and those whose verdict
    the signature cache did not hold when the call began."""

    def __init__(self, ev, sigcache):
        self.ev, self.sigcache = ev, sigcache
        self.real = ev.verify_envelopes
        self.flag = threading.local()
        self.calls = self.entries = self.misses = 0

    def mark(self, fn):
        def marked(*a, **kw):
            self.flag.on = True
            try:
                return fn(*a, **kw)
            finally:
                self.flag.on = False
        return marked

    def __call__(self, envs):
        if getattr(self.flag, "on", False):
            cache = self.sigcache.get_cache()
            live = [e for e in envs if e is not None]
            self.calls += 1
            self.entries += len(live)
            self.misses += sum(cache.get(e.pubkey, e.sign_bytes(), e.signature) is None
                               for e in live if e.key_type == self.ev.KEY_ED25519)
        return self.real(envs)


class RecheckCounter:
    """Per mempool: each post-commit recheck's size and the app calls made
    inside it (``check_txs`` batches, ``check_tx`` singles)."""

    def __init__(self, mempool, mark=lambda fn: fn):
        self.rows = []
        self.flag = threading.local()
        real_recheck, conn = mark(mempool._recheck_txs), mempool.proxy_app
        real_batch, real_single = conn.check_txs, conn.check_tx

        def recheck():
            self.flag.row = [len(mempool._tx_map), 0, 0]
            try:
                return real_recheck()
            finally:
                self.rows.append(tuple(self.flag.row))
                self.flag.row = None

        def batch(reqs):
            if getattr(self.flag, "row", None) is not None:
                self.flag.row[1] += 1
            return real_batch(reqs)

        def single(req):
            if getattr(self.flag, "row", None) is not None:
                self.flag.row[2] += 1
            return real_single(req)

        mempool._recheck_txs, conn.check_txs, conn.check_tx = recheck, batch, single

    def batched(self) -> bool:
        return all(b == 1 and s == 0 for n, b, s in self.rows if n > 1)


class LaunchOrigins:
    """Attributes part A's Ed25519 launches to the paths that asked for
    them.  ``mark(tag, fn)`` names the path of a call in progress in a
    thread flag ("V admission", "S recheck", ...; the outermost mark wins);
    the scheduler's ``submit`` notes the tag of each check it queues, and
    each flush (``_execute``, where the dispatcher launches) adds its
    launches to every tag its checks carry.  ``envelopes`` answers the
    envelopes of a call marked "S ..." that S verified before from S's own
    verdicts: V and S share this process's signature cache, which part A
    clears so that V verifies afresh, while a sentry on its own machine
    keeps its own cache."""

    def __init__(self, cv):
        self.cv = cv
        self.flag = threading.local()
        self.queued = {}  # (pub, msg, sig) -> tag, until its flush
        self.launches = collections.Counter()  # tag -> launches of the flushes carrying it
        self.lanes = collections.Counter()  # tag -> its own checks in those flushes
        self.flush_lanes = collections.Counter()  # tag -> every check of those flushes
        self.current = None  # the tags of the flush being launched (dispatcher thread)
        self.sentry = {}  # S's verdicts: (key type, pubkey, sign bytes, signature) -> bool
        self.sentry_answered = 0

    def tag(self):
        return getattr(self.flag, "tag", None)

    def mark(self, tag: str, fn):
        def marked(*a, **kw):
            outer = self.tag()
            if outer is None:
                self.flag.tag = tag
            try:
                return fn(*a, **kw)
            finally:
                if outer is None:
                    self.flag.tag = None
        return marked

    def install(self, sched):
        """Wraps ``sched``'s ``submit`` and ``_execute``; returns the undo."""
        real_submit, real_execute = sched.submit, sched._execute

        def submit(pub, msg, sig, *a, **kw):
            t = self.tag()
            if t is not None:
                self.queued[(bytes(pub), bytes(msg), bytes(sig))] = t
            return real_submit(pub, msg, sig, *a, **kw)

        def execute(items, reason):
            tags = collections.Counter(
                self.queued.pop((bytes(it.pub), bytes(it.msg), bytes(it.sig)), "untagged")
                for it in items)
            n0 = self.cv.launches
            self.current = tags
            try:
                return real_execute(items, reason)
            finally:
                self.current = None
                d = self.cv.launches - n0
                for t, n in tags.items():
                    self.launches[t] += d
                    self.lanes[t] += n
                    self.flush_lanes[t] += len(items)

        sched.submit, sched._execute = submit, execute

        def undo():
            del sched.submit, sched._execute
        return undo

    def envelopes(self, inner):
        """``txingest.envelope.verify_envelopes`` with S's own cache in
        front of ``inner`` for the calls marked "S ..."."""
        def verify(envs):
            t = self.tag()
            if t is None or not t.startswith("S "):
                return inner(envs)
            key = lambda e: (e.key_type, e.pubkey, e.sign_bytes(), e.signature)
            out, todo = [False] * len(envs), []
            for i, e in enumerate(envs):
                if e is not None:
                    v = self.sentry.get(key(e))
                    if v is None:
                        todo.append(i)
                    else:
                        out[i] = v
                        self.sentry_answered += 1
            if todo:
                ask = set(todo)
                got = inner([e if i in ask else None for i, e in enumerate(envs)])
                for i in todo:
                    out[i] = self.sentry[key(envs[i])] = bool(got[i])
            return out
        return verify


def ingest_traffic(rng, pool_ex, workers, senders, secp_secrets, r: int, nonces) -> dict:
    """Round ``r``'s 5,000 client txs of phase 20 by kind, and its replays.
    Each Ed25519 sender's nonces rise across rounds (``nonces``)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.txingest import envelope as ev

    def payload(tag: bytes, k: int) -> bytes:
        head = b"%s%d-%05d=" % (tag, r, k)
        return head + rng.bytes(INGEST_TX_BYTES).hex().encode()[: INGEST_TX_BYTES - len(head)]

    def take(key, who) -> int:
        nonces[key] = nonces.get(key, -1) + 1
        return nonces[key]

    ed_jobs, ed_meta = [], []  # (expanded key, sign bytes); (kind, sender, nonce, payload)
    for k in range(INGEST_ED):
        s = k % len(senders)
        n, p = take(("ed", s), s), payload(b"e", k)
        ed_jobs.append((senders[s], ev.sign_bytes(ev.KEY_ED25519, senders[s][2], n, p)))
        ed_meta.append(("ed25519", s, n, p))
    first = {}
    for kind, s, n, _ in ed_meta:
        first.setdefault(s, n)
    for k in range(INGEST_FORGED):
        s = k % len(senders)
        n, p = (1 << 40) + r * INGEST_FORGED + k, payload(b"f", k)
        ed_jobs.append((senders[s], ev.sign_bytes(ev.KEY_ED25519, senders[s][2], n, p)))
        ed_meta.append(("forged", s, n, p))
    for k in range(INGEST_REPLAYS):
        s = (k * 97) % len(senders)
        n, p = first[s], payload(b"r", k)  # a nonce this round already used
        ed_jobs.append((senders[s], ev.sign_bytes(ev.KEY_ED25519, senders[s][2], n, p)))
        ed_meta.append(("replay", s, n, p))
    secp_jobs, secp_meta = [], []
    for k in range(INGEST_SECP):
        j = k % len(secp_secrets)
        sk, pub = secp_secrets[j]
        n, p = take(("secp", j), j), payload(b"s", k)
        secp_jobs.append((sk, ev.sign_bytes(ev.KEY_SECP256K1, pub, n, p)))
        secp_meta.append(("secp256k1", j, n, p))
    t0 = time.perf_counter()
    sigs = in_chunks(pool_ex, _sign_chunk, ed_jobs, workers)
    ssigs = in_chunks(pool_ex, _sign_secp_chunk, secp_jobs, workers)
    sign_s = time.perf_counter() - t0
    out = collections.defaultdict(list)  # kind -> [(thread, tx)]
    for (kind, s, n, p), sig in zip(ed_meta, sigs):
        if kind == "forged":
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        tx = ev.encode(ev.Envelope(ev.KEY_ED25519, senders[s][2], n, p, sig))
        out[kind].append((s % INGEST_CLIENTS, tx))
    for (kind, j, n, p), sig in zip(secp_meta, ssigs):
        tx = ev.encode(ev.Envelope(ev.KEY_SECP256K1, secp_secrets[j][1], n, p, sig))
        out[kind].append((j % INGEST_CLIENTS, tx))
    for k in range(INGEST_MALFORMED):
        tx = ev.MAGIC + bytes([ev.KEY_ED25519]) + (r * 100 + k).to_bytes(8, "big") + b"short%d" % k
        out["malformed"].append((k % INGEST_CLIENTS, tx))
    out["sign_s"] = sign_s
    return out


def submit_clients(check_tx, items, errors_cls) -> tuple:
    """``items`` ((thread, tx) pairs) through ``check_tx`` (a mempool's)
    from INGEST_CLIENTS threads, each its own share in order, as
    ``broadcast_tx_sync`` calls arrive.  Returns ({tx: code or error
    name}, wall s)."""
    shares = collections.defaultdict(list)
    for t, tx in items:
        shares[t].append(tx)
    got, lock = {}, threading.Lock()

    def client(txs):
        for tx in txs:
            try:
                code = check_tx(tx).code
            except errors_cls as e:
                code = type(e).__name__
            with lock:
                got[tx] = code

    threads = [threading.Thread(target=client, args=(txs,), name=f"client-{t}")
               for t, txs in sorted(shares.items())]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(INGEST_TIMEOUT_S)
    check(not any(th.is_alive() for th in threads), "ingest: a client thread hung")
    return got, time.perf_counter() - t0


def wait_until(cond, timeout_s: float, what) -> float:
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout_s, f"timed out waiting for {what() if callable(what) else what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def ingest_part_a(torch, cbatch, cv, ds, sigcache, tag, tn, origins) -> dict:
    """Phase 20, part A: a validator V behind a sentry S in this process
    over one link; ``INGEST_ROUNDS`` rounds of 5,000 client txs at S.  ``origins``
    (LaunchOrigins) attributes the Ed25519 launches to V's and S's paths
    and keeps S's own verdicts."""
    import concurrent.futures
    import multiprocessing
    import pathlib

    import numpy as np

    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.config.config import ConsensusConfig, MempoolConfig, P2PConfig
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
    from cometbft_tpu_torch.mempool.clist_mempool import MempoolError
    from cometbft_tpu_torch.mempool.reactor import MEMPOOL_CHANNEL
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats
    from cometbft_tpu_torch.sim.node import build_node, make_genesis
    from cometbft_tpu_torch import txingest
    from cometbft_tpu_torch.txingest import envelope as ev
    from cometbft_tpu_torch.txingest import stats as istats
    from cometbft_tpu_torch.verifysched import service
    from cometbft_tpu_torch.verifysched import stats as vstats

    rng = np.random.default_rng(INGEST_SEED)
    root = pathlib.Path(tempfile.mkdtemp(prefix="ingest-"))
    workers = BLOCKEXEC_SIGNERS
    pool_ex = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    errors, nets, handles, sched = [], [], [], None
    admission = LogLines(("batched admission failed",))
    ilog = logging.getLogger("cometbft_tpu_torch.txingest")
    ilog.addHandler(admission)
    counter = EnvCounter(ev, sigcache)
    real_now = service.verify_now
    secp_host = collections.Counter()

    def verify_now(pub_key, msg, sig):
        secp_host[getattr(pub_key, "type_", "?")] += 1
        return real_now(pub_key, msg, sig)

    try:
        t0 = time.perf_counter()
        seeds = [rng.bytes(32) for _ in range(INGEST_SENDERS)]
        senders = in_chunks(pool_ex, _expand_chunk, seeds, workers)
        secp_secrets = []
        for j in range(INGEST_SECP_SENDERS):
            sk = rng.bytes(32)
            secp_secrets.append((sk, Secp256k1PrivKey.from_secret(sk).pub_key().bytes()))
        keys_s = time.perf_counter() - t0
        privs, gdoc = make_genesis(1, INGEST_CHAIN, seed_tag=b"ingest-20261037-%d", n_nodes=2)
        mcfg = MempoolConfig()
        cfg = ConsensusConfig()
        for i, name in enumerate(("V", "S")):
            h = build_node(i, privs[i], gdoc, root, config=cfg, threaded=True,
                           app_factory=lambda: txingest.SigVerifyingApp(KVStoreApplication()),
                           mempool_config=mcfg)
            check(h.mempool.envelope_aware, f"ingest: {name}'s mempool is not envelope-aware")
            h.cs.logger = NetLog(name, errors).with_(module="consensus")
            handles.append(h)
        hv, hs = handles
        ings = [txingest.IngestCoalescer(h.mempool) for h in handles]
        check(all(i.active() and i.device is None for i in ings) and
              verifysched.scheduler_active(), "ingest: the coalescers are not on the card")
        for i, (h, name) in enumerate(zip(handles, ("V", "S"))):
            nets.append(tn.from_handle(tn.PORT, h, tn.node_key(tn.PORT, b"ingest-" + name.encode()),
                                       INGEST_CHAIN, block_sync=False, p2p_config=P2PConfig(),
                                       mempool_config=mcfg, home=str(root / f"node{i}"),
                                       moniker=name, logger=NetLog(name, errors),
                                       ingest=ings[i]))
        nv, ns = nets
        rechecks = [RecheckCounter(h.mempool, lambda fn, n=name: origins.mark(f"{n} recheck", fn))
                    for h, name in zip(handles, ("V", "S"))]
        pv, ps = nv.reactors["MEMPOOL"], ns.reactors["MEMPOOL"]
        for name in ("process_proposal", "finalize_block"):
            setattr(hv.app, name, origins.mark("V apply", counter.mark(getattr(hv.app, name))))
            setattr(hs.app, name, origins.mark("S apply", getattr(hs.app, name)))
        for name in ("check_tx", "check_txs"):
            setattr(hs.app, name, origins.mark("S app", getattr(hs.app, name)))
        ev.verify_envelopes = origins.envelopes(counter)
        service.verify_now = verify_now
        flush_ms = []
        real_batch = origins.mark("V admission", hv.mempool.check_tx_batch)

        def timed_batch(*a, **kw):
            t1 = time.perf_counter()
            try:
                return real_batch(*a, **kw)
            finally:
                flush_ms.append((time.perf_counter() - t1) * 1e3)

        hv.mempool.check_tx_batch = timed_batch
        hs.mempool.check_tx_batch = origins.mark("S gossip", hs.mempool.check_tx_batch)
        s_check_tx = origins.mark("S client", hs.mempool.check_tx)
        sched = verifysched.get_scheduler()
        unwrap = origins.install(sched)
        ds.reset()
        vstats.reset()
        istats.reset()
        tstats.reset()
        handshake_pool.reset_pool()
        for w in (cv, csh, cuda_aead, cuda_x25519):
            w.reset_launches()
        t_run = time.perf_counter()
        nv.start()
        ns.start([nv.address])
        wait_until(lambda: len(ns.switch.peers_list()) == 1 and len(nv.switch.peers_list()) == 1,
                   INGEST_TIMEOUT_S, "ingest: the sentry's link")
        gate = threading.Event()
        peer = ns.switch.peers_list()[0]
        real_send = peer.try_send

        def gated(ch, msg):
            if ch == MEMPOOL_CHANNEL and not gate.is_set():
                return False
            return real_send(ch, msg)

        peer.try_send = gated
        v_id = nv.node_id
        s_on_v = lambda: pv.peer_ingest_stats().get(ns.node_id, {})
        rounds, nonces, committed, heights = [], {}, {}, {}
        held = set()  # replays S holds
        tagged = lambda: {k: collections.Counter(getattr(origins, k))
                          for k in ("launches", "lanes", "flush_lanes")}
        for r in range(INGEST_ROUNDS):
            traffic = ingest_traffic(rng, pool_ex, workers, senders, secp_secrets, r, nonces)
            main = [x for k in ("ed25519", "secp256k1", "forged", "malformed")
                    for x in traffic[k]]
            gate.clear()
            o0 = tagged()
            codes, s_wall = submit_clients(s_check_tx, main, MempoolError)
            want = {"ed25519": 0, "secp256k1": 0, "forged": ev.CODE_BAD_SIGNATURE,
                    "malformed": ev.CODE_BAD_ENVELOPE}
            for kind, code in want.items():
                bad = [codes[tx] for _, tx in traffic[kind] if codes[tx] != code]
                check(not bad, f"ingest: round {r}: {len(bad)} {kind} txs at S got {bad[:3]}, "
                      f"want {code}")
            valid = {tx for k in ("ed25519", "secp256k1") for _, tx in traffic[k]}
            # V is another machine: it has verified none of these signatures
            # (in this process the signature cache would hand it S's verdicts)
            sigcache.get_cache().clear()
            a0 = s_on_v().get("accepted", 0)
            rej0 = istats.snapshot()["rejected"].get(str(ev.CODE_STALE_NONCE), 0)
            t1 = time.perf_counter()
            gate.set()
            v_wall = wait_until(lambda: s_on_v().get("accepted", 0) - a0 >= len(valid),
                                INGEST_TIMEOUT_S, lambda: f"ingest: round {r}: V admitted "
                                f"{s_on_v().get('accepted', 0) - a0} of {len(valid)}; S's "
                                f"stats on V {s_on_v()}, errors {errors[-3:]}")
            rcodes, _ = submit_clients(s_check_tx, traffic["replay"], MempoolError)
            check(all(c == 0 for c in rcodes.values()), f"ingest: round {r}: S refused a "
                  f"replay: {sorted(set(rcodes.values()))} (S keeps no nonces)")
            held |= set(rcodes)
            wait_until(lambda: istats.snapshot()["rejected"].get(str(ev.CODE_STALE_NONCE), 0)
                       - rej0 >= INGEST_REPLAYS, INGEST_TIMEOUT_S,
                       lambda: f"ingest: round {r}: V's 103s {istats.snapshot()['rejected']}")

            def settled():
                top = hv.block_store.height()
                for hh in range(len(heights) + 1, top + 1):
                    meta = hv.block_store.load_block_meta(hh)
                    heights[hh] = (meta.header.time.to_ns() / 1e9, meta.num_txs)
                    for tx in hv.block_store.load_block(hh).data.txs:
                        committed[tx] = hh
                return (valid <= committed.keys() and hv.mempool.size() == 0
                        and hs.block_store.height() >= top
                        and set(hs.mempool.reap_max_txs(-1)) == held)

            commit_wall = wait_until(settled, INGEST_TIMEOUT_S, lambda: (
                f"ingest: round {r}: committed {len(valid & committed.keys())} of "
                f"{len(valid)}, V's mempool {hv.mempool.size()}, S's {hs.mempool.size()} "
                f"(held {len(held)}), heights V {hv.block_store.height()} S "
                f"{hs.block_store.height()}, errors {errors[-3:]}"))
            check(not any(tx in committed for tx in held), "ingest: V committed a replay")
            o1 = tagged()
            d = {k: o1[k] - o0[k] for k in o1}
            per = lambda t: round(d["flush_lanes"][t] / max(d["launches"][t], 1), 2)
            rounds.append({
                "round": r, "sign_s": round(traffic["sign_s"], 2),
                "s_admit_s": round(s_wall, 3), "s_txs_per_s": round(len(main) / s_wall, 1),
                "s_launches": d["launches"]["S client"], "s_lanes": d["lanes"]["S client"],
                "s_lanes_per_launch": per("S client"),
                "v_admit_s": round(v_wall, 3), "v_txs_per_s": round(len(valid) / v_wall, 1),
                "v_launches": d["launches"]["V admission"], "v_lanes": d["lanes"]["V admission"],
                "v_lanes_per_launch": per("V admission"),
                "launches_by_path": dict(d["launches"]), "lanes_by_path": dict(d["lanes"]),
                "commit_wait_s": round(commit_wall, 3), "to_height": hv.block_store.height()})
            print(f"ingest: part A round {json.dumps(rounds[-1])} {tag}", flush=True)
        wall = time.perf_counter() - t_run
        for n in nets:
            n.stop()
        for h in handles:
            h.cs.stop()
        for i in ings:
            i.close()
        launches = net_settled(cv, csh, cuda_aead, cuda_x25519, ds)
        check(verifysched.get_scheduler() is sched, "ingest: the verify scheduler was replaced "
              "during part A: its launches were not all attributed")
        unwrap()
        for h in handles:
            h.app_conns.stop()
        tiers = net_tiers(ds, "ingest part A")
        snap, isnap, ts = vstats.snapshot(), istats.snapshot(), tstats.snapshot()
    finally:
        ilog.removeHandler(admission)
        ev.verify_envelopes = counter.real
        service.verify_now = real_now
        if sched is not None and "submit" in vars(sched):
            unwrap()
        for n in nets:
            n.stop()
        pool_ex.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)

    # -- what part A asserts -------------------------------------------------
    check(tiers["ed25519"]["cuda"][0] == launches["ed25519"] > 0,
          f"ingest: Ed25519 launches {launches} != cuda batches {tiers['ed25519']}")
    check(all(x["s_launches"] > 0 and x["v_launches"] > 0 for x in rounds),
          f"ingest: a node made no mempool-class launch in a round: {rounds}")
    check(origins.launches["S recheck"] == 0 and origins.launches["S apply"] == 0,
          f"ingest: S verified again what it had verified (launches by path "
          f"{dict(origins.launches)})")
    check(counter.calls > 0 and counter.entries > 0 and counter.misses == 0,
          f"ingest: V's process_proposal/finalize_block re-checks: {counter.calls} calls, "
          f"{counter.entries} envelopes, {counter.misses} not in the signature cache")
    for name, rc in zip(("V", "S"), rechecks):
        check(rc.batched(), f"ingest: {name}'s rechecks {rc.rows} (size, check_txs, "
              f"check_tx): each of more than one tx must be one check_txs")
    check(any(n > 1 for n, _, _ in rechecks[1].rows),
          f"ingest: S never rechecked more than one tx: {rechecks[1].rows}")
    check(not admission.lines, f"ingest: logged {admission.lines[:3]}")
    check(isnap["rejected"].get(str(ev.CODE_STALE_NONCE), 0) == INGEST_ROUNDS * INGEST_REPLAYS,
          f"ingest: 103s {isnap['rejected']}")
    bad = [e for e in errors if "failure" in e[2] or "error" in e[2].lower()]
    txs = [heights[hh][1] for hh in sorted(heights)]
    times = [heights[hh][0] for hh in sorted(heights)]
    gaps = [round((b - a) * 1e3, 1) for a, b in zip(times, times[1:])]
    full = [g for g, n in zip(gaps, txs[1:]) if n]
    ms = sorted(flush_ms)
    p = lambda q: round(ms[min(len(ms) - 1, int(q * len(ms)))], 3) if ms else None
    print(f"ingest: part A: a validator V (SigVerifyingApp(KVStoreApplication()), "
          f"CListMempool(envelope_aware=True), MempoolConfig() {mcfg.size} txs, cache "
          f"{mcfg.cache_size}) behind a sentry S over one SecretConnection link at the "
          f"P2PConfig defaults, an IngestCoalescer at its defaults on each (batch "
          f"{ings[0].batch_max}, {ings[0].flush_s * 1e6:.0f} us, queue {ings[0].queue_cap}); "
          f"{INGEST_ROUNDS} rounds of {INGEST_CLIENTS} client threads calling S's "
          f"check_tx with {INGEST_ED} Ed25519 envelopes ({INGEST_SENDERS} senders, rising "
          f"nonces), {INGEST_SECP} secp256k1 ({INGEST_SECP_SENDERS} senders), "
          f"{INGEST_FORGED} forged (102 at S), {INGEST_MALFORMED} malformed (101 at S), "
          f"then {INGEST_REPLAYS} re-signed at a used nonce (0 at S, 103 at V); V committed "
          f"every valid tx S admitted and none of the {len(held)} replays S holds; "
          f"{counter.calls} re-checks in V's process_proposal/finalize_block over "
          f"{counter.entries} envelopes, all in the signature cache (0 launches); rechecks "
          f"(size, check_txs, check_tx) V {rechecks[0].rows[:6]}..., S "
          f"{rechecks[1].rows[:6]}...; no 'batched admission failed' line; S's rechecks and "
          f"applies answered from S's own verdicts ({origins.sentry_answered} envelopes: "
          f"the harness clears the shared signature cache for V, a sentry keeps its own); "
          f"Ed25519 launches by path {dict(origins.launches)}, their own checks "
          f"{dict(origins.lanes)}, all checks of those flushes {dict(origins.flush_lanes)}; "
          f"keys {keys_s:.2f} s (set-up) {tag}", flush=True)
    print(f"ingest: part A: heights 1-{len(heights)} in {wall:.2f} s, txs a block {txs}, "
          f"block interval ms (header times) median {statistics.median(gaps) if gaps else None}"
          f", before a block with txs {full}; V's coalescer flushes {len(ms)}, "
          f"check_tx_batch ms p50 {p(0.5)} "
          f"p99 {p(0.99)}; txingest/stats {json.dumps({k: isnap[k] for k in ('flushes', 'flush_txs', 'shed_to_sync', 'sig_prechecked', 'rejected', 'errors', 'app_batches', 'recheck_batches', 'recheck_txs', 'cache_hits')})}; "
          f"verifysched shed fallbacks by class {snap['shed_fallback']}, shed "
          f"{snap['shed']}; host verify_now calls by key type {dict(secp_host)} (a "
          f"secp256k1 envelope is one host verify, as in the JAX package); launches "
          f"{launches}, served by tier {tiers}; transport AEAD passes {ts['batches']}; "
          f"node errors {bad[:3]} {tag}", flush=True)
    return {"launches": launches, "wall_s": wall, "rounds": rounds}


def statesync_part_b(torch, cbatch, cv, ds, sigcache, chain, tag, tn) -> dict:
    """Phase 20, part B: a helper H serves phase 17's chain, extended to
    height 7, and a fresh joiner J with its app in a child process
    statesyncs its snapshot at 5, then blocksyncs block 6."""
    import base64
    import concurrent.futures
    import multiprocessing
    from types import SimpleNamespace

    import numpy as np

    from cometbft_tpu_torch.abci import types as at
    from cometbft_tpu_torch.abci.client import LocalClient, SocketClient
    from cometbft_tpu_torch.abci.kvstore import SNAPSHOT_CHUNK_SIZE, SNAPSHOT_INTERVAL
    from cometbft_tpu_torch.blocksync import stats as bstats
    from cometbft_tpu_torch.config.config import P2PConfig, StateSyncConfig
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.light.verifier import TrustOptions
    from cometbft_tpu_torch.mempool.clist_mempool import NopMempool
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats
    from cometbft_tpu_torch.proxy.multi_app_conn import (
        AppConns, local_client_creator, remote_client_creator)
    from cometbft_tpu_torch.state import execution
    from cometbft_tpu_torch.state.state import _params_to_json, state_from_genesis
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.statesync import syncer as ssyncer
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV
    from cometbft_tpu_torch.types.basic import BLOCK_ID_FLAG_COMMIT, BlockID, Timestamp
    from cometbft_tpu_torch.types.block import Commit
    from cometbft_tpu_torch.types.vote import CommitSig
    from cometbft_tpu_torch.verifysched import stats as vstats

    gdoc, keys, app = chain["genesis"], chain["keys"], chain["app"]
    check(app.height == SNAPSHOT_INTERVAL and SNAPSHOT_INTERVAL in app._snapshots,
          f"statesync: phase 17's app is at height {app.height}, snapshots "
          f"{sorted(app._snapshots)}")
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey

    key_by_addr = {Ed25519PubKey(k[2]).address(): k for k in keys}
    rng = np.random.default_rng(STATESYNC_SEED)
    workers = BLOCKEXEC_SIGNERS
    pool_ex = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    run_dir = tempfile.mkdtemp(prefix="statesync-")
    errors, nets, child, jconns, hconns = [], [], None, None, None
    hdb = jdb = None
    real_fetch = ssyncer.Syncer._fetch_chunks
    try:
        # -- H: phase 17's chain extended by blocks 6 and 7 -----------------
        hdb = SqliteKV(chain["db"], surface="state")
        hbs, hss = BlockStore(hdb), StateStore(hdb)
        state = hss.load()
        at5 = state
        check(state.last_block_height == SNAPSHOT_INTERVAL, "statesync: the chain is not at 5")
        hclient = LocalClient(app)
        hpool = EvidencePool(hdb, hss, hbs)
        hex_ = execution.BlockExecutor(hss, hbs, hclient, NopMempool(), evidence_pool=hpool)
        last_commit = hbs.load_seen_commit(state.last_block_height)
        t0 = time.perf_counter()
        for h in range(SNAPSHOT_INTERVAL + 1, STATESYNC_TOP + 1):
            hexed = rng.bytes(BLOCKEXEC_TXS * BLOCKEXEC_TX_BYTES // 2).hex().encode()
            txs = []
            for i in range(BLOCKEXEC_TXS):
                head = b"h%d-%05d=" % (h, i)
                o = i * BLOCKEXEC_TX_BYTES
                txs.append(head + hexed[o : o + BLOCKEXEC_TX_BYTES - len(head)])
            block = execution.make_block(h, txs, last_commit, state,
                                         state.validators.get_proposer().address,
                                         Timestamp(BLOCKEXEC_T0 + 6 * h, 0))
            parts = block.make_part_set(BLOCKEXEC_PART)
            bid = BlockID(block.hash(), parts.header)
            base_ns = (BLOCKEXEC_T0 + 6 * h + 1) * 10**9
            sigs = []
            for i, v in enumerate(state.validators.validators):
                if i == BLOCKEXEC_ABSENT:
                    sigs.append(CommitSig.absent_sig())
                    continue
                ns_ = base_ns + 1_000_003 * i
                sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                                      Timestamp(ns_ // 10**9, ns_ % 10**9), b""))
            commit = Commit(h, 0, bid, sigs)
            idx = [i for i, cs in enumerate(sigs) if not cs.absent()]
            msgs = commit.all_vote_sign_bytes(gdoc.chain_id, idx)
            jobs = [(key_by_addr[sigs[i].validator_address], m) for i, m in zip(idx, msgs)]
            for i, s in zip(idx, in_chunks(pool_ex, _sign_chunk, jobs, workers)):
                sigs[i].signature = s
            hbs.save_block(block, parts, commit)
            state = hex_.apply_block(state, bid, block)
            last_commit = commit
        extend_s = time.perf_counter() - t0
        check(hbs.height() == STATESYNC_TOP and app.height == STATESYNC_TOP
              and sorted(app._snapshots) == [SNAPSHOT_INTERVAL],
              f"statesync: H at {hbs.height()}, app {app.height}, snapshots "
              f"{sorted(app._snapshots)}")
        h6, h7 = (hbs.load_block_meta(h).header for h in (SNAPSHOT_INTERVAL + 1, STATESYNC_TOP))
        snap_bytes = len(app._snapshots[SNAPSHOT_INTERVAL])
        n_chunks = -(-snap_bytes // SNAPSHOT_CHUNK_SIZE)
        hconns = AppConns(local_client_creator(app))
        hconns.start()
        print(f"statesync: H: phase 17's SQLite chain extended by blocks "
              f"{SNAPSHOT_INTERVAL + 1}-{STATESYNC_TOP} ({BLOCKEXEC_TXS} txs of "
              f"{BLOCKEXEC_TX_BYTES} bytes, commits of {len(keys) - 1} votes, seed "
              f"{STATESYNC_SEED}) in {extend_s:.2f} s (set-up: signing and applying); the "
              f"KVStore snapshot at height {SNAPSHOT_INTERVAL}: {snap_bytes} bytes in "
              f"{n_chunks} chunks of {SNAPSHOT_CHUNK_SIZE} {tag}", flush=True)

        # -- J: the app in a child process, behind the ABCI socket ----------
        script = os.path.abspath(__file__)
        log = open(os.path.join(run_dir, "app.log"), "w")
        child = (subprocess.Popen([sys.executable, script, "--abci-app", run_dir],
                                  cwd=os.path.dirname(script), stdout=log,
                                  stderr=subprocess.STDOUT), log)
        t0 = time.perf_counter()
        wait_until(lambda: net_read(os.path.join(run_dir, "abci-port.json")) is not None,
                   60.0, "statesync: the app child's port")
        port = net_read(os.path.join(run_dir, "abci-port.json"))["port"]
        addr = f"tcp://127.0.0.1:{port}"
        jconns = AppConns(remote_client_creator(addr))
        jconns.start()
        check(all(isinstance(c, SocketClient) for c in (
            jconns.consensus, jconns.mempool, jconns.query, jconns.snapshot)),
            "statesync: J's connections are not sockets")
        app_up_s = time.perf_counter() - t0
        socket_ms = collections.defaultdict(list)
        for c in (jconns.consensus, jconns.snapshot, jconns.query):
            real = c.call

            def timed(method, req, _real=real):
                t1 = time.perf_counter()
                try:
                    return _real(method, req)
                finally:
                    socket_ms[method].append((time.perf_counter() - t1) * 1e3)

            c.call = timed
        jstate = state_from_genesis(gdoc)
        res = jconns.consensus.init_chain(at.InitChainRequest(
            time_unix_ns=gdoc.genesis_time.to_ns(), chain_id=gdoc.chain_id,
            consensus_params=_params_to_json(gdoc.consensus_params),
            validators=[at.ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power)
                        for v in gdoc.validators],
            app_state_bytes=gdoc.app_state, initial_height=gdoc.initial_height))
        jstate.app_hash = res.app_hash
        jdb = SqliteKV(os.path.join(run_dir, "joiner.db"), surface="state")
        jbs, jss = BlockStore(jdb), StateStore(jdb)
        jpool = EvidencePool(jdb, jss, jbs)
        jex = execution.BlockExecutor(jss, jbs, jconns.consensus, NopMempool(),
                                      evidence_pool=jpool)
        hnet = tn.build(tn.PORT, tn.node_key(tn.PORT, b"statesync-helper"), gdoc.chain_id,
                        p2p_config=P2PConfig(pex=False), state=state, block_store=hbs,
                        block_sync=False, statesync_app=hconns, moniker="helper",
                        logger=NetLog("helper", errors))
        nets.append(hnet)
        jnet = tn.build(tn.PORT, tn.node_key(tn.PORT, b"statesync-joiner"), gdoc.chain_id,
                        p2p_config=P2PConfig(pex=False), state=jstate, block_exec=jex,
                        block_store=jbs, block_sync=False, statesync_app=jconns,
                        moniker="joiner", logger=NetLog("joiner", errors))
        nets.append(jnet)
        check(jnet.reactors["BLOCKSYNC"].device is None and jnet.transport.device is None,
              "statesync: J is not on the card")
        hnode = SimpleNamespace(genesis_doc=gdoc, block_store=hbs, state_store=hss,
                                evidence_pool=hpool, consensus=SimpleNamespace(state=state),
                                node_key=SimpleNamespace(node_id=hnet.node_id))
        trust = TrustOptions(StateSyncConfig().trust_period_s, 1,
                             hbs.load_block_meta(1).block_id.hash)

        # -- the sync --------------------------------------------------------
        requests = collections.Counter()
        hops = []
        real_req = jnet.reactors["STATESYNC"].request_chunk

        def request_chunk(peer_id, height, fmt, index):
            requests[index] += 1
            return real_req(peer_id, height, fmt, index)

        jnet.reactors["STATESYNC"].request_chunk = request_chunk
        fetch_s = []

        def fetch(self, snapshot):
            t1 = time.perf_counter()
            try:
                return real_fetch(self, snapshot)
            finally:
                fetch_s.append(time.perf_counter() - t1)

        ssyncer.Syncer._fetch_chunks = fetch
        sigcache.get_cache().clear()  # J never saw these votes
        ds.reset()
        vstats.reset()
        tstats.reset()
        bstats.reset()
        handshake_pool.reset_pool()
        for w in (cv, csh, cuda_aead, cuda_x25519):
            w.reset_launches()
        from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider

        t_run = time.perf_counter()
        provider = LightClientStateProvider(
            gdoc.chain_id, [NodeProvider(hnode)], trust, genesis_doc=gdoc,
            logger=NetLog("joiner", errors).with_(module="statesync-provider"),
            now_fn=lambda: BLOCKEXEC_T0 + 6 * STATESYNC_TOP + 600)
        check(provider.client.device is None, "statesync: the light client is not on the card")
        real_hop = provider.client.verify_light_block_at_height

        def hop(height, now=None):
            mark = (cv.launches, csh.launches, ds.tier_counts()["cuda"])
            t1 = time.perf_counter()
            known = provider.client.store.light_block(height) is not None
            out = real_hop(height, now)
            cuda = ds.tier_counts()["cuda"]
            if not known:
                b, ln = cuda[0] - mark[2][0], cuda[1] - mark[2][1]
                hops.append({"height": height, "ms": round((time.perf_counter() - t1) * 1e3, 3),
                             "ed25519_launches": cv.launches - mark[0],
                             "lanes_per_launch": round(ln / b, 1) if b else None,
                             "tree_launches": csh.launches - mark[1]})
            return out

        provider.client.verify_light_block_at_height = hop
        hnet.start()
        jnet.start([hnet.address])
        wait_until(lambda: len(jnet.switch.peers_list()) == 1, INGEST_TIMEOUT_S,
                   "statesync: J's link to H")
        t_sync = time.perf_counter()
        got = tn.run_statesync(jnet, provider, jconns, jss, jbs, evidence_pool=jpool,
                               discovery_s=STATESYNC_DISCOVERY_S,
                               chunk_timeout_s=StateSyncConfig().chunk_request_timeout_s,
                               logger=NetLog("joiner", errors))
        restore_s = time.perf_counter() - t_sync
        check(got is not None, f"statesync: the restore failed: {errors[-3:]}")
        synced, _ = got
        restored = jconns.query.info().last_block_app_hash
        bs = jnet.reactors["BLOCKSYNC"]
        t1 = time.perf_counter()
        wait_until(lambda: jbs.height() >= SNAPSHOT_INTERVAL + 1 and not bs.syncing,
                   NETWORK_SYNC_TIMEOUT_S, lambda: f"statesync: J's blocksync at "
                   f"{jbs.height()}, counters {bstats.snapshot()}, errors {errors[-3:]}")
        bsync_s = time.perf_counter() - t1
        wall = time.perf_counter() - t_run
        after = jconns.query.info().last_block_app_hash
        j_height = jbs.height()
        jnet.stop()
        hnet.stop()
        launches = net_settled(cv, csh, cuda_aead, cuda_x25519, ds)
        tiers = net_tiers(ds, "statesync part B")
        ts, synced_c = tstats.snapshot(), bstats.snapshot()
    finally:
        ssyncer.Syncer._fetch_chunks = real_fetch
        for n in nets:
            n.stop()
        for c in (jconns, hconns):
            if c is not None:
                c.stop()
        if child is not None:
            open(os.path.join(run_dir, "stop"), "w").close()
            try:
                child[0].wait(10)
            except subprocess.TimeoutExpired:
                child[0].kill()
                child[0].wait()
            child[1].close()
        for db in (hdb, jdb):
            if db is not None:
                db.close()
        pool_ex.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(run_dir, ignore_errors=True)

    # -- what part B asserts -------------------------------------------------
    check(restored == h6.app_hash, "statesync: J's app hash after the restore != header 6's")
    check(after == h7.app_hash and j_height == SNAPSHOT_INTERVAL + 1,
          f"statesync: J at {j_height}, app hash after block 6 != header 7's")
    for what, a, b in (("validators", synced.validators.hash(), at5.validators.hash()),
                       ("next validators", synced.next_validators.hash(),
                        at5.next_validators.hash()),
                       ("params", _params_to_json(synced.consensus_params),
                        _params_to_json(at5.consensus_params)),
                       ("results hash", synced.last_results_hash, at5.last_results_hash),
                       ("app hash", synced.app_hash, at5.app_hash),
                       ("last block id", synced.last_block_id, at5.last_block_id)):
        check(a == b, f"statesync: J's bootstrapped state differs from H's at height 5 in its {what}")
    check(tiers["ed25519"]["cuda"][0] == launches["ed25519"] > 0
          and tiers["tree"]["cuda"][0] == launches["tree"] > 0
          and tiers["aead"]["cuda"][0] == launches["aead"] > 0
          and tiers["ladder"]["cuda"][0] == launches["ladder"] > 0
          and ts["dispatches"]["host"] == 0,
          f"statesync: launches {launches} against tiers {tiers}, transport {ts['dispatches']}")
    check(all(x["ed25519_launches"] > 0 and x["tree_launches"] > 0 for x in hops) and hops,
          f"statesync: light hops {hops}")
    bad = [e for e in errors if any(b in e[2] for b in
                                    ("statesync failed", "load chunk failed") + BLOCKSYNC_ERRORS)]
    check(not bad, f"statesync: logged {bad[:3]}")
    mb = snap_bytes / 1e6
    sm = {k: (round(statistics.median(v), 3), len(v), round(sum(v), 1))
          for k, v in socket_ms.items()}
    re_req = sum(requests.values()) - len(requests)
    print(f"statesync: part B: a fresh joiner J (its app a port KVStoreApplication behind "
          f"abci/server.ABCIServer in a child process at {addr}, up in {app_up_s:.2f} s, "
          f"reached through remote_client_creator: four SocketClients) discovered H's "
          f"snapshot at {SNAPSHOT_INTERVAL} over p2p ({STATESYNC_DISCOVERY_S} s window), "
          f"verified it through a LightClientStateProvider on the card (NodeProvider on H's "
          f"stores, block 1 trusted by hash; light hops {sum(x['ms'] for x in hops):.1f} ms), "
          f"fetched {len(requests)} chunks with {sum(requests.values())} requests "
          f"({re_req} re-requests) in {sum(fetch_s):.2f} s = {mb / sum(fetch_s):.3f} MB/s "
          f"and applied them over the socket; the restore's wall {restore_s:.2f} s (the "
          f"discovery window, the light hops, the fetch, the applies); app hash "
          f"== header {SNAPSHOT_INTERVAL + 1}'s; bootstrapped state == H's at "
          f"{SNAPSHOT_INTERVAL} (validators, next validators, params, results hash); then "
          f"blocksynced block {SNAPSHOT_INTERVAL + 1} in {bsync_s:.2f} s (app hash == header "
          f"{STATESYNC_TOP}'s; counters {synced_c}); wall {wall:.2f} s {tag}", flush=True)
    print(f"statesync: part B: light hops {json.dumps(hops)}; socket ms (median, calls, "
          f"sum) {sm}; launches {launches}, served by tier {tiers}; transport AEAD passes "
          f"{ts['batches']}; no statesync, chunk or blocksync error logged {tag}", flush=True)
    return {"launches": launches, "wall_s": wall, "validators": len(keys), "hops": hops}


def ingest_statesync_phase(torch, dev, cbatch, cv, ds, sigcache, chain, tag) -> dict:
    """Phase 20: transaction ingestion behind a sentry (part A) and a
    fresh node's state sync of phase 17's chain (part B), then the four
    kernels held to their plain versions on the inputs the phase gave
    them.  Returns the launches of both parts per kernel."""
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh

    tn = load_torch_net()
    t_phase = time.perf_counter()
    kept_ed, kept_v = {}, {}  # lanes -> inputs: any path's first; V's first flush
    real_ed = cv.verify_core_cuda
    origins = LaunchOrigins(cv)

    def keep_ed(**t):
        lanes = int(t["s_ok"].shape[0])
        kept_ed.setdefault(lanes, {k: v.clone() for k, v in t.items()})
        if not kept_v and origins.current and "V admission" in origins.current:
            kept_v[lanes] = {k: v.clone() for k, v in t.items()}
        return real_ed(**t)

    out = {}
    try:
        with keeping_inputs(cuda_aead, "aead", lambda a, kw: (
                "seal" if kw["seal"] else "open", a[2].shape[1], a[2].shape[0])) as kept_aead, \
                keeping_inputs(cuda_x25519, "ladder", lambda a, kw: a[0].shape[0]) as kept_ladder, \
                keeping_inputs(csh, "tree_words", lambda a, kw: (
                    int(a[1].shape[0]) - 1,
                    int(a[0].numel()) * a[0].element_size()
                    // max(int(a[1].shape[0]) - 1, 1))) as kept_tree:
            cv.verify_core_cuda = keep_ed
            out["A"] = ingest_part_a(torch, cbatch, cv, ds, sigcache, tag, tn, origins)
            out["B"] = statesync_part_b(torch, cbatch, cv, ds, sigcache, chain, tag, tn)
    finally:
        cv.verify_core_cuda = real_ed

    # -- the kernels against their plain versions, on the phase's inputs ----
    n = out["B"]["validators"]
    valset = [k for k in kept_tree if k[0] == n and k[1] < 128]
    check(valset, f"ingest_statesync: no {n}-leaf set hash reached the tree kernel: "
          f"{sorted(kept_tree)}")
    others = [k for k in sorted(kept_tree) if k[0] != n and k[1] < 1024][-1:]
    # the two smallest and the largest launches, V's first coalescer flush
    # and a light hop's one-launch batch (a 2/3 or 1/3 commit check)
    check(kept_v, "ingest_statesync: no launch of V's admission was kept")
    hop = sorted({int(x["lanes_per_launch"]) for x in out["B"]["hops"]
                  if x["ed25519_launches"] == 1} & set(kept_ed))
    check(hop, f"ingest_statesync: no light hop's batch was kept: {out['B']['hops']}")
    ed_in = {f"{k}": kept_ed[k] for k in sorted(kept_ed)[:2] + sorted(kept_ed)[-1:] + hop[:1]}
    ed_in.update({f"{k} (V's flush)": t for k, t in kept_v.items()})
    worst, ms = kept_against_plain(
        torch, "ingest_statesync", ed_in, sorted(ed_in), kept_tree,
        valset[:1] + others, kept_aead, kept_ladder)
    ed_ms, tree_ms, aead_ms, ladder_ms = ms["ed25519"], ms["tree"], ms["aead"], ms["ladder"]
    print(f"ingest_statesync: on the phase's own inputs, bit for bit: the Ed25519 kernel "
          f"== its plain version at {sorted(ed_ms)} lanes ({ed_ms} ms; every launch's "
          f"lanes {sorted(kept_ed)}), the tree kernel at (leaves, bytes a leaf) "
          f"{sorted(tree_ms)} ({tree_ms} ms), the AEAD kernel on the first flush of each "
          f"(op, lanes, blocks) {sorted(aead_ms)} "
          f"({ {f'{k[0]} {k[1]}x{k[2]}': v for k, v in aead_ms.items()} } ms), the ladder "
          f"kernel at {sorted(ladder_ms)} lanes ({ladder_ms} ms); max_abs_err "
          f"{dict(worst)}; device times by CUDA events, queued {tag}", flush=True)
    per = {"ed25519": statistics.median(ed_ms.values()),
           "tree": statistics.median(tree_ms.values()),
           "aead": statistics.median(aead_ms.values()),
           "ladder": statistics.median(ladder_ms.values())}
    for part in ("A", "B"):
        c, wall = out[part]["launches"], out[part]["wall_s"]
        busy = sum(c[k] * per[k] for k in per) / (wall * 1e3)
        print(f"ingest_statesync: part {part}: the card busy ~{busy:.4%} of its {wall:.2f} s "
              f"(idle ~{1 - busy:.4%}; derived: launches {c} x median device times "
              f"{ {k: round(v, 4) for k, v in per.items()} } ms) {tag}", flush=True)
    print(f"ingest_statesync: the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: out["A"]["launches"][k] + out["B"]["launches"][k]
            for k in ("ed25519", "tree", "aead", "ladder")}


def node_rpc(port: int, method: str, params=None, timeout: float = 30.0):
    """One JSON-RPC POST to a node on 127.0.0.1; raises ``RuntimeError``
    with the error's message if the node answered one."""
    import urllib.request

    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                       "params": params or {}}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        doc = json.loads(resp.read())
    if "error" in doc:
        raise RuntimeError(doc["error"].get("message", str(doc["error"])))
    return doc["result"]


def node_try(port: int, method: str, params=None):
    """``node_rpc``, or None if the node did not answer (not up yet)."""
    try:
        return node_rpc(port, method, params, timeout=5.0)
    except (OSError, RuntimeError, ValueError):
        return None


_PORTS_GIVEN: set = set()


def free_ports(k: int) -> list:
    """``k`` distinct free TCP ports on 127.0.0.1, none given before in this run.

    The ports lie below the kernel's ephemeral range
    (``/proc/sys/net/ipv4/ip_local_port_range``), so no outgoing connection
    takes one as its local port between this call and the server's bind: a
    phase opens thousands of client and peer connections before its last
    server starts, and a port from the ephemeral range may be in use by then.
    """
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    low = max(low, 12000)
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    out: list = []
    for port in rng.sample(range(10000, low), low - 10000):
        if len(out) == k:
            break
        if port in _PORTS_GIVEN:
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        _PORTS_GIVEN.add(port)
        out.append(port)
    if len(out) < k:
        raise SmokeError(f"node: only {len(out)} of {k} free ports below {low}")
    return out


class NodeWs:
    """A websocket client on a node's ``/websocket``: subscribes to a query
    and keeps each event's height and arrival time."""

    def __init__(self, port: int, query: str):
        import base64 as b64
        import socket

        from cometbft_tpu_torch.rpc.server import _ws_recv, _ws_send

        self._recv, self._send = _ws_recv, _ws_send
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        key = b64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /websocket HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n")
                          .encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(1)
            check(chunk, "node: the websocket closed during its upgrade")
            head += chunk
        check(head.startswith(b"HTTP/1.1 101"), f"node: websocket upgrade {head[:60]!r}")
        self.sock.settimeout(None)
        self.heights, self.replies, self.closed = [], [], False
        _ws_send(self.sock, json.dumps({"jsonrpc": "2.0", "id": 7, "method": "subscribe",
                                        "params": {"query": query}}).encode())
        self.thread = threading.Thread(target=self._run, name="node-ws", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            try:
                got = self._recv(self.sock)
            except OSError:
                got = None
            if got is None:
                self.closed = True
                return
            opcode, payload = got
            if opcode != 1:
                continue
            doc = json.loads(payload)
            data = (doc.get("result") or {}).get("data")
            if data and "block" in data.get("value", {}):
                self.heights.append((int(data["value"]["block"]["header"]["height"]),
                                     time.time()))
            else:
                self.replies.append(doc)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        self.thread.join(5)


def node_errors(log_path) -> dict:
    """A node child's "consensus failure" lines from its log, split into
    block parts of another round (PERF.md §7: "bad block part", or an
    ``IndexError`` raised in ``add_part``) and the rest."""
    try:
        text = open(log_path, errors="replace").read()
    except OSError:
        return {"wrong_round": 0, "other": []}
    blocks = text.split("consensus failure")[1:]
    wrong, other = 0, []
    for b in blocks:
        tb = b.split("\nINFO[")[0].split("\nERROR[")[0]
        if "bad block part" in tb.split("\n", 1)[0] or "add_part" in tb:
            wrong += 1
        else:
            other.append(tb[:300])
    return {"wrong_round": wrong, "other": other}


def cli_child(cfg_path: str) -> int:
    """A port process of phase 21: ``cometbft_tpu_torch.cmd.main.main(argv)``
    with the CLI's own arguments (``start``, ``inspect``, ``light``), or the
    remote signer (``SignerServer`` over a validator's key files).  It first
    installs the phase's launch counting and input keeping, as phase 19's
    children do; when it is stopped (SIGTERM) it writes its report: its
    launches and tiers, its kernels against their plain versions on the
    inputs its path gave them, the light proxy's hops, the signer's
    requests and its last-sign state's steps."""
    import collections as co
    import signal

    import torch

    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.light.client import LightClient
    from cometbft_tpu_torch.ops import chacha_aead as ca
    from cometbft_tpu_torch.ops import cuda_aead, cuda_x25519
    from cometbft_tpu_torch.ops import cuda_sha256 as csh
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import dispatch_stats as ds
    from cometbft_tpu_torch.ops import sha256_tree as st
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.ops import x25519_ladder as xl

    cfg = net_read(cfg_path)
    role, on_card = cfg["role"], torch.cuda.is_available()
    if role != "inspect":
        # the kernel's known-answer self-check before the counts start, as
        # phase 19's children count after build_node: the node's own
        # entry_device then finds this process checked (a launch outside
        # the supervisor, which no tier counter sees)
        from cometbft_tpu_torch.crypto import batch as cbatch

        cbatch.default_backend()
    kept_ed, hops, signed, steps = {}, [], co.Counter(), []
    real_ed = cv.verify_core_cuda

    def keep_ed(**t):
        kept_ed.setdefault(int(t["s_ok"].shape[0]), {k: v.clone() for k, v in t.items()})
        return real_ed(**t)

    if role == "light":
        real_hop = LightClient.verify_light_block_at_height

        def hop(self, height, now=None):
            known = self.store.light_block(height) is not None
            mark = (cv.launches, csh.launches, ds.tier_counts()["cuda"], len(kept_ed))
            t0 = time.perf_counter()
            out = real_hop(self, height, now)
            if not known:
                cuda = ds.tier_counts()["cuda"]
                hops.append({"height": height,
                             "ms": round((time.perf_counter() - t0) * 1e3, 3),
                             "ed25519_launches": cv.launches - mark[0],
                             "lanes": cuda[1] - mark[2][1],
                             "tree_launches": csh.launches - mark[1]})
            return out

        LightClient.verify_light_block_at_height = hop
    with contextlib.ExitStack() as stack:
        kept_aead = stack.enter_context(keeping_inputs(cuda_aead, "aead", lambda a, kw: (
            "seal" if kw["seal"] else "open", a[2].shape[1], a[2].shape[0])))
        kept_ladder = stack.enter_context(keeping_inputs(cuda_x25519, "ladder",
                                                         lambda a, kw: a[0].shape[0]))
        kept_tree = stack.enter_context(keeping_inputs(csh, "tree_words", lambda a, kw: (
            int(a[1].shape[0]) - 1,
            int(a[0].numel()) * a[0].element_size() // max(int(a[1].shape[0]) - 1, 1))))
        cv.verify_core_cuda = keep_ed
        ds.reset()
        for w in (cv, csh, cuda_aead, cuda_x25519):
            w.reset_launches()
        t0 = time.perf_counter()
        if role == "signer":
            from cometbft_tpu_torch.privval.file_pv import FilePV
            from cometbft_tpu_torch.privval.signer import SignerServer

            pv = FilePV.load(cfg["key"], cfg["state"])
            for what in ("sign_vote", "sign_proposal"):
                real = getattr(pv, what)

                def counted(*a, _real=real, _what=what, **kw):
                    out = _real(*a, **kw)
                    signed[_what] += 1
                    s = pv._state
                    steps.append((s.height, s.round_, s.step))
                    return out

                setattr(pv, what, counted)
            stop = threading.Event()
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
            srv = SignerServer(cfg["laddr"], pv)
            srv.start()
            stop.wait()
            srv.stop()
            rc = 0
        else:
            rc = cli(cfg["argv"])
        # the node is stopped and its stores closed (a rollback may begin)
        net_write(os.path.join(os.path.dirname(cfg["report"]), f"stopped-{cfg['name']}"),
                  {"rc": rc})
        # what /metrics says at the end: the families over this process's
        # counters, read after its node stopped
        from cometbft_tpu_torch.libs.metrics import NodeMetrics

        metrics_text = NodeMetrics().registry.expose() if role == "node" else ""
        wall = time.perf_counter() - t0
        cv.verify_core_cuda = real_ed
        if on_card:
            launches = net_settled(cv, csh, cuda_aead, cuda_x25519, ds)
        else:
            launches = net_counts(cv, csh, cuda_aead, cuda_x25519)
        tiers = {"ed25519": ds.tier_counts(), "tree": ds.tier_counts(st.MERKLE),
                 "aead": ds.tier_counts(ca.AEAD), "ladder": ds.tier_counts(xl.X25519),
                 "tree_oversize": ds.tier_counts(st.MERKLE_OVERSIZE)}
        # the kernels against their plain versions on this process's inputs:
        # the smallest and the two largest Ed25519 launches, the two largest
        # trees, every AEAD shape, every ladder flush
        worst, dev_ms = co.Counter(), {}
        eds = sorted(kept_ed)
        for lanes in sorted(set(eds[:1] + eds[-2:])):
            t = kept_ed[lanes]
            kern, plain = cv.verify_core_cuda(**t), ov.verify_core(**t)
            worst["ed25519"] = max(worst["ed25519"], int((kern.int() - plain.int()).abs().max()))
            check(torch.equal(kern, plain), f"node: {cfg['name']}: Ed25519 kernel != plain at "
                  f"{lanes} lanes")
            dev_ms.setdefault("ed25519", {})[lanes] = cuda_ms(
                torch, lambda: cv.verify_core_cuda(**t), 5, 1, queued=True)
        for key, (args, _) in sorted(kept_tree.items())[-2:]:
            kern, plain = csh.tree_words(*args), st.tree_words_plain(*args)
            worst["tree"] = max(worst["tree"], int((kern.long() - plain.long()).abs().max()))
            check(torch.equal(kern, plain), f"node: {cfg['name']}: tree kernel != plain at "
                  f"(leaves, bytes a leaf) {key}")
            dev_ms.setdefault("tree", {})[str(key)] = cuda_ms(
                torch, lambda: csh.tree_words(*args), 5, 1, queued=True)
        for key, (args, kw) in sorted(kept_aead.items()):
            got, want = cuda_aead.aead(*args, **kw), ca.aead_core(*args, **kw)
            torch.cuda.synchronize()
            worst["aead"] = max(worst["aead"], *(int((g.long() - w.long()).abs().max())
                                                 for g, w in zip(got, want)))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"node: {cfg['name']}: AEAD kernel != plain on a flush {key}")
            dev_ms.setdefault("aead", {})[str(key)] = cuda_ms(
                torch, lambda: cuda_aead.aead(*args, **kw), 5, 1, queued=True)
        for lanes, (args, _) in sorted(kept_ladder.items()):
            got, want = cuda_x25519.ladder(*args), xl.ladder_plain(*args)
            torch.cuda.synchronize()
            worst["ladder"] = max(worst["ladder"], int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"node: {cfg['name']}: ladder kernel != plain at "
                  f"{lanes} lanes")
            dev_ms.setdefault("ladder", {})[lanes] = cuda_ms(
                torch, lambda: cuda_x25519.ladder(*args), 5, 1, queued=True)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cometbft_tpu")]
    net_write(cfg["report"], {
        "name": cfg["name"], "rc": rc, "wall_s": wall, "launches": launches, "tiers": tiers,
        "kept": {"ed25519": eds, "tree": sorted(list(k) for k in kept_tree),
                 "aead": sorted(list(k) for k in kept_aead), "ladder": sorted(kept_ladder)},
        "max_abs_err": dict(worst), "device_ms": dev_ms, "hops": hops,
        "signed": dict(signed), "steps": steps, "leaked": leaked,
        "metrics": metrics_text})
    return 0


def node_spawn(root, procs, name: str, role: str, env=None, **cfg) -> None:
    """Start one child of phase 21 (``--cli-child``) with its log and report
    under ``root``; ``env`` adds to its environment."""
    script = os.path.abspath(__file__)
    path = root / f"cfg-{name}.json"
    net_write(path, {"name": name, "role": role, "report": str(root / f"report-{name}.json"),
                     **cfg})
    log = open(root / f"{name}.log", "w")
    procs.append((name, subprocess.Popen(
        [sys.executable, script, "--cli-child", str(path)], cwd=os.path.dirname(script),
        env=dict(os.environ, COMETBFT_TPU_WARMBOOT="0", **(env or {})), stdout=log,
        stderr=subprocess.STDOUT), log))


def node_stop(root, procs, names, timeout_s: float = 240.0, until: str = "report") -> dict:
    """SIGTERM the children ``names`` and read their reports (each checks its
    kernels against their plain versions after its stop).  With ``until``
    "stopped", return once each has stopped its node (``stopped-<name>``)
    and read no report: it comes with a later call."""
    import signal

    live = [(n, p) for n, p, _ in procs if n in names and p.poll() is None]
    for _, p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.perf_counter() + timeout_s
    if until == "stopped":
        for n, p in live:
            while not (root / f"stopped-{n}").exists():
                check(p.poll() is None or (root / f"report-{n}.json").exists()
                      or (root / f"stopped-{n}").exists(),
                      f"node: {n} exited (rc {p.returncode}) without stopping its node")
                check(time.perf_counter() < deadline, f"node: {n} did not stop")
                time.sleep(0.05)
        return {}
    for n, p in live:
        try:
            p.wait(max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    out = {}
    for n in names:
        rep = net_read(root / f"report-{n}.json")
        check(rep is not None, f"node: {n} wrote no report: "
              + (root / f"{n}.log").read_text()[-3000:])
        out[n] = rep
    return out


def prom(text: str) -> dict:
    """Prometheus text (``libs/metrics``' exposition) as {series: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def prom_tiers(values: dict) -> dict:
    """Ed25519 dispatches by tier, from the dispatch-time histogram's
    counts by shape (``<tier>-<lanes>``)."""
    out = collections.Counter()
    for series, v in values.items():
        m = re.fullmatch(r'cometbft_crypto_dispatch_seconds_count\{shape="(\w+)-\d+"\}', series)
        if m:
            out[m.group(1)] += int(v)
    return dict(out)


class NodeWatch:
    """Phase 21's observation of one validator through its surfaces: its
    ``/metrics`` (``instrumentation.prometheus``) scraped at boot, during the
    tx burst and after it, its ``debug_verify_trace``, its
    ``/debug/pprof/goroutine`` and ``cmd trace`` of it while it runs; at the
    end its ``/metrics`` families against its own launch counts."""

    def __init__(self, name: str, rpc_port: int, metrics_port: int, pprof_port: int, tag):
        self.name, self.rpc, self.tag = name, rpc_port, tag
        self.metrics_url = f"http://127.0.0.1:{metrics_port}/metrics"
        self.pprof_url = f"http://127.0.0.1:{pprof_port}/debug/pprof/goroutine"
        self.scrapes: list = []  # (seconds since the first, ms, values)
        self._stop = threading.Event()
        self._thread = None

    def scrape(self) -> dict:
        import urllib.request

        t0 = time.perf_counter()
        with urllib.request.urlopen(self.metrics_url, timeout=30) as resp:
            text = resp.read().decode()
        ms = (time.perf_counter() - t0) * 1e3
        values = prom(text)
        tiers = prom_tiers(values)
        check(values.get("cometbft_device_up") == -1.0,
              f"node: {self.name}: cometbft_device_up {values.get('cometbft_device_up')} "
              "with no status file (the JAX gauge reads -1)")
        check(set(tiers) <= {"cuda"} and values["cometbft_crypto_backend_fallback_verifies"]
              == 0, f"node: {self.name}: Ed25519 dispatches by tier {tiers} on /metrics")
        self.scrapes.append((time.perf_counter(), ms, values, len(text)))
        return values

    def boot(self) -> None:
        """At height 2: /metrics, the trace document, the pprof route."""
        import urllib.request

        values = self.scrape()
        doc = node_rpc(self.rpc, "debug_verify_trace", {"spans": NODE_TRACE_RING})
        spans = doc["spans"]
        stages = collections.Counter(sp["stage"] for sp in spans)
        tiers = collections.Counter(sp["attrs"].get("tier") for sp in spans
                                    if sp["stage"] == "verify.dispatch")
        for stage in ("verify.dispatch", "sched.flush", "aead.flush", "x25519.ladder"):
            check(stages[stage] > 0, f"node: {self.name}'s trace has no {stage} span: {stages}")
        check(set(tiers) == {"cuda"}, f"node: {self.name}'s verify.dispatch tiers {tiers}")
        t0 = time.perf_counter()
        with urllib.request.urlopen(self.pprof_url, timeout=30) as resp:
            dump = resp.read().decode()
        pprof_ms = (time.perf_counter() - t0) * 1e3
        check("MainThread" in dump, f"node: {self.name}'s goroutine dump: {dump[:200]}")
        threads = dump.count("\n--- ")
        print(f"node: part A: {self.name} (instrumentation.prometheus, rpc.pprof_laddr) at "
              f"height 2: /metrics {self.scrapes[-1][3]} bytes in {self.scrapes[-1][1]:.3f} ms "
              f"(Ed25519 dispatches by tier {prom_tiers(values)}, cometbft_device_up -1); "
              f"debug_verify_trace: {len(spans)} spans, by stage {dict(stages)}, "
              f"verify.dispatch tiers {dict(tiers)}; /debug/pprof/goroutine "
              f"{threads} threads in {pprof_ms:.3f} ms {self.tag}", flush=True)

    def start_scraping(self) -> None:
        def run():
            while not self._stop.wait(1.0):
                self.scrape()

        self._thread = threading.Thread(target=run, name="scrape", daemon=True)
        self._thread.start()

    def stop_scraping(self) -> None:
        self._stop.set()
        self._thread.join(60)
        check(not self._thread.is_alive(), "node: the /metrics scraper hung")
        self.scrape()  # after the burst
        series = [prom_tiers(v).get("cuda", 0) for _, _, v, _ in self.scrapes]
        check(series == sorted(series) and series[-1] > series[0],
              f"node: {self.name}'s cuda dispatches over the scrapes {series}")
        ms = [m for _, m, _, _ in self.scrapes]
        print(f"node: part A: {self.name}'s /metrics scraped {len(ms)} times (every 1 s "
              f"during the tx burst, and after it): cuda dispatches {series}; scrape ms "
              f"median {statistics.median(ms):.3f}, max {max(ms):.3f} {self.tag}", flush=True)

    def trace_cli(self) -> None:
        """``cmd trace`` of the live node, as an operator runs it."""
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "cometbft_tpu_torch.cmd", "trace", "--rpc",
             f"tcp://127.0.0.1:{self.rpc}"], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=120)
        check(out.returncode == 0 and "flight recorder: on" in out.stdout,
              f"node: cmd trace of {self.name}: rc {out.returncode} {out.stderr[-2000:]}")
        print(f"node: part A: cmd trace --rpc of {self.name} ({time.perf_counter() - t0:.2f} "
              f"s):", flush=True)
        for line in out.stdout.splitlines():
            print(f"node:   {line}", flush=True)

    def check_report(self, rep: dict) -> None:
        """/metrics at the end, against the process's own launch counts."""
        values = prom(rep["metrics"])
        tiers = prom_tiers(values)
        launches = rep["launches"]["ed25519"]
        check(tiers == {"cuda": launches} and rep["tiers"]["ed25519"]["cuda"][0] == launches
              and values["cometbft_crypto_verify_dispatches"] == launches
              and values["cometbft_crypto_backend_fallback_verifies"] == 0,
              f"node: {self.name}: /metrics dispatches by tier {tiers}, verify_dispatches "
              f"{values['cometbft_crypto_verify_dispatches']}, its launches {launches}")
        print(f"node: part A: {self.name}'s /metrics at its stop: Ed25519 dispatches by tier "
              f"{tiers} == its {launches} kernel launches (torch and host 0), "
              f"cometbft_crypto_verify_dispatches {int(values['cometbft_crypto_verify_dispatches'])}, "
              f"cometbft_device_up {values['cometbft_device_up']:.0f} {self.tag}", flush=True)


def postmortem_of_a_killed_node(root, procs, home, rpc_port: int, tag) -> None:
    """SIGKILL the validator process ``NODE_KILLED`` (its peers stopped, it
    waits in a round it cannot commit) and read its home with ``cmd
    postmortem``: an unclean shutdown, the height its store holds as the last
    committed one, and the round anchor that was open."""
    import signal

    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV

    (p,) = [p for n, p, _ in procs if n == NODE_KILLED]
    check(p.poll() is None, f"node: {NODE_KILLED} exited before its kill")
    st = node_rpc(rpc_port, "status")
    h = int(st["sync_info"]["latest_block_height"])
    time.sleep(3.0)  # past timeout_commit: the next height's round anchor is open
    check(int(node_rpc(rpc_port, "status")["sync_info"]["latest_block_height"]) == h,
          f"node: {NODE_KILLED} committed alone")
    p.send_signal(signal.SIGKILL)
    p.wait(60)
    db = SqliteKV(os.path.join(str(home), "data", "chain.db"), surface="state")
    stored = BlockStore(db).height()
    db.close()
    t0 = time.perf_counter()
    runs = [subprocess.run([sys.executable, "-m", "cometbft_tpu_torch.cmd", "postmortem",
                            str(home), *extra], cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=120)
            for extra in (["--json"], [])]
    pm_s = time.perf_counter() - t0
    check(all(r.returncode == 0 for r in runs), f"node: cmd postmortem: "
          f"{[r.stderr[-1000:] for r in runs]}")
    report = json.loads(runs[0].stdout)
    inf = report["in_flight"] or {}
    check(report["unclean_shutdown"] and not report["clean_close"]
          and report["last_committed_height"] == stored == h
          and inf.get("h") == stored + 1,
          f"node: the postmortem of {NODE_KILLED}: unclean {report['unclean_shutdown']}, last "
          f"committed {report['last_committed_height']}, its store at {stored}, RPC at {h}, "
          f"in flight {inf}")
    print(f"node: part A: {NODE_KILLED} SIGKILLed waiting alone at height {h + 1}; cmd "
          f"postmortem of its home ({pm_s:.2f} s for both runs): unclean shutdown, last "
          f"committed height {report['last_committed_height']} == its store's {stored}, the "
          f"in-flight consensus.round anchor {json.dumps(inf, sort_keys=True)}, journal "
          f"{json.dumps(report['journal'], sort_keys=True)} {tag}", flush=True)
    for line in runs[1].stdout.splitlines():
        print(f"node:   {line}", flush=True)


def node_part_a(tag, root, procs, after_reads=None) -> dict:
    """Part A of phase 21: CometBFT's ``make localnet-start`` through the
    port's CLI: ``cmd testnet --v 4``, four ``cmd start`` processes with the
    default config (validator 3's key behind a remote signer), JSON-RPC
    traffic and reads, a rollback and a statesync joiner from ``cmd init``.
    ``after_reads`` is called once the reads are done (phase 21 starts part
    B's processes there, to boot while part A's rollback and joiner run).
    Returns {"launches": {...}, "wall_s": s}."""
    import base64 as b64
    import concurrent.futures

    import numpy as np

    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.config import config as cfgmod
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.node.nodekey import NodeKey

    t_run = time.perf_counter()
    net = root / "net"
    check(cli(["--home", str(root / "unused"), "testnet", "--v", str(NODE_VALIDATORS),
               "--o", str(net), "--chain-id", NODE_CHAIN]) == 0, "node: cmd testnet failed")
    names = [f"node{i}" for i in range(NODE_VALIDATORS)]
    homes = {n: net / n for n in names}
    ports = free_ports(2 * NODE_VALIDATORS + 5)
    rpc = {n: ports[2 * i] for i, n in enumerate(names)}
    p2p = {n: ports[2 * i + 1] for i, n in enumerate(names)}
    signer_port, rpc["joiner"], p2p["joiner"], metrics_port, pprof_port = ports[-5:]
    watched = names[NODE_WATCHED]
    ids = {n: NodeKey.load_or_generate(str(homes[n] / "config" / "node_key.json")).node_id
           for n in names}
    peers = {n: f"{ids[n]}@127.0.0.1:{p2p[n]}" for n in names}
    signer_name = names[NODE_SIGNED]
    for n in names:
        cfg = cfgmod.load_config(str(homes[n]))
        cfg.base.home = str(homes[n])
        cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc[n]}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p[n]}"
        cfg.p2p.persistent_peers = [peers[m] for m in names if m != n]
        if n == signer_name:
            cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{signer_port}"
        if n == watched:
            cfg.instrumentation.prometheus = True
            cfg.instrumentation.prometheus_listen_addr = f"tcp://127.0.0.1:{metrics_port}"
            cfg.rpc.pprof_laddr = f"tcp://127.0.0.1:{pprof_port}"
        cfgmod.write_config(cfg)
    defaults = cfgmod.default_config()

    def start(n: str, name: str = "") -> None:
        env = {"COMETBFT_TPU_TRACE_RING": str(NODE_TRACE_RING)} if n == watched else None
        node_spawn(root, procs, name or n, "node", env=env,
                   argv=["--home", str(homes[n]), "start"])

    def alive(what: str) -> None:
        for name, p, _ in procs:
            if p.poll() is not None and not (root / f"report-{name}.json").exists():
                raise SmokeError(f"node: {name} exited (rc {p.returncode}) before {what}: "
                                 + (root / f"{name}.log").read_text()[-3000:])

    def height(n: str) -> int:
        st = node_try(rpc[n], "status")
        return int(st["sync_info"]["latest_block_height"]) if st else -1

    def wait(cond, what: str, timeout_s: float = NODE_TIMEOUT_S) -> float:
        t0 = time.perf_counter()
        while not cond():
            alive(what)
            check(time.perf_counter() - t0 < timeout_s, f"node: {what} not reached in "
                  f"{timeout_s} s: heights {[height(n) for n in rpc]}")
            time.sleep(0.1)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    for n in names:
        start(n)
        if n == signer_name:
            # right after its validator: the node's build waits for the
            # signer to dial in (SignerListenerEndpoint.wait_for_connection)
            node_spawn(root, procs, "signer", "signer",
                       laddr=f"tcp://127.0.0.1:{signer_port}",
                       key=str(homes[n] / defaults.base.priv_validator_key_file),
                       state=str(homes[n] / defaults.base.priv_validator_state_file))
    boot_s = wait(lambda: all(height(n) >= 2 for n in names), "height 2 on all four")
    print(f"node: part A: cmd testnet --v {NODE_VALIDATORS}, four cmd start processes (node "
          f"{NODE_SIGNED} behind a SignerServer child) at height 2 in {boot_s:.2f} s "
          f"(imports, the kernel's self-check, the handshakes) {tag}", flush=True)
    ws = NodeWs(rpc["node1"], "tm.event='NewBlock'")
    ws_from = height("node1")
    watch = NodeWatch(watched, rpc[watched], metrics_port, pprof_port, tag)
    watch.boot()

    # -- traffic: 5,000 txs by broadcast_tx_sync, then 20 by _commit -------
    rng = np.random.default_rng(NODE_SEED)
    hexed = rng.bytes(NODE_TXS * NODE_TX_BYTES // 2).hex().encode()
    txs = []
    for k in range(NODE_TXS + NODE_COMMIT_TXS):
        head = b"n21-%05d=" % k
        o = (k % NODE_TXS) * NODE_TX_BYTES
        txs.append(head + hexed[o : o + NODE_TX_BYTES - len(head)])
    check(len(set(txs)) == len(txs) and all(len(t) == NODE_TX_BYTES for t in txs),
          "node: the txs are not distinct 256-byte txs")
    full = collections.Counter()

    def send(k: int) -> None:
        port = rpc[names[k % NODE_VALIDATORS]]
        tx = b64.b64encode(txs[k]).decode()
        for _ in range(600):
            try:
                res = node_rpc(port, "broadcast_tx_sync", {"tx": tx})
            except RuntimeError as e:
                check("full" in str(e), f"node: broadcast_tx_sync of tx {k}: {e}")
                full[k] += 1
                time.sleep(0.1)
                continue
            check(res["code"] == 0, f"node: broadcast_tx_sync of tx {k}: {res}")
            return
        raise SmokeError(f"node: tx {k} never admitted")

    t0 = time.perf_counter()
    watch.start_scraping()
    with concurrent.futures.ThreadPoolExecutor(NODE_CLIENTS) as ex:
        list(ex.map(send, range(NODE_TXS)))
    admit_s = time.perf_counter() - t0
    wait(lambda: all(int((node_try(rpc[n], "num_unconfirmed_txs") or {"n_txs": 1})["n_txs"])
                     == 0 for n in names), "every tx committed")
    drain_s = time.perf_counter() - t0
    watch.stop_scraping()
    commit_ms = {}

    def send_commit(k: int) -> None:
        port = rpc[names[k % NODE_VALIDATORS]]
        t1 = time.perf_counter()
        res = node_rpc(port, "broadcast_tx_commit", {"tx": b64.b64encode(txs[k]).decode()},
                       timeout=60.0)
        commit_ms[k] = (time.perf_counter() - t1) * 1e3
        check(res["check_tx"]["code"] == 0 and res["tx_result"]["code"] == 0,
              f"node: broadcast_tx_commit of tx {k}: {res}")

    with concurrent.futures.ThreadPoolExecutor(NODE_CLIENTS) as ex:
        list(ex.map(send_commit, range(NODE_TXS, NODE_TXS + NODE_COMMIT_TXS)))
    top = min(height(n) for n in names)

    # -- reads -----------------------------------------------------------------
    metas = {}
    for lo in range(1, top + 1, 20):
        got = node_rpc(rpc["node0"], "blockchain", {"min_height": lo,
                                                     "max_height": min(top, lo + 19)})
        for m in got["block_metas"]:
            metas[int(m["header"]["height"])] = m
    check(sorted(metas) == list(range(1, top + 1)), f"node: blockchain gave {sorted(metas)}")
    with_txs = [h for h in range(1, top + 1) if int(metas[h]["num_txs"])]
    check(sum(int(metas[h]["num_txs"]) for h in with_txs) == len(txs),
          f"node: {sum(int(metas[h]['num_txs']) for h in with_txs)} txs in blocks 1-{top}, "
          f"sent {len(txs)}")
    sent = {hashlib.sha256(t).hexdigest().upper(): t for t in txs}
    search_ms = []

    def indexed(n: str) -> tuple:
        """Node n's block hashes at 1..top and its tx index, height by
        height through tx_search."""
        hashes = {}
        for lo in range(1, top + 1, 20):
            got = node_rpc(rpc[n], "blockchain", {"min_height": lo,
                                                   "max_height": min(top, lo + 19)})
            hashes.update({int(m["header"]["height"]): m["block_id"]["hash"]
                           for m in got["block_metas"]})
        seen = collections.Counter()
        for h in with_txs:
            page = 1
            while True:
                t1 = time.perf_counter()
                got = node_rpc(rpc[n], "tx_search", {"query": f"tx.height={h}",
                                                      "page": page, "per_page": 100})
                search_ms.append((time.perf_counter() - t1) * 1e3)
                seen.update(x["hash"] for x in got["txs"])
                check(all(int(x["height"]) == h for x in got["txs"]),
                      f"node: {n}: tx_search tx.height={h} gave another height")
                if page * 100 >= int(got["total_count"]):
                    break
                page += 1
        return hashes, seen

    def caught_up(n: str) -> bool:
        """Node n's indexer service has indexed every block to ``top`` and
        every tx of them (it indexes behind consensus, off the event bus)."""
        got = node_try(rpc[n], "block_search", {"query": f"block.height<={top}",
                                                 "per_page": 1})
        if got is None or int(got["total_count"]) != top:
            return False
        for h in with_txs:
            got = node_try(rpc[n], "tx_search", {"query": f"tx.height={h}", "per_page": 1})
            if got is None or int(got["total_count"]) != int(metas[h]["num_txs"]):
                return False
        return True

    t1 = time.perf_counter()
    for n in names:
        wait(lambda: caught_up(n), f"{n}'s index at height {top}")
    index_lag_s = time.perf_counter() - t1
    # the index walk (tx_search page by page on every node) runs on while
    # node 2 is rolled back and the joiner syncs: node 2's after its restart
    pool = concurrent.futures.ThreadPoolExecutor(NODE_VALIDATORS)
    idx = {n: pool.submit(indexed, n) for n in names if n != "node2"}
    for n in names:
        st = node_rpc(rpc[n], "status")
        blk = node_rpc(rpc[n], "block", {"height": top})
        cm = node_rpc(rpc[n], "commit", {"height": top})
        vals = node_rpc(rpc[n], "validators", {"height": top})
        br = node_rpc(rpc[n], "block_results", {"height": with_txs[-1]})
        check(int(st["sync_info"]["latest_block_height"]) >= top
              and blk["block_id"]["hash"] == metas[top]["block_id"]["hash"]
              and cm["signed_header"]["commit"]["block_id"]["hash"]
              == metas[top]["block_id"]["hash"]
              and vals["total"] == str(NODE_VALIDATORS)
              and len(br["txs_results"]) == int(metas[with_txs[-1]]["num_txs"]),
              f"node: {n}'s status, block, commit, validators or block_results at {top}")
    pick = np.random.default_rng(NODE_SEED + 1).choice(len(txs), NODE_PROVE, replace=False)
    headers, prove_ms = {}, []
    for j, k in enumerate(pick.tolist()):
        n = names[j % NODE_VALIDATORS]
        tx_hash = hashlib.sha256(txs[k]).hexdigest().upper()
        t1 = time.perf_counter()
        got = node_rpc(rpc[n], "tx", {"hash": tx_hash, "prove": True})
        prove_ms.append((time.perf_counter() - t1) * 1e3)
        h = int(got["height"])
        if h not in headers:
            headers[h] = node_rpc(rpc[n], "block", {"height": h})["block"]["header"]
        pj = got["proof"]
        proof = merkle.Proof(total=int(pj["proof"]["total"]), index=int(pj["proof"]["index"]),
                             leaf_hash=b64.b64decode(pj["proof"]["leaf_hash"]),
                             aunts=[b64.b64decode(a) for a in pj["proof"]["aunts"]])
        check(pj["root_hash"] == headers[h]["data_hash"]
              and proof.verify(bytes.fromhex(pj["root_hash"]), txs[k])
              and int(pj["proof"]["total"]) == int(metas[h]["num_txs"]),
              f"node: the proof of tx {k} at height {h} did not verify")
    for j, k in enumerate(pick.tolist()):
        key, _, value = txs[k].partition(b"=")
        q = node_rpc(rpc[names[j % NODE_VALIDATORS]], "abci_query",
                     {"path": "/store", "data": key.hex()})
        check(b64.b64decode(q["response"]["value"]) == value,
              f"node: abci_query of tx {k}'s key")
    print(f"node: part A: {NODE_TXS} txs of {NODE_TX_BYTES} bytes (seed {NODE_SEED}) by "
          f"broadcast_tx_sync from {NODE_CLIENTS} client threads over the four nodes in "
          f"{admit_s:.2f} s = {NODE_TXS / admit_s:.1f} txs/s admitted ({sum(full.values())} "
          f"retries on a full mempool), all committed {drain_s:.2f} s after the first; "
          f"{NODE_COMMIT_TXS} by broadcast_tx_commit: p50, p99 "
          f"{np.percentile(list(commit_ms.values()), [50, 99]).round(3).tolist()} ms {tag}",
          flush=True)
    print(f"node: part A: txs in blocks {[(h, int(metas[h]['num_txs'])) for h in with_txs]}; "
          f"every node's index (block_search, tx_search by height) caught up to {top} "
          f"{index_lag_s:.2f} s after the reads began; status, block, commit, validators and "
          f"block_results at {top} on each node; {NODE_PROVE} tx?prove=true verified on the "
          f"host against the blocks' "
          f"data hashes (p50, p99 {np.percentile(prove_ms, [50, 99]).round(3).tolist()} ms); "
          f"{NODE_PROVE} abci_query of written keys returned their values {tag}", flush=True)

    watch.trace_cli()
    if after_reads is not None:
        after_reads()

    # -- rollback: node 2 stopped, rolled back one height, restarted ---------
    h_stop = height("node2")
    node_stop(root, procs, ["node2"], until="stopped")  # its report comes at the end
    before = cfgmod.load_config(str(homes["node2"]))
    t0 = time.perf_counter()
    check(cli(["--home", str(homes["node2"]), "rollback"]) == 0, "node: cmd rollback failed")
    rollback_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    start("node2", "node2-restart")
    goal = max(height(n) for n in names if n != "node2")
    catch_s = wait(lambda: height("node2") >= goal, f"node2 back at {goal} after its rollback")
    check(before.base.priv_validator_laddr == "", "node: node2's config changed")
    idx["node2"] = pool.submit(indexed, "node2")
    print(f"node: part A: node2 stopped at {h_stop}, cmd rollback took {rollback_s:.3f} s, "
          f"restarted (handshake replay of the rolled-back height) and reached {goal} in "
          f"{catch_s:.2f} s {tag}", flush=True)

    # -- the statesync joiner ------------------------------------------------
    jhome = root / "joiner"
    check(cli(["--home", str(jhome), "init", "--chain-id", NODE_CHAIN]) == 0,
          "node: cmd init failed")
    shutil.copy(homes["node0"] / "config" / "genesis.json", jhome / "config" / "genesis.json")
    trust_h = max(1, height("node0") - 2 * 5 + 1)
    trust = node_rpc(rpc["node0"], "block", {"height": trust_h})["block_id"]["hash"]
    cfg = cfgmod.load_config(str(jhome))
    cfg.base.home = str(jhome)
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc['joiner']}"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p['joiner']}"
    cfg.p2p.persistent_peers = [peers[n] for n in names]
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = [f"tcp://127.0.0.1:{rpc['node0']}",
                                 f"tcp://127.0.0.1:{rpc['node1']}"]
    cfg.statesync.trust_height, cfg.statesync.trust_hash = trust_h, trust
    cfg.statesync.discovery_time_s = NODE_DISCOVERY_S
    cfgmod.write_config(cfg)
    t0 = time.perf_counter()
    node_spawn(root, procs, "joiner", "node", argv=["--home", str(jhome), "start"])
    join_s = wait(lambda: height("joiner") >= height("node0") > 0, "the joiner at the frontier")
    synced_at = height("joiner")
    follow_s = wait(lambda: height("joiner") >= synced_at + NODE_FOLLOW,
                    f"the joiner following {NODE_FOLLOW} heights")
    jst = node_rpc(rpc["joiner"], "status")["sync_info"]
    earliest = int(jst["earliest_block_height"])
    check(earliest > 1, f"node: the joiner holds block {earliest}: it did not statesync")
    jh = node_rpc(rpc["joiner"], "blockchain", {"min_height": synced_at,
                                                 "max_height": synced_at})["block_metas"][0]
    oh = node_rpc(rpc["node0"], "blockchain", {"min_height": synced_at,
                                                "max_height": synced_at})["block_metas"][0]
    check(jh["block_id"]["hash"] == oh["block_id"]["hash"], "node: the joiner's block differs")
    print(f"node: part A: a fifth home from cmd init with the localnet's genesis, statesync "
          f"on (rpc_servers node0 and node1, trust height {trust_h} from node0, discovery "
          f"{NODE_DISCOVERY_S} s, cut from 15), restored a snapshot (its earliest block "
          f"{earliest}), blocksynced and reached the frontier at {synced_at} in {join_s:.2f} "
          f"s, then followed {NODE_FOLLOW} heights in {follow_s:.2f} s {tag}", flush=True)

    t_idx = time.perf_counter()
    idx = {n: f.result() for n, f in idx.items()}
    pool.shutdown()
    idx_wait_s = time.perf_counter() - t_idx
    for n in names:
        hashes, seen = idx[n]
        check(hashes == idx["node0"][0], f"node: {n}'s block hashes differ from node0's")
        check(set(seen) == set(sent) and max(seen.values()) == 1,
              f"node: {n} indexed {len(seen)} txs ({sum(seen.values())} rows), sent {len(sent)}")
    print(f"node: part A: blocks 1-{top} equal on the four nodes; each node indexed the "
          f"{len(sent)} txs once (tx_search by height, {len(search_ms)} pages of 100: median "
          f"{np.percentile(search_ms, 50):.3f} ms, p99 {np.percentile(search_ms, 99):.3f} ms; "
          f"walked during the rollback and the joiner's sync, {idx_wait_s:.2f} s waited after "
          f"them) {tag}",
          flush=True)

    # -- stop, reports, assertions ---------------------------------------------
    end_h = height("node1")
    time.sleep(1.5)
    ws.close()
    everyone = names + ["signer", "joiner"]
    t_stop = time.perf_counter()
    reports = node_stop(root, procs, everyone)
    stop_s = time.perf_counter() - t_stop
    # the last validator left (2 of 4, after its restart) cannot commit
    # alone: its round anchors open and flush while it waits; SIGKILL it
    postmortem_of_a_killed_node(root, procs, homes["node2"], rpc["node2"], tag)
    watch.check_report(reports[watched])
    wall = time.perf_counter() - t_run
    ws_h = sorted({h for h, _ in ws.heights})
    check(ws_h and ws_h[0] <= ws_from + 1 and ws_h == list(range(ws_h[0], ws_h[-1] + 1))
          and ws_h[-1] >= end_h, f"node: the websocket saw heights {ws_h[:5]}..{ws_h[-5:]} "
          f"(subscribed at {ws_from}, node1 at {end_h})")
    sg = reports["signer"]
    steps = [tuple(s) for s in sg["steps"]]
    check(sg["signed"].get("sign_vote", 0) >= top and steps == sorted(steps),
          f"node: the signer signed {sg['signed']}, its last-sign state "
          f"{'steps back' if steps != sorted(steps) else 'ok'}")
    errs = {n: node_errors(root / f"{n}.log") for n in reports}
    check(not any(e["other"] for e in errs.values()),
          "node: consensus failures "
          f"{[(n, e['other'][:1]) for n, e in errs.items() if e['other']]}")
    launches = collections.Counter()
    for n, rep in reports.items():
        check(rep["rc"] == 0 and not rep["leaked"], f"node: {n}: rc {rep['rc']}, leaked "
              f"{rep['leaked']}")
        for k in ("ed25519", "tree", "aead", "ladder"):
            launches[k] += rep["launches"][k]
            c = rep["tiers"][k]
            host_ok = rep["tiers"]["tree_oversize"]["host"] if k == "tree" else [0, 0]
            check(c["torch"] == [0, 0] and c["host"] == host_ok
                  and c["cuda"][0] == rep["launches"][k],
                  f"node: {n}: {k} passes {c} against {rep['launches'][k]} launches")
    for k in ("ed25519", "tree", "aead", "ladder"):
        check(launches[k] > 0, f"node: no {k} launch in part A")
    worst = collections.Counter()
    for rep in reports.values():
        for k, v in rep["max_abs_err"].items():
            worst[k] = max(worst[k], v)
    print(f"node: part A: the websocket on node1 saw every height {ws_h[0]}-{ws_h[-1]}; the "
          f"signer signed {sg['signed']} for validator {NODE_SIGNED}, its last-sign state "
          f"never stepping back; consensus failures only of block parts of another round "
          f"({ {n: e['wrong_round'] for n, e in errs.items()} }); launches by process "
          f"{ {n: r['launches'] for n, r in reports.items()} }, every pass on cuda; each "
          f"process's kernels == their plain versions on its own inputs (max_abs_err "
          f"{dict(worst)}); wall {wall:.1f} s {tag}", flush=True)
    def shapes(r) -> dict:
        k = r["kept"]
        return {"ed25519 lanes": k["ed25519"],
                "tree leaves": sorted({t[0] for t in k["tree"]}),
                "aead (op, lanes, blocks)": len(k["aead"]), "ladder lanes": k["ladder"]}

    def med(r) -> dict:
        return {k: round(statistics.median(v.values()), 5) for k, v in r["device_ms"].items()}

    per = collections.defaultdict(list)
    for r in reports.values():
        for k, v in med(r).items():
            per[k].append(v)
    busy = sum(launches[k] * statistics.median(per[k]) for k in per) / (wall * 1e3)
    print(f"node: part A: the card busy ~{busy:.4%} of part A's {wall:.1f} s (derived: "
          f"launches {dict(launches)} x median device ms "
          f"{ {k: round(statistics.median(v), 5) for k, v in per.items()} }) {tag}", flush=True)
    print("node: part A: launch shapes by process "
          f"{json.dumps({n: shapes(r) for n, r in reports.items()})}; "
          f"median device ms by kernel (CUDA events, queued) "
          f"{json.dumps({n: med(r) for n, r in reports.items()})}; the children's stop and "
          f"kernel checks {stop_s:.1f} s {tag}", flush=True)
    secs = sorted(t for _, t in ws.heights)
    gaps = [b - a for a, b in zip(secs, secs[1:])]
    print(f"node: part A: block time (the websocket's NewBlock arrivals) median "
          f"{np.percentile(gaps, 50):.3f} s, p99 {np.percentile(gaps, 99):.3f} s over "
          f"{len(gaps)} blocks; the "
          f"rollback {rollback_s:.3f} s and its catch-up {catch_s:.2f} s, the joiner's sync "
          f"{join_s:.2f} s {tag}", flush=True)
    return {"launches": dict(launches), "wall_s": wall, "max_abs_err": dict(worst)}


def node_part_b_start(root, procs, chain) -> dict:
    """Part B's processes: a home written around phase 17's chain (as phase
    20 leaves it), ``cmd inspect`` over it, then, on a thread once inspect
    serves, the port's ``cmd light`` proxy in front of it trusting height
    1's hash.  Returns the context ``node_part_b`` reads."""
    from cometbft_tpu_torch.config import config as cfgmod
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.store.kv import SqliteKV

    t_run = time.perf_counter()
    db = SqliteKV(chain["db"], surface="state")
    bs = BlockStore(db)
    top, h1 = bs.height(), bs.load_block_meta(1).block_id.hash
    n_vals = len(StateStore(db).load_validators(top))
    db.close()
    ihome, lhome = root / "inspect", root / "light"
    iport, lport = free_ports(2)
    cfg = cfgmod.default_config()
    cfg.base.home = str(ihome)
    cfg.rpc.laddr = f"tcp://127.0.0.1:{iport}"
    cfgmod.write_config(cfg)
    (ihome / "config" / "genesis.json").write_text(chain["genesis"].to_json())
    (ihome / cfg.base.db_dir).mkdir(parents=True, exist_ok=True)
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(chain["db"] + suffix):
            os.replace(chain["db"] + suffix, ihome / cfg.base.db_dir / f"chain.db{suffix}")
    node_spawn(root, procs, "inspect", "inspect", argv=["--home", str(ihome), "inspect"])
    ctx = {"t_run": t_run, "t0": time.perf_counter(), "top": top, "n_vals": n_vals,
           "lport": lport, "error": None}
    inspect_proc = procs[-1][1]

    def bring_up() -> None:
        try:
            t0 = ctx["t0"]
            while node_try(iport, "status") is None:
                if inspect_proc.poll() is not None or time.perf_counter() - t0 > NODE_TIMEOUT_S:
                    raise SmokeError("node: cmd inspect did not serve: "
                                     + (root / "inspect.log").read_text()[-3000:])
                time.sleep(0.1)
            node_spawn(root, procs, "light", "light", argv=[
                "--home", str(lhome), "light", chain["genesis"].chain_id, "--primary",
                f"http://127.0.0.1:{iport}", "--laddr", f"tcp://127.0.0.1:{lport}",
                "--trust-height", "1", "--trust-hash", h1.hex(),
                "--trust-period", str(NODE_TRUST_PERIOD_S)])
            light_proc = procs[-1][1]
            while node_try(lport, "light_status") is None:
                if light_proc.poll() is not None or time.perf_counter() - t0 > NODE_TIMEOUT_S:
                    raise SmokeError("node: cmd light did not serve: "
                                     + (root / "light.log").read_text()[-3000:])
                time.sleep(0.1)
            ctx["up_s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - raised again by node_part_b
            ctx["error"] = e

    ctx["thread"] = threading.Thread(target=bring_up, name="node-part-b-up", daemon=True)
    ctx["thread"].start()
    return ctx


def node_part_b(tag, root, procs, ctx) -> dict:
    """Part B of phase 21: a client reads ``commit``, ``validators`` and
    ``block`` through the ``cmd light`` proxy that ``node_part_b_start``
    started, at NODE_PROXY_HEIGHTS heights above 1 of phase 17's chain (one
    skipping hop, two adjacent ones)."""
    ctx["thread"].join(NODE_TIMEOUT_S)
    if ctx["error"] is not None:
        raise ctx["error"]
    check("up_s" in ctx, "node: part B's processes did not come up")
    t_run, top, n_vals, lport, up_s = (ctx[k] for k in ("t_run", "top", "n_vals", "lport",
                                                         "up_s"))
    t_reads = time.perf_counter()
    heights = list(range(2, top + 1))[:NODE_PROXY_HEIGHTS]
    order = heights[1::2] + heights[0::2]  # skips from below first, then adjacent hops
    read_ms = collections.defaultdict(list)
    for h in order:
        for what in ("commit", "validators", "block"):
            t1 = time.perf_counter()
            got = node_rpc(lport, what, {"height": str(h)}, timeout=120.0)
            read_ms[what].append(round((time.perf_counter() - t1) * 1e3, 3))
            if what == "commit":
                check(got["signed_header"]["header"]["height"] == str(h)
                      and got["canonical"], f"node: the proxy's commit at {h}")
                want = got["signed_header"]["commit"]["block_id"]["hash"]
            elif what == "validators":
                check(got["total"] == str(n_vals), f"node: the proxy's validators at {h}")
            else:
                check(got["block_id"]["hash"] == want, f"node: the proxy's block at {h}")
    reads_s = time.perf_counter() - t_reads
    rep = node_stop(root, procs, ["light", "inspect"])
    lr, ir = rep["light"], rep["inspect"]
    wall = time.perf_counter() - t_run
    hops = lr["hops"]
    check(sorted(x["height"] for x in hops) == heights and lr["rc"] == 0 and ir["rc"] == 0
          and not lr["leaked"], f"node: part B: hops {hops}, rc {lr['rc']}/{ir['rc']}")
    for x in hops:
        skip = x["height"] - 1 not in [y["height"] for y in hops[:hops.index(x)]] + [1]
        check(x["ed25519_launches"] == (2 if skip else 1) and x["tree_launches"] >= 1,
              f"node: part B: the hop to {x['height']} ({'skipping' if skip else 'adjacent'}) "
              f"made {x['ed25519_launches']} Ed25519 and {x['tree_launches']} tree launches")
    for k in ("ed25519", "tree"):
        c = lr["tiers"][k]
        check(c["torch"] == [0, 0] and c["host"] == [0, 0] and c["cuda"][0]
              == lr["launches"][k] > 0, f"node: part B: {k} passes {c} against "
              f"{lr['launches'][k]} launches")
    check(set(lr["max_abs_err"]) >= {"ed25519", "tree"}
          and n_vals in [t[0] for t in lr["kept"]["tree"]],
          f"node: part B: kernels held on {lr['kept']}")
    print(f"node: part B: cmd inspect over phase 17's chain ({n_vals} validators, heights "
          f"1-{top}) and cmd light in front of it (height 1 trusted by hash), both up "
          f"{up_s:.2f} s after inspect's spawn (while part A ran on); the reads took "
          f"{reads_s:.2f} s; through the proxy at heights {order}: commit ms "
          f"{read_ms['commit']}, validators ms {read_ms['validators']}, block ms "
          f"{read_ms['block']}; hops {json.dumps(hops)}; lanes kept {lr['kept']['ed25519']}; "
          f"launches {lr['launches']}, every pass on cuda; the kernels == their plain "
          f"versions on those batches (max_abs_err {lr['max_abs_err']}, device ms "
          f"{lr['device_ms']}); wall {wall:.1f} s {tag}", flush=True)
    return {"launches": lr["launches"], "wall_s": wall, "max_abs_err": lr["max_abs_err"]}


def node_phase(chain, tag) -> dict:
    """Phase 21: the node as users start it.  Part A, a localnet of four
    port validators from ``cmd testnet`` and ``cmd start``, one behind a
    remote signer; part B, phase 17's 10,240-validator chain through ``cmd
    inspect`` and a ``cmd light`` proxy.  Every port process is a child
    that calls the CLI's ``main``.  Returns the launches of both parts."""
    import pathlib

    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="node-"))
    procs: list = []
    out = {}
    try:
        box = {}  # part B's context, made once part A's reads are done
        out["A"] = node_part_a(tag, root, procs, after_reads=lambda: box.setdefault(
            "B", node_part_b_start(root, procs, chain)))
        out["B"] = node_part_b(tag, root, procs, box["B"])
        print(f"node: the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        for _, p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    return {k: out["A"]["launches"][k] + out["B"]["launches"].get(k, 0)
            for k in ("ed25519", "tree", "aead", "ladder")}


def main(n: int = N_VALIDATORS, device: str = "cuda") -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_main = time.perf_counter()

    def lap(phase: str) -> None:
        """Where the script's time goes: each phase's end on one clock."""
        print(f"timeline: {phase} ended {time.perf_counter() - t_main:.1f} s after the start")

    # no background warm-boot pass in this process: its self-check launches
    # would land in the phases' launch counts (phase 16 warms in processes
    # of its own and calls the pass here by hand)
    os.environ["COMETBFT_TPU_WARMBOOT"] = "0"

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
    bls_build_s = built.get(native.BLS_NAME)
    print(f"build: BLS host library {native.BLS_SOURCE}: "
          + ("already built" if bls_build_s is None
             else f"compiled by g++ in {bls_build_s:.2f} s"))
    native.bls()  # loads it, binds it and runs its pairing self-check
    for name in _build.sources():
        for line in ptxas_lines(_build.build_log(name)):
            print(f"build: {name}: {line}")
    lap("build")

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
    bad_commit = tampered(commit, bad)
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

    lap("kernel, slice and times")

    # -- 7. inflight: the light-client window and the overlapped path --------
    window = [commit if i % 2 == 0 else bad_commit for i in range(WINDOW)]
    inflight_phase(torch, ov, cv, val, vals, block_id, window,
                   (pubs, sign_bytes, sigs), tag)
    check_tiers(ds, "inflight")
    lap("inflight")

    # -- 8. gossip: Vote.verify from 64 peers through the scheduler ----------
    votes, vote_keys, vote_want = gossip_phase(cv, ds, val, vals, commit, bad_commit,
                                               block_id, sign_bytes, bad, ref, tag)
    lap("gossip")
    tracing_phase(cv, ds, val, vals, block_id, commit, votes, vote_keys, vote_want, tag)
    lap("tracing")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    check(not leaked, f"imported {leaked}")

    # -- 9. supervisor: tier counters, fault matrix, quarantine --------------
    supervisor_phase(cv, ov, ds, cbatch, val, vals, block_id, commit, pubs,
                     sign_bytes, sigs, ref, tag)
    verifysched.reset_scheduler()  # drains and joins its threads
    lap("supervisor")

    # -- 10. profile: stage builds and field-op chains -----------------------
    chain_entry = profile_phase(torch, dev, t, tg, n, sms, max_clock_mhz, tag)
    lap("profile")

    # -- 11. secp: a secp256k1 commit through the ECDSA kernel --------------
    secp_entry = secp_phase(torch, dev, cbatch, val, ds, sigcache, n, bad, sms,
                            max_clock_mhz, tag)
    lap("secp")

    # -- 12. light: header sync (config 3) through the SHA-256 tree kernel --
    light_entry = light_phase(torch, dev, cbatch, cv, ds, sigcache, sms,
                              max_clock_mhz, tag)
    lap("light")

    # -- 13. bls: BLS12-381 commits (config 5) through the G1 kernel ---------
    bls_entry = bls_phase(torch, dev, cbatch, val, ds, sigcache, sms,
                          max_clock_mhz, tag)
    lap("bls")

    # -- 14. transport: SecretConnection frames and dials through the kernels
    aead_entry, ladder_entry = transport_phase(torch, dev, cbatch, ds, sms,
                                               max_clock_mhz, tag)
    lap("transport")

    # -- 15. proofs: the proof server through the tree kernel's levels -------
    proof_launches = proofs_phase(torch, dev, ds, tag)
    light_entry["launches"] += proof_launches
    print(f"proofs: the tree kernel's launches on its paths: light "
          f"{light_entry['launches'] - proof_launches} + proofs {proof_launches}")
    lap("proofs")

    # -- 16. warmboot: the build cache, the warm pass, msm -------------------
    warmboot_phase(torch, dev, ds, vals, commit, block_id, n, sms,
                   max_clock_mhz, tag)
    lap("warmboot")

    # -- 17. blockexec: a node's apply path over on-disk stores --------------
    t_phase = time.perf_counter()
    be = blockexec_phase(torch, dev, cbatch, cv, ds, sigcache, tag)
    print(f"blockexec: the phase took {time.perf_counter() - t_phase:.1f} s; the "
          f"kernels' launches on its path: Ed25519 {be['ed25519']}, tree {be['tree']} "
          f"(the kernels line below keeps the earlier paths' counts: Ed25519 "
          f"{launches}, tree {light_entry['launches']})")
    lap("blockexec")

    try:
        # -- 18. consensus: four validators, a restart, the seeded network ---
        cs_launches = consensus_phase(torch, dev, cbatch, cv, ds, sigcache, tag)
        print(f"consensus: the kernels' launches on its path: Ed25519 "
              f"{cs_launches['ed25519']}, tree {cs_launches['tree']}; the kernels line "
              f"adds them to the earlier paths' counts (Ed25519 {launches}, tree "
              f"{light_entry['launches']})")
        launches += cs_launches["ed25519"]
        light_entry["launches"] += cs_launches["tree"]
        lap("consensus")

        # -- 18b. sim: the deterministic simulator's scenarios on the card ---
        sim = sim_phase(torch, ds, tag)
        print(f"sim: the kernels line adds the phase's launches to the earlier paths' "
              f"counts (Ed25519 {launches}, tree {light_entry['launches']}, AEAD "
              f"{aead_entry['launches']}, ladder {ladder_entry['launches']})")
        launches += sim["ed25519"]
        light_entry["launches"] += sim["tree"]
        aead_entry["launches"] += sim["aead"]
        ladder_entry["launches"] += sim["ladder"]
        lap("sim")

        # -- 18c. mesh: the elastic mesh over the card's ordinals ------------
        mesh = mesh_phase(torch, ov, cv, ds, (pubs, sign_bytes, sigs), bad, (mp, mm, ms),
                          tag)
        print(f"mesh: the kernels line adds the phase's {mesh['launches']} Ed25519 "
              f"launches to the earlier paths' {launches}")
        launches += mesh["launches"]
        lap("mesh")

        # -- 19. network: switches, reactors, PEX and blocksync ---------------
        net = network_phase(torch, dev, cbatch, cv, ds, sigcache, be, tag)
        lap("network")

        # -- 20. ingest_statesync: a sentry's admission, a fresh node's sync -
        iss = ingest_statesync_phase(torch, dev, cbatch, cv, ds, sigcache, be, tag)
        lap("ingest_statesync")

        # -- 21. node: the CLI's localnet, a remote signer, a light proxy ----
        nd = node_phase(be, tag)
        lap("node")
    finally:
        shutil.rmtree(be["dir"], ignore_errors=True)  # phase 17's chain
    print(f"network: the kernels' launches on its path: Ed25519 {net['ed25519']}, tree "
          f"{net['tree']}, AEAD {net['aead']}, ladder {net['ladder']}; the kernels line "
          f"adds them to the earlier paths' counts (Ed25519 {launches}, tree "
          f"{light_entry['launches']}, AEAD {aead_entry['launches']}, ladder "
          f"{ladder_entry['launches']})")
    launches += net["ed25519"]
    light_entry["launches"] += net["tree"]
    aead_entry["launches"] += net["aead"]
    ladder_entry["launches"] += net["ladder"]
    print(f"ingest_statesync: the kernels' launches on its path: Ed25519 {iss['ed25519']}, "
          f"tree {iss['tree']}, AEAD {iss['aead']}, ladder {iss['ladder']}; the kernels line "
          f"adds them to the earlier paths' counts (Ed25519 {launches}, tree "
          f"{light_entry['launches']}, AEAD {aead_entry['launches']}, ladder "
          f"{ladder_entry['launches']})")
    launches += iss["ed25519"]
    light_entry["launches"] += iss["tree"]
    aead_entry["launches"] += iss["aead"]
    ladder_entry["launches"] += iss["ladder"]
    print(f"node: the kernels' launches on its path: Ed25519 {nd['ed25519']}, tree "
          f"{nd['tree']}, AEAD {nd['aead']}, ladder {nd['ladder']}; the kernels line adds "
          f"them to the earlier paths' counts (Ed25519 {launches}, tree "
          f"{light_entry['launches']}, AEAD {aead_entry['launches']}, ladder "
          f"{ladder_entry['launches']})")
    launches += nd["ed25519"]
    light_entry["launches"] += nd["tree"]
    aead_entry["launches"] += nd["aead"]
    ladder_entry["launches"] += nd["ladder"]

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
    }, chain_entry, secp_entry, light_entry, bls_entry, aead_entry,
        ladder_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warm-child"]:
        sys.exit(warm_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--sim-child"]:
        sys.exit(sim_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--net-node"]:
        sys.exit(net_node_child(sys.argv[2]))
    if sys.argv[1:2] == ["--cli-child"]:
        sys.exit(cli_child(sys.argv[2]))
    if sys.argv[1:2] == ["--abci-app"]:
        sys.exit(abci_app_child(sys.argv[2]))
    sys.exit(main())
