"""Safety invariants checked after every simulated event.

Checks are incremental — each (node, height) pair is verified exactly once
when the node first stores that height — so running them after every
delivered message costs O(new commits), not O(history):

  * **agreement** — no two nodes ever commit different blocks at one height
    (the first committed hash per height is the canonical one).
  * **validity** — every stored seen-commit carries +2/3 valid signatures
    from the *height-correct* validator set, checked through the production
    ``verify_commit`` path (and therefore the BatchVerifier seam).
  * **validator-set** — the checker replays validator-set evolution itself
    (genesis set + the ``validator_updates`` each committed block's
    finalize response carries, through the production
    ``validate_validator_updates`` path) and requires every header's
    ``validators_hash`` / ``next_validators_hash`` to match the tracked
    sets.  Since the header hash is what the commit signs, this chains
    custody light-client-style: a rotation can only be accepted if the
    previous height's (+2/3-signed) header committed to it.
  * **wal-replay** — the fsync'd ``#ENDHEIGHT h`` marker exists for every
    height the node committed *through consensus*, so a crash after this
    point replays deterministically; on restart the rebuilt state must
    agree with the stores it was rebuilt from.  Heights below a node's
    block-store base (obtained via statesync, not consensus) are exempt.

Limitation: consensus-param updates are not replayed (no sim scenario
issues them); ``validate_validator_updates`` runs against genesis params.

The validity check's ``verify_commit`` runs on the host
(``backend="cpu"``), as in the JAX package: the checker is the oracle the
nodes are held to, independent of the kernel and the device tiers they
verify on, and it adds nothing to their launches, flushes or breakers.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.types.validation import verify_commit


class InvariantViolation(AssertionError):
    """Raised (or recorded) when a safety property breaks."""

    def __init__(self, name: str, detail: str, time: float = 0.0):
        super().__init__(f"[{name}] at t={time:.6f}: {detail}")
        self.invariant = name
        self.detail = detail
        self.time = time


@dataclass
class Violation:
    invariant: str
    detail: str
    time: float


class InvariantChecker:
    def __init__(self, chain_id: str, genesis_state, check_wal: bool = True):
        self.chain_id = chain_id
        self.consensus_params = genesis_state.consensus_params
        initial = genesis_state.initial_height
        # canonical validator set per height, advanced as blocks commit:
        # vals[h+2] = update(vals[h+1], updates-from-block-h), exactly the
        # state/execution.go updateState schedule
        self.val_sets = {
            initial: genesis_state.validators.copy(),
            initial + 1: genesis_state.next_validators.copy(),
        }
        self.val_updates: dict[int, list] = {}  # height -> canonical updates
        self.check_wal = check_wal
        self.canonical: dict[int, bytes] = {}  # height -> first committed hash
        self._checked: dict[int, int] = {}  # node index -> last verified height
        # incremental WAL readers: node -> (byte offset, end-heights seen);
        # keeps the per-event WAL check O(new bytes), not O(log) per height
        self._wal_tail: dict[int, tuple[int, set]] = {}
        # node index -> heights at/below this arrived via statesync (no WAL)
        self._wal_floor: dict[int, int] = {}
        self.violations: list[Violation] = []
        self.commits_verified = 0
        self.rotations_seen = 0  # heights whose canonical updates were non-empty

    # -- driver hooks ------------------------------------------------------

    def on_event(self, cluster) -> list[str]:
        """Verify every height newly stored since the last call; returns
        deterministic trace lines for fresh commits."""
        lines: list[str] = []
        for node in cluster.live_nodes():
            i = node.index
            top = node.block_store.height()
            for h in range(self._checked.get(i, 0) + 1, top + 1):
                lines.extend(self._check_height(cluster, node, h))
            self._checked[i] = max(self._checked.get(i, 0), top)
        return lines

    def on_restart(self, cluster, index: int) -> None:
        """WAL/store consistency after a crash-restart rebuild."""
        node = cluster.nodes[index]
        state = node.state_store.load()
        store_h = node.block_store.height()
        state_h = state.last_block_height if state is not None else -1
        # a statesync joiner restarted before its first post-join commit
        # has state at the snapshot height but an empty block store; every
        # other node must agree exactly
        floor = self._wal_floor.get(index, 0)
        expect_h = max(store_h, floor)
        if state_h != expect_h:
            self._violate(
                cluster,
                "wal-replay",
                f"node{index} restarted with state height {state_h} != "
                f"block store height {expect_h}",
            )
        # the consensus state must resume at the next height
        if node.cs.rs.height != expect_h + 1:
            self._violate(
                cluster,
                "wal-replay",
                f"node{index} consensus resumed at {node.cs.rs.height}, "
                f"store at {expect_h}",
            )
        # re-verification of already-committed heights must still pass —
        # from the node's base, not genesis (a statesync joiner never held
        # the pre-snapshot blocks)
        base = node.block_store.base()
        self._checked[index] = max(0, base - 1, floor)

    def on_join(self, cluster, index: int, base_height: int) -> None:
        """A node bootstrapped via statesync at ``base_height``: its first
        consensus-made commit is base_height+1, and nothing below it exists
        in its stores or WAL."""
        self._checked[index] = base_height
        self._wal_floor[index] = base_height
        self._wal_tail.pop(index, None)

    # -- checks ------------------------------------------------------------

    def _vals_at(self, h: int):
        return self.val_sets.get(h)

    def _advance_val_sets(self, cluster, node, h: int) -> None:
        """Record height h's canonical validator updates (first node to
        commit h wins) and derive the set for h+2, mirroring
        state/execution updateState.  The derived set is authenticated one
        height later, when header h+1's next_validators_hash is checked."""
        if h in self.val_updates or (h + 2) in self.val_sets:
            return
        raw = node.state_store.load_finalize_block_response(h)
        if raw is None:
            return  # another node will supply it when it commits h
        from cometbft_tpu_torch.state.execution import (
            fbr_from_json,
            validate_validator_updates,
        )

        base = self._vals_at(h + 1)
        if base is None:
            return
        res = fbr_from_json(raw)
        try:
            updates = validate_validator_updates(
                res.validator_updates, self.consensus_params
            )
        except Exception as e:  # noqa: BLE001 — an invalid committed update
            self._violate(
                cluster,
                "validator-set",
                f"height {h} committed invalid validator updates: {e!r}",
            )
            return
        self.val_updates[h] = updates
        nxt = base.copy()
        if updates:
            nxt.update_with_change_set(updates)
            self.rotations_seen += 1
        nxt.increment_proposer_priority(1)
        self.val_sets[h + 2] = nxt

    def _check_height(self, cluster, node, h: int) -> list[str]:
        meta = node.block_store.load_block_meta(h)
        if meta is None:
            self._violate(
                cluster, "agreement", f"node{node.index} height {h} has no meta"
            )
            return []
        block_hash = meta.block_id.hash
        lines = [
            "%.6f commit node%d h=%d hash=%s"
            % (cluster.clock.now(), node.index, h, block_hash.hex()[:16])
        ]

        canonical = self.canonical.setdefault(h, block_hash)
        if canonical != block_hash:
            self._violate(
                cluster,
                "agreement",
                f"fork at height {h}: node{node.index} committed "
                f"{block_hash.hex()[:16]}, canonical is {canonical.hex()[:16]}",
            )

        vals = self._vals_at(h)
        if vals is None:
            self._violate(
                cluster,
                "validator-set",
                f"node{node.index} committed height {h} but the canonical "
                f"validator set for it is unknown (tracking hole)",
            )
        else:
            if meta.header.validators_hash != vals.hash():
                self._violate(
                    cluster,
                    "validator-set",
                    f"node{node.index} height {h} header validators_hash "
                    f"does not match the tracked set",
                )
            nxt = self._vals_at(h + 1)
            if nxt is not None and meta.header.next_validators_hash != nxt.hash():
                self._violate(
                    cluster,
                    "validator-set",
                    f"node{node.index} height {h} header "
                    f"next_validators_hash does not match the tracked set",
                )

        commit = node.block_store.load_seen_commit(h)
        if commit is None:
            self._violate(
                cluster,
                "validity",
                f"node{node.index} stored height {h} without a seen commit",
            )
        elif vals is not None:
            try:
                verify_commit(
                    self.chain_id,
                    vals,
                    meta.block_id,
                    h,
                    commit,
                    backend="cpu",
                )
                self.commits_verified += 1
            except Exception as e:  # noqa: BLE001 — any rejection is a violation
                self._violate(
                    cluster,
                    "validity",
                    f"node{node.index} height {h} commit rejected: {e!r}",
                )

        self._advance_val_sets(cluster, node, h)

        if (
            self.check_wal
            and node.cs.wal is not None
            and h > self._wal_floor.get(node.index, 0)
        ):
            if h not in self._wal_ends(node):
                self._violate(
                    cluster,
                    "wal-replay",
                    f"node{node.index} committed height {h} without an "
                    f"#ENDHEIGHT marker in its WAL",
                )
        return lines

    def _wal_ends(self, node) -> set:
        """End-height markers in the node's WAL, read incrementally (only
        the bytes appended since the previous check are parsed)."""
        import os as _os

        offset, ends = self._wal_tail.get(node.index, (0, set()))
        wal = node.cs.wal
        try:
            size = _os.path.getsize(wal.path)
        except OSError:
            size = 0
        if size < offset:  # truncated (crash dropped an unflushed tail)
            offset, ends = 0, set()
        fresh, offset = wal.scan_end_heights(offset)
        ends |= fresh
        self._wal_tail[node.index] = (offset, ends)
        return ends

    def _violate(self, cluster, name: str, detail: str) -> None:
        v = Violation(name, detail, cluster.clock.now())
        self.violations.append(v)
        if cluster.raise_on_violation:
            raise InvariantViolation(name, detail, cluster.clock.now())
