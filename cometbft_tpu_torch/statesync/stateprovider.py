"""State provider: trusted consensus state for a snapshot height.

Reference: statesync/stateprovider.go:39 lightClientStateProvider — a
light client verifies headers at H, H+1 and H+2 against the configured
trust root; the reassembled ``sm.State`` carries exactly what the header
chain commits to (validator sets, app hash, results hash).

``device`` (None: the card) goes to the provider's ``LightClient``, which
verifies the snapshot's headers there: commits through the Ed25519
kernel, set hashes through the tree kernel.  With no card it raises
unless the caller names the CPU.
"""

from __future__ import annotations

from cometbft_tpu_torch.light.client import LightClient
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import TrustOptions
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.store.kv import MemKV
from cometbft_tpu_torch.types.block import Commit


class LightClientStateProvider:
    """Reference: stateprovider.go lightClientStateProvider."""

    def __init__(
        self,
        chain_id: str,
        providers: list,  # light providers (>=1; reference wants >=2 RPC)
        trust_options: TrustOptions,
        genesis_doc=None,
        logger=None,
        now_fn=None,
        device=None,
    ):
        self.chain_id = chain_id
        self.genesis_doc = genesis_doc
        kwargs = {}
        if now_fn is not None:
            # determinism seam: the simulator verifies headers whose times
            # come from its virtual clock, so expiry/drift checks must read
            # the same clock (production keeps the wall-clock default)
            kwargs["now_fn"] = now_fn
        self.client = LightClient(
            chain_id,
            trust_options,
            providers[0],
            providers[1:],
            LightStore(MemKV()),
            logger=logger,
            device=device,
            **kwargs,
        )

    def app_hash(self, height: int) -> bytes:
        """App hash AFTER block ``height`` = header(height+1).app_hash
        (reference: stateprovider.go:103 AppHash)."""
        lb = self.client.verify_light_block_at_height(height + 1)
        return lb.signed_header.header.app_hash

    def commit(self, height: int) -> Commit:
        """Reference: stateprovider.go:128 Commit."""
        lb = self.client.verify_light_block_at_height(height)
        return lb.signed_header.commit

    def state(self, height: int) -> State:
        """Reference: stateprovider.go:139 State — the state the node would
        have AFTER applying block ``height``."""
        last = self.client.verify_light_block_at_height(height)
        current = self.client.verify_light_block_at_height(height + 1)
        next_ = self.client.verify_light_block_at_height(height + 2)
        params = self.client.primary.consensus_params(height + 1)
        gdoc = self.genesis_doc
        return State(
            chain_id=self.chain_id,
            initial_height=gdoc.initial_height if gdoc else 1,
            last_block_height=last.height,
            last_block_id=current.signed_header.header.last_block_id,
            last_block_time=last.signed_header.header.time,
            validators=current.validator_set,
            next_validators=next_.validator_set,
            last_validators=last.validator_set,
            last_height_validators_changed=next_.height,
            consensus_params=params,
            last_height_consensus_params_changed=current.height,
            last_results_hash=current.signed_header.header.last_results_hash,
            app_hash=current.signed_header.header.app_hash,
            version_app=current.signed_header.header.version.app,
        )
