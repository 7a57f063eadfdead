"""Typed EventBus over the pubsub server.

Reference: types/event_bus.go + types/events.go — consensus and the block
executor publish typed events; the RPC WebSocket layer and the tx/block
indexers subscribe with queries like ``tm.event='Tx' AND tx.hash='AB..'``.
App-emitted ABCI events become additional tags ``{type}.{key}=value``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from cometbft_tpu_torch.libs.pubsub import PubSubServer, Query, Subscription

# tm.event values (reference: types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VALID_BLOCK = "ValidBlock"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event: str) -> Query:
    return Query.parse(f"{EVENT_TYPE_KEY}='{event}'")


@dataclass
class EventDataNewBlock:
    block: Any  # types.Block
    block_id: Any
    result_finalize_block: Any = None  # abci FinalizeBlockResponse


@dataclass
class EventDataNewBlockHeader:
    header: Any


@dataclass
class EventDataNewBlockEvents:
    height: int
    events: list = field(default_factory=list)
    num_txs: int = 0


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: Any  # abci ExecTxResult


@dataclass
class EventDataRoundState:
    height: int
    round_: int
    step: str


@dataclass
class EventDataNewRound:
    height: int
    round_: int
    step: str
    proposer_address: bytes = b""


@dataclass
class EventDataCompleteProposal:
    height: int
    round_: int
    step: str
    block_id: Any = None


@dataclass
class EventDataVote:
    vote: Any


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


def _abci_event_tags(events) -> dict[str, list[str]]:
    """Flatten app events into ``{type}.{key}`` tags (indexed or not — the
    pubsub layer matches all; the indexer filters on the index flag)."""
    tags: dict[str, list[str]] = {}
    for ev in events or []:
        for attr in ev.attributes:
            key = f"{ev.type_}.{attr.key}"
            tags.setdefault(key, []).append(attr.value)
    return tags


class EventBus:
    """Reference: types/event_bus.go EventBus."""

    def __init__(self):
        self.pubsub = PubSubServer()

    def subscribe(
        self, subscriber: str, query: Query, capacity: int = 100
    ) -> Subscription:
        return self.pubsub.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    # -- publishers -------------------------------------------------------

    def _publish(self, event: str, data: Any, extra: Optional[dict] = None):
        tags = {EVENT_TYPE_KEY: [event]}
        if extra:
            for k, v in extra.items():
                tags.setdefault(k, []).extend(v)
        self.pubsub.publish(data, tags)

    def publish_new_block(self, data: EventDataNewBlock) -> None:
        extra = {BLOCK_HEIGHT_KEY: [str(data.block.header.height)]}
        if data.result_finalize_block is not None:
            extra.update(_abci_event_tags(data.result_finalize_block.events))
        self._publish(EVENT_NEW_BLOCK, data, extra)

    def publish_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, data)

    def publish_new_block_events(self, data: EventDataNewBlockEvents) -> None:
        extra = {BLOCK_HEIGHT_KEY: [str(data.height)]}
        extra.update(_abci_event_tags(data.events))
        self._publish(EVENT_NEW_BLOCK_EVENTS, data, extra)

    def publish_tx(self, data: EventDataTx) -> None:
        from cometbft_tpu_torch.crypto import tmhash

        extra = {
            TX_HEIGHT_KEY: [str(data.height)],
            TX_HASH_KEY: [tmhash.sum256(data.tx).hex().upper()],
        }
        extra.update(_abci_event_tags(data.result.events if data.result else []))
        self._publish(EVENT_TX, data, extra)

    def publish_validator_set_updates(
        self, data: EventDataValidatorSetUpdates
    ) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data)

    def publish_relock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_RELOCK, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)

    def publish_valid_block(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_VALID_BLOCK, data)


class NopEventBus(EventBus):
    def __init__(self):
        super().__init__()

    def _publish(self, event, data, extra=None):
        pass
