"""Event pubsub server with a query language (reference: libs/pubsub).

Subscribers register a ``Query`` (same grammar as the reference's
``libs/pubsub/query``: ``tm.event='NewBlock' AND tx.height > 5``); published
messages carry a tag map ``{key: [values...]}`` and are delivered to every
subscription whose query matches.  Delivery is via per-subscription bounded
queues drained by the subscriber (reference: pubsub.Server, out channels).

Query grammar (libs/pubsub/query/syntax):
  condition  := tag op operand
  op         := '=' | '<' | '<=' | '>' | '>=' | CONTAINS | EXISTS
  operand    := 'string' | number | TIME t | DATE d
  query      := condition (AND condition)*
"""

from __future__ import annotations

import queue
import re
import threading

from cometbft_tpu_torch.libs import sync as libsync
from dataclasses import dataclass, field
from typing import Any, Optional


class QueryError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b)
      | (?P<contains>CONTAINS\b)
      | (?P<exists>EXISTS\b)
      | (?P<op><=|>=|=|<|>)
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<tag>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Condition:
    tag: str
    op: str  # '=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    operand: Any = None

    def matches(self, tags: dict[str, list[str]]) -> bool:
        vals = tags.get(self.tag)
        if vals is None:
            return False
        if self.op == "EXISTS":
            return True
        for v in vals:
            if self.op == "=":
                if isinstance(self.operand, (int, float)):
                    try:
                        if float(v) == float(self.operand):
                            return True
                    except ValueError:
                        pass
                elif v == self.operand:
                    return True
            elif self.op == "CONTAINS":
                if str(self.operand) in v:
                    return True
            else:
                try:
                    fv, fo = float(v), float(self.operand)
                except (ValueError, TypeError):
                    continue
                if (
                    (self.op == "<" and fv < fo)
                    or (self.op == "<=" and fv <= fo)
                    or (self.op == ">" and fv > fo)
                    or (self.op == ">=" and fv >= fo)
                ):
                    return True
        return False


class Query:
    """Conjunction of conditions (the reference grammar has no OR)."""

    def __init__(self, conditions: list[Condition], source: str = ""):
        self.conditions = conditions
        self.source = source

    @staticmethod
    def parse(s: str) -> "Query":
        tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if not m or m.end() == pos:
                if s[pos:].strip():
                    raise QueryError(f"syntax error at {s[pos:]!r}")
                break
            pos = m.end()
            kind = m.lastgroup
            tokens.append((kind, m.group(kind)))

        conds: list[Condition] = []
        i = 0
        while i < len(tokens):
            if conds:
                if tokens[i][0] != "and":
                    raise QueryError(f"expected AND, got {tokens[i][1]!r}")
                i += 1
            if i >= len(tokens) or tokens[i][0] != "tag":
                raise QueryError("expected tag name")
            tag = tokens[i][1]
            i += 1
            if i >= len(tokens):
                raise QueryError("expected operator")
            kind, val = tokens[i]
            i += 1
            if kind == "exists":
                conds.append(Condition(tag, "EXISTS"))
                continue
            if kind == "contains":
                if i >= len(tokens) or tokens[i][0] != "str":
                    raise QueryError("CONTAINS requires a string")
                conds.append(Condition(tag, "CONTAINS", _unquote(tokens[i][1])))
                i += 1
                continue
            if kind != "op":
                raise QueryError(f"expected operator, got {val!r}")
            if i >= len(tokens):
                raise QueryError("expected operand")
            okind, oval = tokens[i]
            i += 1
            if okind == "str":
                operand: Any = _unquote(oval)
            elif okind == "num":
                operand = float(oval) if "." in oval else int(oval)
            else:
                raise QueryError(f"bad operand {oval!r}")
            conds.append(Condition(tag, val, operand))
        if not conds:
            raise QueryError("empty query")
        return Query(conds, source=s)

    def matches(self, tags: dict[str, list[str]]) -> bool:
        return all(c.matches(tags) for c in self.conditions)

    def __str__(self) -> str:
        return self.source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.conditions == other.conditions

    def __hash__(self) -> int:
        return hash(tuple(self.conditions))


def _unquote(s: str) -> str:
    return s[1:-1].replace("\\'", "'")


EMPTY_QUERY = Query([Condition("", "EXISTS")])
EMPTY_QUERY.matches = lambda tags: True  # type: ignore[method-assign]


@dataclass
class Message:
    data: Any
    tags: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    """A bounded delivery queue; ``canceled`` is set on unsubscribe with the
    reason (reference: pubsub.Subscription.Canceled)."""

    def __init__(self, query: Query, capacity: int = 100):
        self.query = query
        self.out: queue.Queue[Message] = queue.Queue(maxsize=capacity)
        self.canceled = threading.Event()
        self.cancel_reason: str = ""

    def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self.out.get(timeout=timeout)
        except queue.Empty:
            return None


class PubSubServer:
    """Reference: libs/pubsub/pubsub.go Server."""

    def __init__(self):
        self._subs: dict[tuple[str, str], Subscription] = {}
        self._mtx = libsync.rlock("pubsub")

    def subscribe(
        self, subscriber: str, query: Query, capacity: int = 100
    ) -> Subscription:
        key = (subscriber, str(query))
        with self._mtx:
            if key in self._subs:
                raise ValueError("already subscribed")
            sub = Subscription(query, capacity)
            self._subs[key] = sub
            return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self._cancel((subscriber, str(query)), "unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._mtx:
            keys = [k for k in self._subs if k[0] == subscriber]
        for k in keys:
            self._cancel(k, "unsubscribed")

    def _cancel(self, key: tuple[str, str], reason: str) -> None:
        with self._mtx:
            sub = self._subs.pop(key, None)
        if sub is not None:
            sub.cancel_reason = reason
            sub.canceled.set()

    def publish(self, data: Any, tags: Optional[dict[str, list[str]]] = None):
        tags = tags or {}
        with self._mtx:
            subs = list(self._subs.items())
        for key, sub in subs:
            if sub.query.matches(tags):
                try:
                    sub.out.put_nowait(Message(data, tags))
                except queue.Full:
                    # Slow subscriber: cancel it (reference drops/cancels
                    # depending on config; cancel is the safe default).
                    self._cancel(key, "client was not pulling messages fast enough")

    def num_clients(self) -> int:
        with self._mtx:
            return len({k[0] for k in self._subs})

    def num_subscriptions(self) -> int:
        with self._mtx:
            return len(self._subs)
