"""Trusted light-block store (reference: light/store/db/db.go)."""

from __future__ import annotations

import struct
import threading
from typing import Optional

from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.light import LightBlock

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">q", height)


class LightStore:
    """Persists verified light blocks, ordered by height."""

    def __init__(self, db):
        self._db = db
        self._lock = threading.Lock()

    def save_light_block(self, lb: LightBlock) -> None:
        with self._lock:
            self._db.set(_key(lb.height), codec.encode_light_block(lb))

    def light_block(self, height: int) -> Optional[LightBlock]:
        raw = self._db.get(_key(height))
        return codec.decode_light_block(raw) if raw else None

    def latest(self) -> Optional[LightBlock]:
        best = None
        for _k, raw in self._db.iterate(_PREFIX, _PREFIX + b"\xff"):
            best = raw
        return codec.decode_light_block(best) if best else None

    def first(self) -> Optional[LightBlock]:
        for _k, raw in self._db.iterate(_PREFIX, _PREFIX + b"\xff"):
            return codec.decode_light_block(raw)
        return None

    def heights(self) -> list[int]:
        out = []
        for k, _raw in self._db.iterate(_PREFIX, _PREFIX + b"\xff"):
            out.append(struct.unpack(">q", k[len(_PREFIX) :])[0])
        return out

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        """Latest stored block strictly below ``height`` (reference:
        db.go LightBlockBefore)."""
        best = None
        for h in self.heights():
            if h < height:
                best = h
            else:
                break
        return self.light_block(best) if best is not None else None

    def prune(self, keep: int) -> int:
        """Keep only the newest ``keep`` blocks (reference: db.go Prune)."""
        hs = self.heights()
        to_delete = hs[:-keep] if keep > 0 else hs
        with self._lock:
            for h in to_delete:
                self._db.delete(_key(h))
        return len(to_delete)

    def size(self) -> int:
        return len(self.heights())
