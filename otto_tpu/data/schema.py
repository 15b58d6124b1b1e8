"""Core data containers.

The on-disk/exchange schema matches the reference parquet layout
`[session: i32, aid: i32, ts: i32 (seconds), type: i8]`
(reference: etl/jsonl_to_parquet.py:23-29), but in memory everything is a
structure-of-arrays NumPy/JAX container, not a DataFrame.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _pyarrow():
    """(pyarrow, pyarrow.parquet), imported on first parquet use: pyarrow
    is the optional `parquet` extra, and nothing else in the package
    needs it."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "parquet IO needs pyarrow: pip install 'otto-tpu[parquet]'"
        ) from e
    return pa, pq


@dataclasses.dataclass
class Events:
    """Flat event table, the L1 interchange format."""

    session: np.ndarray  # int32 [E]
    aid: np.ndarray      # int32 [E]
    ts: np.ndarray       # int32 [E] seconds
    type: np.ndarray     # int8  [E] 0=clicks 1=carts 2=orders

    def __post_init__(self):
        self.session = np.asarray(self.session, np.int32)
        self.aid = np.asarray(self.aid, np.int32)
        self.ts = np.asarray(self.ts, np.int32)
        self.type = np.asarray(self.type, np.int8)

    def __len__(self) -> int:
        return len(self.session)

    @property
    def n_sessions(self) -> int:
        return len(np.unique(self.session))

    @property
    def n_aids(self) -> int:
        return int(self.aid.max()) + 1 if len(self.aid) else 0

    def sort_by_session_ts(self) -> "Events":
        order = np.lexsort((self.ts, self.session))
        return Events(
            self.session[order], self.aid[order], self.ts[order], self.type[order]
        )

    def select(self, mask: np.ndarray) -> "Events":
        return Events(self.session[mask], self.aid[mask], self.ts[mask], self.type[mask])

    def concat(self, other: "Events") -> "Events":
        return Events(
            np.concatenate([self.session, other.session]),
            np.concatenate([self.aid, other.aid]),
            np.concatenate([self.ts, other.ts]),
            np.concatenate([self.type, other.type]),
        )

    # -- parquet interop (host IO boundary) --------------------------------
    def to_parquet(self, path: str) -> None:
        pa, pq = _pyarrow()
        table = pa.table(
            {
                "session": pa.array(self.session, pa.int32()),
                "aid": pa.array(self.aid, pa.int32()),
                "ts": pa.array(self.ts, pa.int32()),
                "type": pa.array(self.type, pa.int8()),
            }
        )
        pq.write_table(table, path)

    @staticmethod
    def from_parquet(path: str) -> "Events":
        _, pq = _pyarrow()
        t = pq.read_table(path)
        return Events(
            t["session"].to_numpy(),
            t["aid"].to_numpy(),
            t["ts"].to_numpy(),
            t["type"].to_numpy(),
        )


@dataclasses.dataclass
class Labels:
    """Ground-truth labels `[session, type, aid]`
    (reference: etl/jsonl_to_parquet.py:45-56)."""

    session: np.ndarray  # int32 [N]
    type: np.ndarray     # int8  [N]
    aid: np.ndarray      # int32 [N]

    def __post_init__(self):
        self.session = np.asarray(self.session, np.int32)
        self.type = np.asarray(self.type, np.int8)
        self.aid = np.asarray(self.aid, np.int32)

    def __len__(self) -> int:
        return len(self.session)

    def for_type(self, type_id: int) -> "Labels":
        m = self.type == type_id
        return Labels(self.session[m], self.type[m], self.aid[m])

    def to_parquet(self, path: str) -> None:
        pa, pq = _pyarrow()
        table = pa.table(
            {
                "session": pa.array(self.session, pa.int32()),
                "type": pa.array(self.type, pa.int8()),
                "aid": pa.array(self.aid, pa.int32()),
            }
        )
        pq.write_table(table, path)

    @staticmethod
    def from_parquet(path: str) -> "Labels":
        _, pq = _pyarrow()
        t = pq.read_table(path)
        return Labels(
            t["session"].to_numpy(), t["type"].to_numpy(), t["aid"].to_numpy()
        )
