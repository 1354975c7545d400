"""Host-side document store (sqlite3, C stdlib).

A copy of ``vietnamese_qa_system_tpu/engine/docstore.py`` without its
jax-importing timing decorator.

Capability of the reference's passage store
(reference inference_pipeline/db_utils/setup_db.py: `setup_database` :12,
`drop_tables` :40, `query` :59, `insert_data` :86, `connect_database` :119,
schema `documents(id, doc, source)` :138).  Per SURVEY §2.3 the doc fetch is
host-side and not perf-critical; the TPU engine stores only vectors — ids
returned by the index resolve to text here.
"""

from __future__ import annotations

import sqlite3
from typing import Iterable, Optional, Sequence

SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY,
    doc TEXT NOT NULL,
    source TEXT
)
"""


class DocStore:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        # check_same_thread=False: the HTTP serving layer
        # (engine/server.py) resolves ids on its batcher worker thread
        # while ingest runs on the main thread.  CPython's sqlite3 is
        # built serialized (sqlite3.threadsafety == 3), so cross-thread
        # use of one connection is safe; an in-memory store could not
        # use per-thread connections anyway (each would be its own db).
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(SCHEMA)
        self._conn.commit()

    # -- capability of setup_db.setup_database / drop_tables ---------------
    def drop(self) -> None:
        self._conn.execute("DROP TABLE IF EXISTS documents")
        self._conn.execute(SCHEMA)
        self._conn.commit()

    # -- capability of setup_db.insert_data (transactional executemany) ----
    def insert(
        self,
        ids: Sequence[int],
        docs: Sequence[str],
        sources: Optional[Sequence[str]] = None,
    ) -> None:
        if sources is None:
            sources = [None] * len(docs)
        rows = list(zip(map(int, ids), docs, sources))
        try:
            with self._conn:
                self._conn.executemany(
                    "INSERT OR REPLACE INTO documents (id, doc, source) "
                    "VALUES (?, ?, ?)",
                    rows,
                )
        except sqlite3.Error:
            self._conn.rollback()
            raise

    # -- capability of setup_db.query (fetch all / many / one) -------------
    def get(self, ids: Iterable[int]) -> list[Optional[str]]:
        out = []
        for i in ids:
            row = self._conn.execute(
                "SELECT doc FROM documents WHERE id = ?", (int(i),)
            ).fetchone()
            out.append(row[0] if row else None)
        return out

    def get_rows(self, ids: Iterable[int]) -> list[Optional[tuple]]:
        out = []
        for i in ids:
            row = self._conn.execute(
                "SELECT id, doc, source FROM documents WHERE id = ?", (int(i),)
            ).fetchone()
            out.append(row)
        return out

    def fetch(self, limit: Optional[int] = None, offset: int = 0):
        sql = "SELECT id, doc, source FROM documents ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)} OFFSET {int(offset)}"
        return self._conn.execute(sql).fetchall()

    def count(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM documents").fetchone()[0]

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
