"""Classification result store: the port's copy of ``vct/serve/store.py``.

The reference uses MongoDB as the rendezvous between backend, worker, and
deployment CLI (``backend.py:11-18,49-50,87``). This is a stdlib sqlite3
equivalent with the same document shape ({url, labels, scores, timestamp})
and the same upsert/lookup operations; thread-safe for the threaded HTTP
backend."""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import List, Optional

__all__ = ["ResultStore"]


class ResultStore:
    def __init__(self, path: str):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._local = threading.local()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS results ("
                "url TEXT PRIMARY KEY, labels TEXT, scores TEXT, timestamp TEXT)"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            self._local.conn = conn
        return conn

    def insert(self, url: str, labels: List[str], scores=None, timestamp: str = ""):
        with self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO results VALUES (?, ?, ?, ?)",
                (url, json.dumps(labels), json.dumps(scores), timestamp),
            )

    def find_one(self, url: str) -> Optional[dict]:
        cur = self._conn().execute(
            "SELECT url, labels, scores, timestamp FROM results WHERE url = ?",
            (url,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {
            "url": row[0],
            "labels": json.loads(row[1]),
            "scores": json.loads(row[2]) if row[2] else None,
            "timestamp": row[3],
        }

    def all(self) -> List[dict]:
        cur = self._conn().execute("SELECT url, labels, scores, timestamp FROM results")
        return [
            {
                "url": r[0],
                "labels": json.loads(r[1]),
                "scores": json.loads(r[2]) if r[2] else None,
                "timestamp": r[3],
            }
            for r in cur.fetchall()
        ]
