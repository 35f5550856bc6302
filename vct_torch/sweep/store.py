"""Experiment checkpoint store: the port's copy of ``vct/sweep/store.py``
(the same calls write the same bytes, so either package reads or resumes the
other's store).

Canonical artifact: a JSON list of {"config", "metrics",
"best_model_filename"} entries with the same schema as the reference's sweep
records (``loader_data.py:526-538`` load/save_checkpoint; data shape per
``dumps/*.json``), used both to record bests and to skip already-completed
configs on resume (``hyperparam.py:32-38``).

Write path: the reference rewrites the whole JSON list per append
(``loader_data.py:535-538``) — O(n^2) bytes over a sweep (664 entries in
``dumps/medsos_checkpoint.json``). Here appends go to a JSONL journal sidecar
(``<path>l``, one line per entry — O(1) per append); ``load()`` merges base
JSON + journal, and the journal folds back into the canonical JSON every
``COMPACT_EVERY`` appends and on any explicit ``save()``/``compact()``, so
the reference-schema artifact stays fresh without per-append rewrites.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

__all__ = ["SweepStore", "is_config_duplicate"]

COMPACT_EVERY = 50  # journal entries folded into the canonical JSON


def append_jsonl_line(path: str, text: str) -> None:
    """Append one JSONL line, healing a torn tail first.

    A crash mid-append can leave the file ending in a partial line with no
    newline; a naive append would concatenate onto it and corrupt BOTH
    entries. Loaders skip the torn line either way — this keeps the new
    entry off it."""
    lead = ""
    try:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                lead = "\n"
    except (OSError, ValueError):
        pass  # missing or empty file
    with open(path, "a") as f:
        f.write(lead + text + "\n")
        f.flush()


def is_config_duplicate(completed_configs: List[dict], config: dict) -> bool:
    """hyperparam.py:14-29: exact key/value match against completed configs."""
    for done in completed_configs:
        if all(done.get(k) == v for k, v in config.items()) and len(done) == len(config):
            return True
    return False


class SweepStore:
    def __init__(self, path: str):
        self.path = path
        self.journal_path = path + "l"  # foo.json -> foo.jsonl

    def _load_base(self) -> List[dict]:
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    return json.load(f)
            except json.JSONDecodeError:
                print("Error loading checkpoint. Invalid JSON format.")
                return []
        return []

    def _load_journal(self) -> List[dict]:
        if not os.path.exists(self.journal_path):
            return []
        entries = []
        with open(self.journal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(json.loads(line))
                except json.JSONDecodeError:
                    # torn tail write (crash mid-append): drop the bad line,
                    # keep everything before it — same resume-over-perfection
                    # stance as the reference's invalid-JSON fallback.
                    print("Skipping corrupt journal line.")
        return entries

    def load(self) -> List[dict]:
        return self._load_base() + self._load_journal()

    def save(self, results: List[dict]) -> None:
        """Full rewrite: canonical JSON becomes ``results``, journal resets."""
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(results, f, indent=4)
        if os.path.exists(self.journal_path):
            os.remove(self.journal_path)

    def append(self, entry: dict) -> None:
        """O(1) append: one JSON line to the journal (not a list rewrite)."""
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        append_jsonl_line(self.journal_path, json.dumps(entry))
        # Fold into the canonical reference-schema JSON every COMPACT_EVERY
        # appends (amortized O(1) per append, and dumps/*.json-style readers
        # see an at-most-COMPACT_EVERY-stale canonical file).
        with open(self.journal_path) as f:
            n = sum(1 for line in f if line.strip())
        if n >= COMPACT_EVERY:
            self.compact()

    def compact(self) -> None:
        """Fold the journal into the canonical JSON list."""
        self.save(self.load())

    def completed_configs(self) -> List[dict]:
        return [r["config"] for r in self.load() if "config" in r]

    def best(self, key: str = "f1_score") -> Optional[dict]:
        results = [r for r in self.load() if r.get("metrics", {}).get(key) is not None]
        return max(results, key=lambda r: r["metrics"][key]) if results else None
