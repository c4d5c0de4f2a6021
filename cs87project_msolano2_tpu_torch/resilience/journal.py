"""Atomic per-cell JSONL journal: a kill loses one cell, not the run
(the reference's ``resilience/journal.py``).

One record per line, ``{"cell": <id>, ...payload}``, appended with one
write, flush and fsync, so a kill can at worst truncate the last line,
and :meth:`Journal.load` tolerates exactly that (a half-written tail is
skipped with a diagnostic, never an error).  It drives the bench's
``--resume`` and the harness sweep's completed-cell skipping.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def open_append(path: str):
    """An append-mode UTF-8 handle for a JSONL file, parents created."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    return open(path, "a", encoding="utf-8")


def write_line(fh, rec: dict, *, fsync: bool = True) -> None:
    """Append one record as a single flushed line; ``fsync`` adds the
    durability barrier.  A kill can at worst truncate the last line,
    which :func:`load_records` tolerates."""
    fh.write(json.dumps(rec, sort_keys=True) + "\n")
    fh.flush()
    if fsync:
        os.fsync(fh.fileno())


def load_records(path: str) -> tuple:
    """(records, dropped) of a JSONL file: every parseable object line,
    and how many corrupt lines were skipped.  A missing file is (no
    records, 0 dropped), never an error."""
    records: list = []
    dropped = 0
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    dropped += 1
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
                else:
                    dropped += 1
    return records, dropped


def torn_tail(path: str) -> bool:
    """True where the file's last line lacks its newline (a kill cut
    the last write)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(-1, os.SEEK_END)
            return fh.read(1) != b"\n"
    except OSError:  # missing or empty
        return False


class Journal:
    """Append-only JSONL checkpoint keyed by cell id."""

    def __init__(self, path: str):
        self.path = path
        self._cells: Optional[dict] = None

    def load(self) -> dict:
        """cell id -> last recorded payload.  Corrupt lines (the
        half-written tail a kill leaves) are skipped with a diagnostic;
        a later record of a cell wins."""
        records, dropped = load_records(self.path)
        cells: dict = {}
        for rec in records:
            if "cell" in rec:
                cells[str(rec["cell"])] = rec
        if dropped:
            from ..plans.core import warn

            warn(f"journal {self.path}: skipped {dropped} "
                 f"corrupt line(s) (interrupted write); the cells "
                 f"they held will re-run")
        self._cells = cells
        return cells

    def _loaded(self) -> dict:
        if self._cells is None:
            self.load()
        return self._cells

    def has(self, cell: str) -> bool:
        return str(cell) in self._loaded()

    def get(self, cell: str) -> Optional[dict]:
        return self._loaded().get(str(cell))

    def record(self, cell: str, payload: Optional[dict] = None) -> dict:
        """Append one cell record, flushed and fsynced before return.  A
        record appended after a half-written tail starts a line of its
        own, so the re-run cell is not lost with the tail."""
        rec = dict(payload or {})
        rec["cell"] = str(cell)
        torn = torn_tail(self.path)
        with open_append(self.path) as fh:
            if torn:
                fh.write("\n")
            write_line(fh, rec, fsync=True)
        self._loaded()[str(cell)] = rec
        return rec

    def reset(self) -> None:
        """Start the journal over: a fresh run must not inherit cells."""
        if os.path.exists(self.path):
            os.remove(self.path)
        self._cells = {}

    def guard_config(self, config: dict, label: str = "run") -> None:
        """Bind the journal to its run configuration (the ``config``
        cell): a journal written by a different configuration raises
        ValueError, since resuming a full-size run from a smoke journal
        would splice toy numbers into the record.  Only the keys in
        `config` are compared.  `label` names the writer in the
        refusal."""
        prior = self.get("config")
        if prior is not None:
            prior = {k: prior.get(k) for k in config}
            if prior != config:
                raise ValueError(
                    f"journal {self.path} was written by a different "
                    f"{label} configuration ({prior} != {config}); "
                    f"use a fresh journal or delete it")
        else:
            self.record("config", config)
