"""SQLite results database with the bayesian_benchmarks schema
(port of dgps_with_iwvi_tpu/evaluation/database.py).

One row per completed (dataset, split, configuration) experiment
(bb:bayesian_benchmarks/database_utils.py). The schema and columns are the
reference's, so rows written by either package sit in one table.
"""

from __future__ import annotations

import contextlib
import json
import sqlite3
import time
from typing import Any, Dict

SCHEMA = """
CREATE TABLE IF NOT EXISTS regression (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    dataset TEXT NOT NULL,
    split INTEGER NOT NULL,
    configuration TEXT NOT NULL,
    mode TEXT NOT NULL,
    M INTEGER,
    K INTEGER,
    num_samples INTEGER,
    minibatch_size INTEGER,
    iterations INTEGER,
    lr REAL,
    gamma REAL,
    test_loglik REAL,
    test_rmse REAL,
    test_loglik_normalized REAL,
    test_rmse_normalized REAL,
    elbo REAL,
    steps_per_sec REAL,
    synthetic_data INTEGER DEFAULT 0,
    extra TEXT,
    timestamp REAL
);
"""


class Database:
    def __init__(self, path: str = "results.db"):
        self.path = path
        with self._connect() as conn:
            conn.executescript(SCHEMA)

    @contextlib.contextmanager
    def _connect(self):
        """A connection that commits on success and is closed after."""
        conn = sqlite3.connect(self.path)
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    _COLS = ("dataset", "split", "configuration", "mode", "M", "K",
             "num_samples", "minibatch_size", "iterations", "lr", "gamma",
             "test_loglik", "test_rmse", "test_loglik_normalized",
             "test_rmse_normalized", "elbo", "steps_per_sec",
             "synthetic_data")

    def write_result(self, row: Dict[str, Any]) -> None:
        known = {k: row.get(k) for k in self._COLS}
        known["synthetic_data"] = int(bool(known.get("synthetic_data")))
        extra = {k: v for k, v in row.items() if k not in self._COLS}
        cols = list(known) + ["extra", "timestamp"]
        vals = list(known.values()) + [json.dumps(extra), time.time()]
        q = (f"INSERT INTO regression ({', '.join(cols)}) "
             f"VALUES ({', '.join('?' * len(cols))})")
        with self._connect() as conn:
            conn.execute(q, vals)

    def read(self, dataset: str | None = None) -> list:
        q = "SELECT * FROM regression"
        args: tuple = ()
        if dataset is not None:
            q += " WHERE dataset = ?"
            args = (dataset,)
        with self._connect() as conn:
            conn.row_factory = sqlite3.Row
            return [dict(r) for r in conn.execute(q, args).fetchall()]
