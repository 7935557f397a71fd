"""Per-call dense/compacted pick (twin of ``repro.core.exchange_select``).

``BBClient(exchange="auto")`` asks ``pick_backend`` per call shape.  The
port has no crossover measured on the card yet, so the pick is the nearest
cell, in log-(N, q, words) space, of a copy of the JAX package's fallback
table (measured there on the CPU stacked backend).  Both planes are exact,
so a wrong pick costs time, never correctness.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

#: (n_nodes, batch, words, winner): the JAX package's ``FALLBACK_TABLE``
FALLBACK_TABLE = (
    (4, 8, 8, "dense"),
    (4, 16, 8, "dense"),
    (8, 16, 8, "dense"),
    (8, 64, 16, "compacted"),
    (16, 64, 16, "compacted"),
    (32, 64, 16, "compacted"),
    (64, 128, 16, "compacted"),
)


def pick_backend(n_nodes: int, q: int, words: int,
                 table: Sequence[Tuple[int, int, int, str]] = FALLBACK_TABLE
                 ) -> str:
    """"dense" or "compacted" for one call shape: the winner of the
    nearest table cell in log-(N, q, words) space."""
    best, best_d = "compacted", None
    for ni, qi, wi, winner in table:
        d = (math.log(max(n_nodes, 1) / ni) ** 2 +
             math.log(max(q, 1) / qi) ** 2 +
             math.log(max(words, 1) / wi) ** 2)
        if best_d is None or d < best_d:
            best, best_d = winner, d
    return best
