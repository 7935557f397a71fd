"""Failure injection + handling policy for the training loop (a copy of
``repro.train.failure``).

Event kinds (what a 1000-node fleet actually throws at you):
* ``crash``        — host loss: in-memory state gone; restore newest valid
                     checkpoint, replay the data cursor.
* ``straggler``    — step exceeds its deadline; the step is deterministic,
                     so the survivor policy re-executes it (results identical
                     — verified by tests).
* ``corrupt_ckpt`` — a checkpoint chunk is bit-flipped in the BB store; the
                     fletcher verification rejects it and the loop falls back
                     to the previous checkpoint.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FailurePlan:
    """step → event kind ("crash" | "straggler" | "corrupt_ckpt")."""
    events: Dict[int, str] = field(default_factory=dict)

    @classmethod
    def random_plan(cls, steps: int, rate: float, seed: int = 0
                    ) -> "FailurePlan":
        rng = random.Random(seed)
        kinds = ["crash", "straggler", "corrupt_ckpt"]
        ev = {s: rng.choice(kinds) for s in range(2, steps)
              if rng.random() < rate}
        return cls(ev)

    def at(self, step: int) -> Optional[str]:
        return self.events.get(step)


@dataclass
class FailureLog:
    crashes: int = 0
    stragglers: int = 0
    corruptions: int = 0
    restores: int = 0
    fallback_restores: int = 0
    redone_steps: List[int] = field(default_factory=list)
