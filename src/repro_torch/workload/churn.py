"""Tenant churn — cold-start tenants joining (and leaving) mid-soak.

The base tenants in a ``WorkloadSpec`` run the whole horizon; churn
adds tenants that appear at some round with NO arrival history — the
cross-tenant prior's target population — and optionally retire after a
lifetime. Joins are either scheduled exactly (``scheduled_joins``,
deterministic regardless of seed) or Poisson-random per round
(``join_rate``, deterministic given the trace seed).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantChurn:
    """``schedule`` expands to per-round active churn-tenant lists."""

    join_rate: float = 0.0
    # mean lifetime in rounds for random joins (geometric); None: stays
    lifetime_rounds: Optional[int] = None
    # exact (join_round, lifetime_or_None) pairs, independent of seed
    scheduled_joins: Tuple[Tuple[int, Optional[int]], ...] = ()
    prefix: str = "churn"

    def schedule(self, rng: np.random.Generator,
                 rounds: int) -> List[List[str]]:
        """Per-round sorted lists of active churn tenants
        (``f"{prefix}{i}"``, numbered in join order)."""
        spans: List[Tuple[int, int, str]] = []
        idx = 0
        for join, life in self.scheduled_joins:
            if not 0 <= join < rounds:
                raise ValueError(f"scheduled join at round {join} outside "
                                 f"horizon [0, {rounds})")
            end = rounds if life is None else min(join + life, rounds)
            spans.append((join, end, f"{self.prefix}{idx}"))
            idx += 1
        if self.join_rate > 0.0:
            for r in range(rounds):
                for _ in range(int(rng.poisson(self.join_rate))):
                    if self.lifetime_rounds is None:
                        end = rounds
                    else:
                        life = int(rng.geometric(
                            1.0 / max(self.lifetime_rounds, 1)))
                        end = min(r + life, rounds)
                    spans.append((r, end, f"{self.prefix}{idx}"))
                    idx += 1
        active: List[List[str]] = [[] for _ in range(rounds)]
        for start, end, name in spans:
            for r in range(start, end):
                active[r].append(name)
        for names in active:
            names.sort()
        return active

    def to_dict(self) -> dict:
        return {
            "join_rate": self.join_rate,
            "lifetime_rounds": self.lifetime_rounds,
            "scheduled_joins": [list(j) for j in self.scheduled_joins],
            "prefix": self.prefix,
        }


def churn_from_dict(d: dict) -> TenantChurn:
    return TenantChurn(
        join_rate=d.get("join_rate", 0.0),
        lifetime_rounds=d.get("lifetime_rounds"),
        scheduled_joins=tuple(
            (int(j[0]), None if j[1] is None else int(j[1]))
            for j in d.get("scheduled_joins", ())
        ),
        prefix=d.get("prefix", "churn"),
    )
