"""Regime schedules — mid-run arrival shifts with exact boundaries.

A ``RegimeSchedule`` is a piecewise map from round index to arrival
process. Boundaries are EXACT: the round at ``start_round`` already
samples from the NEW regime (segment ``i`` covers
``[start_round_i, start_round_{i+1})``). This is what the adaptive
gate's drift/rewarm machinery gets measured against.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.workload.arrivals import ArrivalProcess, arrival_from_dict


@dataclasses.dataclass(frozen=True)
class Regime:
    """One named segment: ``arrivals`` in force from ``start_round``."""

    name: str
    arrivals: ArrivalProcess
    start_round: int = 0


@dataclasses.dataclass(frozen=True)
class RegimeSchedule:
    segments: Tuple[Regime, ...]

    def __init__(self, segments: Sequence[Regime]):
        segs = tuple(sorted(segments, key=lambda s: s.start_round))
        if not segs:
            raise ValueError("RegimeSchedule needs at least one regime")
        if segs[0].start_round != 0:
            raise ValueError("first regime must start at round 0 "
                             f"(got {segs[0].start_round})")
        starts = [s.start_round for s in segs]
        if len(set(starts)) != len(starts):
            raise ValueError(f"duplicate regime start rounds: {starts}")
        object.__setattr__(self, "segments", segs)

    @classmethod
    def single(cls, arrivals: ArrivalProcess,
               name: str = "steady") -> "RegimeSchedule":
        return cls([Regime(name, arrivals, 0)])

    def at(self, round_index: int) -> Regime:
        """The regime in force for ``round_index`` (new regime applies
        AT its start round)."""
        if round_index < 0:
            raise ValueError(f"round_index must be >= 0, "
                             f"got {round_index}")
        chosen = self.segments[0]
        for seg in self.segments:
            if seg.start_round <= round_index:
                chosen = seg
            else:
                break
        return chosen

    def to_dict(self) -> dict:
        return {"segments": [
            {"name": s.name, "start_round": s.start_round,
             "arrivals": s.arrivals.to_dict()}
            for s in self.segments
        ]}

    @classmethod
    def from_dict(cls, d: dict) -> "RegimeSchedule":
        return cls([
            Regime(name=s["name"],
                   arrivals=arrival_from_dict(s["arrivals"]),
                   start_round=int(s["start_round"]))
            for s in d["segments"]
        ])
