"""Workload classification — the paper's Algorithm 1 condition against
one card's memory hierarchy.

Paper: ``S = w_s * n`` compared against single-node DRAM ``M``. Here
the single node is one GPU:

  ONCHIP_RESIDENT — S is within a few multiples of the on-chip tier
                    (L2): the fused single-card kernel streams it in
                    one device-memory pass, no collectives.
  HBM_LOCAL       — S fits the card's device memory (with headroom for
                    the fused output and working set).
  DISTRIBUTED     — S exceeds one card: shard clients/coordinates
                    across cards (the paper's Spark/HDFS path).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core.compress import BLOCK, compressed_bytes
from repro_torch.utils.mem import H100_SXM, HardwareSpec


class WorkloadClass(enum.Enum):
    ONCHIP_RESIDENT = "onchip_resident"
    HBM_LOCAL = "hbm_local"
    DISTRIBUTED = "distributed"


@dataclasses.dataclass(frozen=True)
class Workload:
    """One aggregation round's load descriptor (the paper's (w_s, n))."""

    update_bytes: int          # w_s — REAL on-wire bytes per update
    n_clients: int             # n
    dtype_bytes: int = 4
    # explicit param count for payloads where update_bytes is not
    # params * dtype_bytes (int8 codes carry fp32 per-block scales)
    params: Optional[int] = None

    @property
    def total_bytes(self) -> int:  # S = w_s * n
        return self.update_bytes * self.n_clients

    @property
    def num_params(self) -> int:
        if self.params is not None:
            return self.params
        return self.update_bytes // self.dtype_bytes

    @classmethod
    def for_params(cls, num_params: int, n_clients: int,
                   compressed: bool = False,
                   block: Optional[int] = None) -> "Workload":
        """A load descriptor from a parameter count at the REAL transport
        size: int8 codes + fp32 per-block scales when ``compressed``."""
        if compressed:
            return cls(
                update_bytes=compressed_bytes(num_params, block or BLOCK),
                n_clients=n_clients, dtype_bytes=1, params=num_params,
            )
        return cls(update_bytes=num_params * 4, n_clients=n_clients,
                   dtype_bytes=4, params=num_params)


# fraction of device memory usable for update storage (rest: output,
# fp32 accumulators, allocator workspace)
HBM_HEADROOM = 0.75


def classify(load: Workload, hw: HardwareSpec = H100_SXM) -> WorkloadClass:
    s = load.total_bytes
    if s <= hw.onchip_bytes * 4:
        return WorkloadClass.ONCHIP_RESIDENT
    if s <= hw.hbm_bytes * HBM_HEADROOM:
        return WorkloadClass.HBM_LOCAL
    return WorkloadClass.DISTRIBUTED


def max_clients_single_node(update_bytes: int,
                            hw: HardwareSpec = H100_SXM) -> int:
    """The paper's Fig. 1/2 quantity: max n for one node at given w_s."""
    return int(hw.hbm_bytes * HBM_HEADROOM // max(update_bytes, 1))
