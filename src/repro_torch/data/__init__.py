"""Data pipeline: synthetic token streams, non-IID federated partitioning,
and per-client batches. numpy copies of ``repro.data`` (they import no
JAX): equal seeds give equal arrays in both packages."""
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import dirichlet_partition, shard_partition
from repro_torch.data.synthetic import SyntheticLM, make_batch

__all__ = [
    "SyntheticLM",
    "make_batch",
    "dirichlet_partition",
    "shard_partition",
    "FederatedLoader",
]
