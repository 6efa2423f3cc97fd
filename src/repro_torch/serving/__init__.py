"""Network ingest front-end for the aggregation service — the port's
copy of ``repro.serving``, without JAX.

The paper studies the aggregator in-process; at the Edge its updates
arrive over the wire. This package is that serving layer, stdlib and
numpy only: its threads do host work, landing uploads in the port's
``UpdateStore`` as numpy arrays (bf16 as ``utils.dtypes.BF16`` words)
or ``CompressedUpdate``s; only the rounds touch the card. Frames are
byte-identical to the reference's.

  protocol.py   the upload wire frame (dense + int8-compressed),
                fail-closed parser
  admission.py  token auth, size cap, per-tenant token buckets,
                quota headroom pre-check
  ingest.py     bounded IngestQueue: concurrent uploads coalesce into
                batched ``store.write_batch`` commits, explicit 503
                backpressure
  frontend.py   IngestServer — threaded HTTP endpoint tying the above
                together
  client.py     HttpStoreClient — ``store.write`` over HTTP, the drop-in
                transport for trace replays and benchmarks
"""
from repro_torch.serving.admission import (
    AdmissionController,
    Decision,
    TokenBucket,
)
from repro_torch.serving.client import HttpStoreClient, IngestError
from repro_torch.serving.frontend import IngestServer
from repro_torch.serving.ingest import BackpressureError, IngestQueue
from repro_torch.serving.protocol import (
    KIND_COMPRESSED,
    KIND_DENSE,
    MAGIC,
    ParsedUpdate,
    WireError,
    encode_update,
    parse_update,
)

__all__ = [
    "AdmissionController",
    "BackpressureError",
    "Decision",
    "HttpStoreClient",
    "IngestError",
    "IngestQueue",
    "IngestServer",
    "KIND_COMPRESSED",
    "KIND_DENSE",
    "MAGIC",
    "ParsedUpdate",
    "TokenBucket",
    "WireError",
    "encode_update",
    "parse_update",
]
