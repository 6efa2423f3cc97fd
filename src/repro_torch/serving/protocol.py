"""Upload wire format — the one frame a client POSTs to ``/v1/upload``.

One frame carries one client update: a fixed header (magic, kind,
client id, weight) followed by a dense payload (dtype + dim + raw
bytes) or a compressed payload (dim + block geometry + int8 codes +
fp32 scales — exactly the ``CompressedUpdate`` container the store
spools, so parsing lands the same object ``store.write`` takes
in-process and fused vectors stay bit-identical across transports).

All integers are little-endian. Layout::

    magic   4s   b"FLU1"
    kind    u8   0 = dense, 1 = compressed
    idlen   u16  client id byte length (1..256)
    id      idlen bytes, utf-8
    weight  f64  finite, > 0

    dense:                         compressed:
      dtlen   u8                     dim      u64  (logical P, >= 1)
      dtype   dtlen bytes ascii      nblocks  u32  (>= 1)
      dim     u64  (>= 1)            block    u32  (>= 1)
      payload dim * itemsize         codes    nblocks * block  int8
                                     scales   nblocks          fp32

Parsing FAILS CLOSED: any truncation, trailing bytes, unknown magic /
kind / dtype, zero dim, non-finite weight or scales, or a block
geometry that does not tile ``dim`` raises :class:`WireError` — a
malformed body must never reach the store.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Union

import numpy as np

from repro_torch.core.compress import CompressedUpdate
from repro_torch.utils.dtypes import dtype_from_name, dtype_name, host_array

MAGIC = b"FLU1"
KIND_DENSE = 0
KIND_COMPRESSED = 1
MAX_CLIENT_ID_BYTES = 256

# the dense dtypes the store round-trips (bf16 as ``utils.dtypes.BF16``
# words, spooled as raw bytes + a .dtype sidecar)
_DENSE_DTYPES = ("float32", "float16", "float64", "bfloat16")

_HEAD = struct.Struct("<4sBH")      # magic, kind, idlen
_WEIGHT = struct.Struct("<d")
_DIM = struct.Struct("<Q")
_GEOM = struct.Struct("<QII")       # dim, nblocks, block


class WireError(ValueError):
    """A frame failed validation — reject with 400, land nothing."""


@dataclasses.dataclass(frozen=True)
class ParsedUpdate:
    """A validated frame, ready for ``store.write``-shaped ingestion."""

    client_id: str
    weight: float
    update: Union[np.ndarray, CompressedUpdate]

    @property
    def kind(self) -> int:
        return (KIND_COMPRESSED
                if isinstance(self.update, CompressedUpdate)
                else KIND_DENSE)


def _dtype_of(update: np.ndarray) -> str:
    """The wire name of a dense payload's dtype. numpy names the port's
    bf16 words ``void16`` and has no bfloat16 of its own, so the name
    comes from ``utils.dtypes``, which knows both bf16 forms."""
    name = dtype_name(update.dtype)
    if name not in _DENSE_DTYPES:
        raise WireError(
            f"dense upload dtype {name!r} not on the wire whitelist "
            f"{_DENSE_DTYPES}"
        )
    return name


def encode_update(client_id: str,
                  update: Union[np.ndarray, CompressedUpdate],
                  weight: float = 1.0) -> bytes:
    """Serialize one update into its upload frame (the client side of
    :func:`parse_update`). A tensor, on any device, is copied to the
    host first; bf16 (``BF16`` words or an ``ml_dtypes`` array) goes on
    the wire as its raw 16-bit words, the reference's bytes."""
    cid = client_id.encode("utf-8")
    if not 1 <= len(cid) <= MAX_CLIENT_ID_BYTES:
        raise WireError(
            f"client id must encode to 1..{MAX_CLIENT_ID_BYTES} bytes, "
            f"got {len(cid)}"
        )
    w = float(weight)
    if not np.isfinite(w) or w <= 0:
        raise WireError(f"weight must be finite and > 0, got {w!r}")
    if isinstance(update, CompressedUpdate):
        head = _HEAD.pack(MAGIC, KIND_COMPRESSED, len(cid))
        codes = np.ascontiguousarray(update.codes, dtype=np.int8)
        scales = np.ascontiguousarray(update.scales, dtype=np.float32)
        return b"".join([
            head, cid, _WEIGHT.pack(w),
            _GEOM.pack(int(update.dim), scales.size, update.block),
            codes.tobytes(), scales.tobytes(),
        ])
    vec = np.ascontiguousarray(host_array(update))
    if vec.ndim != 1 or vec.size == 0:
        raise WireError(
            f"dense upload must be a non-empty 1-D vector, "
            f"got shape {vec.shape}"
        )
    name = _dtype_of(vec).encode("ascii")
    head = _HEAD.pack(MAGIC, KIND_DENSE, len(cid))
    return b"".join([
        head, cid, _WEIGHT.pack(w),
        struct.pack("<B", len(name)), name,
        _DIM.pack(vec.size), vec.tobytes(),
    ])


class _Cursor:
    """Bounds-checked reader over the frame buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.buf):
            raise WireError(
                f"truncated frame: wanted {n} bytes at offset "
                f"{self.off}, have {len(self.buf) - self.off}"
            )
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))

    def done(self) -> None:
        if self.off != len(self.buf):
            raise WireError(
                f"{len(self.buf) - self.off} trailing bytes after frame"
            )


def parse_update(buf: bytes) -> ParsedUpdate:
    """Validate and decode one upload frame. Raises :class:`WireError`
    on ANY structural problem — fail closed, nothing partial."""
    cur = _Cursor(bytes(buf))
    magic, kind, idlen = cur.unpack(_HEAD)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (want {MAGIC!r})")
    if kind not in (KIND_DENSE, KIND_COMPRESSED):
        raise WireError(f"unknown frame kind {kind}")
    if not 1 <= idlen <= MAX_CLIENT_ID_BYTES:
        raise WireError(f"client id length {idlen} out of range")
    try:
        client_id = cur.take(idlen).decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"client id is not valid utf-8: {e}") from e
    (weight,) = cur.unpack(_WEIGHT)
    if not np.isfinite(weight) or weight <= 0:
        raise WireError(f"weight must be finite and > 0, got {weight!r}")

    if kind == KIND_DENSE:
        (dtlen,) = struct.unpack("<B", cur.take(1))
        try:
            dtname = cur.take(dtlen).decode("ascii")
        except UnicodeDecodeError as e:
            raise WireError(f"dtype name is not ascii: {e}") from e
        if dtname not in _DENSE_DTYPES:
            raise WireError(
                f"dense upload dtype {dtname!r} not on the wire "
                f"whitelist {_DENSE_DTYPES}"
            )
        dt = dtype_from_name(dtname)   # bfloat16: BF16 words
        (dim,) = cur.unpack(_DIM)
        if dim < 1:
            raise WireError("dense dim must be >= 1")
        payload = cur.take(dim * dt.itemsize)
        cur.done()
        vec = np.frombuffer(payload, dtype=dt).copy()
        return ParsedUpdate(client_id=client_id, weight=weight,
                            update=vec)

    dim, nblocks, block = cur.unpack(_GEOM)
    if dim < 1 or nblocks < 1 or block < 1:
        raise WireError(
            f"compressed geometry out of range: dim={dim} "
            f"nblocks={nblocks} block={block}"
        )
    # codes are zero-padded to whole blocks COVERING dim, no more: the
    # canonical CompressedUpdate layout (block recoverable from shapes)
    if not (nblocks - 1) * block < dim <= nblocks * block:
        raise WireError(
            f"block geometry does not tile dim: dim={dim} "
            f"nblocks={nblocks} block={block}"
        )
    codes = np.frombuffer(cur.take(nblocks * block),
                          dtype=np.int8).copy()
    scales = np.frombuffer(cur.take(nblocks * 4),
                           dtype="<f4").astype(np.float32)
    cur.done()
    if not np.all(np.isfinite(scales)):
        raise WireError("compressed scales must be finite")
    return ParsedUpdate(
        client_id=client_id, weight=weight,
        update=CompressedUpdate(codes=codes, scales=scales,
                                dim=int(dim)),
    )
