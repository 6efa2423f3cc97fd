"""The port's upload wire format (``repro_torch.serving.protocol``)
against the JAX package's.

Twins of the 19 tests of ``tests/test_wire_format.py`` on the port's
``encode_update`` / ``parse_update`` (bf16 as ``utils.dtypes.BF16``
words), then the cross-package checks: for dense fp32, fp16, fp64 and
bf16 and for compressed payloads the port's frame is the reference's
frame byte for byte, each package parses the other's frames to equal
fields with equal payload bits, and every truncation point and trailing
bytes raise ``WireError`` in both.
"""
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.compress import compress_update as jcompress_update
from repro.serving import WireError as JWireError
from repro.serving import encode_update as jencode
from repro.serving import parse_update as jparse
from repro_torch.core.compress import CompressedUpdate, compress_update
from repro_torch.serving import WireError, encode_update, parse_update
from repro_torch.serving.protocol import (
    KIND_COMPRESSED,
    KIND_DENSE,
    MAGIC,
    MAX_CLIENT_ID_BYTES,
)
from repro_torch.utils.dtypes import BF16, host_array


def _bf16_words(vec32: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16, as the port's host words."""
    return host_array(torch.from_numpy(vec32).to(torch.bfloat16))


def _tensor(vec: np.ndarray) -> torch.Tensor:
    """A host vector as a CPU tensor of its dtype (BF16 words as bf16)."""
    if vec.dtype == BF16:
        return torch.from_numpy(vec.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(vec)


# -- lossless round-trips ----------------------------------------------------

@settings(max_examples=40)
@given(
    dim=st.integers(min_value=1, max_value=400),
    weight=st.floats(min_value=1e-3, max_value=1e3),
    dtype=st.sampled_from(["float32", "float16", "float64"]),
    seed=st.integers(min_value=0, max_value=2**31),
)
def test_dense_round_trip_is_bitwise(dim, weight, dtype, seed):
    vec = np.random.default_rng(seed).normal(size=(dim,)).astype(dtype)
    parsed = parse_update(encode_update("client-7", vec, weight=weight))
    assert parsed.client_id == "client-7"
    assert parsed.weight == weight          # f64 on the wire: exact
    assert parsed.kind == KIND_DENSE
    assert parsed.update.dtype == np.dtype(dtype)
    assert parsed.update.tobytes() == vec.tobytes()


def test_bfloat16_round_trip_is_bitwise():
    """bf16 parses to ``BF16`` words; words, an ``ml_dtypes`` array and a
    bf16 tensor with the same bits encode to the same frame."""
    vec = _bf16_words(np.linspace(-2, 2, 129).astype(np.float32))
    frame = encode_update("bf", vec)
    parsed = parse_update(frame)
    assert parsed.update.dtype == BF16
    assert parsed.update.tobytes() == vec.tobytes()
    as_ml = vec.view(np.uint16).view(ml_dtypes.bfloat16)
    assert encode_update("bf", as_ml) == frame
    assert encode_update("bf", _tensor(vec)) == frame


@settings(max_examples=40)
@given(
    dim=st.integers(min_value=1, max_value=2000),
    block=st.sampled_from([32, 64, 256]),
    weight=st.floats(min_value=1e-3, max_value=1e3),
    seed=st.integers(min_value=0, max_value=2**31),
)
def test_compressed_round_trip_is_bitwise(dim, block, weight, seed):
    vec = np.random.default_rng(seed).normal(size=(dim,)) \
        .astype(np.float32)
    cu = compress_update(vec, block=min(block, max(dim, 1)))
    parsed = parse_update(encode_update("cmp", cu, weight=weight))
    assert parsed.kind == KIND_COMPRESSED
    got = parsed.update
    assert isinstance(got, CompressedUpdate)
    assert got.dim == cu.dim and got.block == cu.block
    assert np.array_equal(got.codes, np.asarray(cu.codes, np.int8))
    assert np.array_equal(got.scales,
                          np.asarray(cu.scales, np.float32))


@pytest.mark.parametrize("dim", [1, 2, 255, 256, 257, 511, 512, 513])
def test_compressed_degenerate_dims_round_trip(dim):
    """Block-boundary dims (the ragged-final-block cases)."""
    vec = np.linspace(-1, 1, dim).astype(np.float32)
    cu = compress_update(vec, block=256)
    got = parse_update(encode_update("c", cu)).update
    assert got.dim == dim
    assert np.array_equal(got.codes, np.asarray(cu.codes, np.int8))


def test_unicode_client_id_round_trips():
    vec = np.ones(4, np.float32)
    cid = "edge-αβγ-端末-7"
    assert parse_update(encode_update(cid, vec)).client_id == cid


def test_dim_one_dense_round_trips():
    parsed = parse_update(
        encode_update("c", np.asarray([3.25], np.float32)))
    assert parsed.update.shape == (1,)
    assert parsed.update[0] == np.float32(3.25)


# -- truncation: EVERY proper prefix must fail closed ------------------------

def _frames(encode=encode_update, compress=compress_update):
    dense = encode("cli-0", np.arange(9, dtype=np.float32), weight=2.0)
    cu = compress(np.linspace(-1, 1, 70).astype(np.float32), block=32)
    compressed = encode("cli-1", cu, weight=0.5)
    return {"dense": dense, "compressed": compressed}


@pytest.mark.parametrize("name", ["dense", "compressed"])
def test_every_truncation_point_fails_closed(name):
    frame = _frames()[name]
    for cut in range(len(frame)):
        with pytest.raises(WireError):
            parse_update(frame[:cut])


@pytest.mark.parametrize("name", ["dense", "compressed"])
@pytest.mark.parametrize("junk", [b"\x00", b"FLU1", b"\xff" * 9])
def test_trailing_bytes_fail_closed(name, junk):
    frame = _frames()[name]
    with pytest.raises(WireError, match="trailing"):
        parse_update(frame + junk)


# -- corrupted headers -------------------------------------------------------

def test_bad_magic_rejected():
    frame = _frames()["dense"]
    with pytest.raises(WireError, match="magic"):
        parse_update(b"XLU1" + frame[4:])


def test_unknown_kind_rejected():
    frame = bytearray(_frames()["dense"])
    frame[4] = 9
    with pytest.raises(WireError, match="kind"):
        parse_update(bytes(frame))


def test_zero_idlen_rejected():
    frame = bytearray(_frames()["dense"])
    frame[5:7] = struct.pack("<H", 0)
    with pytest.raises(WireError, match="id length"):
        parse_update(bytes(frame))


def test_non_utf8_client_id_rejected():
    head = struct.pack("<4sBH", MAGIC, KIND_DENSE, 2)
    rest = _frames()["dense"][7 + 5:]     # skip original 5-byte id
    with pytest.raises(WireError, match="utf-8"):
        parse_update(head + b"\xff\xfe" + rest)


@pytest.mark.parametrize("w", [0.0, -1.0, float("nan"), float("inf")])
def test_non_positive_or_non_finite_weight_rejected(w):
    # craft on the wire — encode_update refuses to build these
    frame = bytearray(_frames()["dense"])
    off = struct.calcsize("<4sBH") + len("cli-0")
    frame[off:off + 8] = struct.pack("<d", w)
    with pytest.raises(WireError, match="weight"):
        parse_update(bytes(frame))


@pytest.mark.parametrize("name", [b"int32", b"void16", b"uint16"])
def test_dtype_off_whitelist_rejected(name):
    """Off the whitelist, including the names numpy gives the port's bf16
    words (``void16``) and their raw view (``uint16``)."""
    cid = b"c"
    head = struct.pack("<4sBH", MAGIC, KIND_DENSE, len(cid))
    tail = struct.pack("<B", len(name)) + name + struct.pack("<Q", 2) \
        + np.zeros(2, np.int32).tobytes()
    with pytest.raises(WireError, match="whitelist"):
        parse_update(head + cid + struct.pack("<d", 1.0) + tail)


def test_zero_dim_dense_rejected():
    cid = b"c"
    head = struct.pack("<4sBH", MAGIC, KIND_DENSE, len(cid))
    name = b"float32"
    tail = struct.pack("<B", len(name)) + name + struct.pack("<Q", 0)
    with pytest.raises(WireError, match="dim"):
        parse_update(head + cid + struct.pack("<d", 1.0) + tail)


@settings(max_examples=30)
@given(
    dim=st.integers(min_value=1, max_value=500),
    nblocks=st.integers(min_value=1, max_value=8),
    block=st.integers(min_value=1, max_value=128),
)
def test_untileable_block_geometry_rejected(dim, nblocks, block):
    """Whenever (nblocks, block) does not tile dim the frame must be
    rejected even with a correctly-sized payload; whenever it does,
    the frame parses — in both packages."""
    cid = b"g"
    head = struct.pack("<4sBH", MAGIC, KIND_COMPRESSED, len(cid))
    frame = (
        head + cid + struct.pack("<d", 1.0)
        + struct.pack("<QII", dim, nblocks, block)
        + np.zeros(nblocks * block, np.int8).tobytes()
        + np.ones(nblocks, np.float32).tobytes()
    )
    tiles = (nblocks - 1) * block < dim <= nblocks * block
    if tiles:
        assert parse_update(frame).update.dim == dim
        assert jparse(frame).update.dim == dim
    else:
        with pytest.raises(WireError, match="geometry"):
            parse_update(frame)
        with pytest.raises(JWireError, match="geometry"):
            jparse(frame)


def test_non_finite_scales_rejected():
    cu = compress_update(np.ones(64, np.float32), block=32)
    frame = bytearray(encode_update("c", cu))
    # scales are the final nblocks * 4 bytes
    frame[-8:-4] = struct.pack("<f", float("inf"))
    with pytest.raises(WireError, match="finite"):
        parse_update(bytes(frame))


# -- encode-side refusals ----------------------------------------------------

def test_encode_rejects_bad_client_ids():
    vec = np.ones(4, np.float32)
    with pytest.raises(WireError):
        encode_update("", vec)
    with pytest.raises(WireError):
        encode_update("x" * (MAX_CLIENT_ID_BYTES + 1), vec)
    # multi-byte utf-8 counts in BYTES, not characters
    with pytest.raises(WireError):
        encode_update("端" * 100, vec)   # 300 bytes


def test_encode_rejects_bad_payloads():
    with pytest.raises(WireError, match="1-D"):
        encode_update("c", np.ones((2, 2), np.float32))
    with pytest.raises(WireError, match="1-D"):
        encode_update("c", np.ones(0, np.float32))
    with pytest.raises(WireError, match="whitelist"):
        encode_update("c", np.ones(4, np.int64))
    with pytest.raises(WireError, match="whitelist"):
        encode_update("c", torch.ones(4, dtype=torch.int32))
    with pytest.raises(WireError, match="weight"):
        encode_update("c", np.ones(4, np.float32), weight=0.0)
    with pytest.raises(WireError, match="weight"):
        encode_update("c", np.ones(4, np.float32),
                      weight=float("nan"))


# -- the two packages' frames ------------------------------------------------

def _dense_pair(dtype, dim, seed):
    """(the port's vector, the reference's vector) with the same bits."""
    vec = np.random.default_rng(seed).normal(size=(dim,)).astype(np.float32)
    if dtype == "bfloat16":
        words = _bf16_words(vec)
        return words, words.view(np.uint16).view(ml_dtypes.bfloat16)
    vec = vec.astype(dtype)
    return vec, vec


@settings(max_examples=20)
@given(
    dim=st.integers(min_value=1, max_value=600),
    weight=st.floats(min_value=1e-3, max_value=1e3),
    dtype=st.sampled_from(["float32", "float16", "float64", "bfloat16"]),
    seed=st.integers(min_value=0, max_value=2**31),
)
def test_dense_frames_byte_identical_to_reference(dim, weight, dtype, seed):
    ours, theirs = _dense_pair(dtype, dim, seed)
    frame = encode_update("edge-7", ours, weight=weight)
    assert frame == jencode("edge-7", theirs, weight=weight)
    # a tensor encodes as its host array
    assert encode_update("edge-7", _tensor(ours), weight=weight) == frame


@pytest.mark.parametrize("dim,block", [(1, 2048), (70, 32), (513, 256),
                                       (5003, 2048)])
def test_compressed_frames_byte_identical_to_reference(dim, block):
    vec = np.random.default_rng(dim).normal(size=(dim,)).astype(np.float32)
    ours = compress_update(vec, block=block)
    theirs = jcompress_update(vec, block=block)
    assert encode_update("cmp", ours, weight=0.25) \
        == jencode("cmp", theirs, weight=0.25)


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64",
                                   "bfloat16", "compressed"])
def test_each_package_parses_the_others_frames(dtype):
    if dtype == "compressed":
        vec = np.linspace(-3, 3, 777).astype(np.float32)
        ours, theirs = (compress_update(vec, block=64),
                        jcompress_update(vec, block=64))
    else:
        ours, theirs = _dense_pair(dtype, 777, seed=5)
    for encode, parse in ((encode_update, jparse), (jencode, parse_update)):
        src = ours if encode is encode_update else theirs
        got = parse(encode("peer", src, weight=1.5))
        assert got.client_id == "peer" and got.weight == 1.5
        if dtype == "compressed":
            assert got.kind == KIND_COMPRESSED
            assert got.update.dim == 777 and got.update.block == 64
            assert got.update.codes.tobytes() == ours.codes.tobytes()
            assert got.update.scales.tobytes() == ours.scales.tobytes()
        else:
            assert got.kind == KIND_DENSE
            assert got.update.tobytes() == ours.tobytes()
    # the port parses the reference's bf16 frame to BF16 words
    if dtype == "bfloat16":
        assert parse_update(jencode("peer", theirs)).update.dtype == BF16


@pytest.mark.parametrize("name", ["dense", "compressed"])
def test_truncation_and_trailing_bytes_fail_closed_in_both(name):
    ours = _frames()[name]
    assert ours == _frames(jencode, jcompress_update)[name]
    for cut in range(len(ours)):
        with pytest.raises(WireError):
            parse_update(ours[:cut])
        with pytest.raises(JWireError):
            jparse(ours[:cut])
    for junk in (b"\x00", b"FLU1", b"\xff" * 9):
        with pytest.raises(WireError, match="trailing"):
            parse_update(ours + junk)
        with pytest.raises(JWireError, match="trailing"):
            jparse(ours + junk)
