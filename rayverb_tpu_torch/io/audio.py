"""WAV / AIFF PCM writers (and a reader for tests).

The reference writes interleaved PCM via libsndfile (cmd/main.cpp:26-48,
209-239). Encoders here are pure numpy — vectorised native code, no
Python-level sample loops — and support the same format matrix:
{wav, aif, aiff} x {16, 24}-bit (cmd/main.cpp:209-228).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..utils import profiling

SUPPORTED_BIT_DEPTHS = (16, 24)
SUPPORTED_EXTENSIONS = ("wav", "aif", "aiff")


class AudioFormatError(ValueError):
    pass


def _quantize(channels: np.ndarray, bit_depth: int) -> np.ndarray:
    """float (C, T) -> int32 (T, C) interleaved PCM codes (clipped)."""
    data = np.asarray(channels, dtype=np.float64)
    if data.ndim != 2:
        raise AudioFormatError("expected (channels, samples) array")
    full = float(2 ** (bit_depth - 1))
    codes = np.clip(np.rint(data * full), -full, full - 1).astype(np.int32)
    return codes.T.copy()  # interleave: frame-major


def _pack_pcm(codes: np.ndarray, bit_depth: int, big_endian: bool) -> bytes:
    flat = codes.reshape(-1)
    if bit_depth == 16:
        dt = ">i2" if big_endian else "<i2"
        return flat.astype(dt).tobytes()
    if bit_depth == 24:
        # pack low 3 bytes of each int32
        u = flat.astype(np.uint32).view(np.uint8).reshape(-1, 4)
        if flat.dtype.byteorder == ">" or (flat.dtype.byteorder == "=" and not np.little_endian):
            b0, b1, b2 = u[:, 1], u[:, 2], u[:, 3]  # pragma: no cover
        else:
            b0, b1, b2 = u[:, 2], u[:, 1], u[:, 0]  # big-endian order bytes
        if big_endian:
            out = np.stack([b0, b1, b2], axis=1)
        else:
            out = np.stack([b2, b1, b0], axis=1)
        return out.tobytes()
    raise AudioFormatError(
        f"unsupported bit depth {bit_depth}; supported: {SUPPORTED_BIT_DEPTHS}"
    )


def write_wav(path: str, channels, sample_rate: float, bit_depth: int) -> None:
    codes = _quantize(channels, bit_depth)
    nframes, nch = codes.shape
    payload = _pack_pcm(codes, bit_depth, big_endian=False)
    sr = int(round(sample_rate))
    block_align = nch * bit_depth // 8
    fmt = struct.pack(
        "<4sIHHIIHH",
        b"fmt ", 16, 1, nch, sr, sr * block_align, block_align, bit_depth
    )
    data_hdr = struct.pack("<4sI", b"data", len(payload))
    riff_size = 4 + len(fmt) + len(data_hdr) + len(payload) + (len(payload) & 1)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE"))
        fh.write(fmt)
        fh.write(data_hdr)
        fh.write(payload)
        if len(payload) & 1:
            fh.write(b"\x00")


def _float80(value: float) -> bytes:
    """Encode an IEEE 754 80-bit extended float (AIFF sample rate field)."""
    if value == 0:
        return b"\x00" * 10
    import math

    sign = 0
    if value < 0:
        sign = 0x8000
        value = -value
    mant, exp = math.frexp(value)  # value = mant * 2**exp, mant in [0.5, 1)
    exp_field = exp - 1 + 16383
    mant_field = int(mant * (1 << 64))
    if mant_field >= 1 << 64:
        mant_field >>= 1
        exp_field += 1
    return struct.pack(">HQ", sign | exp_field, mant_field)


def write_aiff(path: str, channels, sample_rate: float, bit_depth: int) -> None:
    codes = _quantize(channels, bit_depth)
    nframes, nch = codes.shape
    payload = _pack_pcm(codes, bit_depth, big_endian=True)
    comm = struct.pack(">4sIHIH", b"COMM", 18, nch, nframes, bit_depth)
    comm += _float80(float(sample_rate))
    ssnd_hdr = struct.pack(">4sIII", b"SSND", len(payload) + 8, 0, 0)
    form_size = 4 + len(comm) + len(ssnd_hdr) + len(payload) + (len(payload) & 1)
    with open(path, "wb") as fh:
        fh.write(struct.pack(">4sI4s", b"FORM", form_size, b"AIFF"))
        fh.write(comm)
        fh.write(ssnd_hdr)
        fh.write(payload)
        if len(payload) & 1:
            fh.write(b"\x00")


def write_audio(path: str, channels, sample_rate: float, bit_depth: int) -> None:
    """Dispatch on extension like the reference's ftypeTable
    (cmd/main.cpp:224-239); the file's bytes are counted as write.bytes
    (utils.profiling)."""
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if bit_depth not in SUPPORTED_BIT_DEPTHS:
        raise AudioFormatError(
            f"Invalid bitdepth - valid bitdepths are: {SUPPORTED_BIT_DEPTHS}"
        )
    if ext == "wav":
        write_wav(path, channels, sample_rate, bit_depth)
    elif ext in ("aif", "aiff"):
        write_aiff(path, channels, sample_rate, bit_depth)
    else:
        raise AudioFormatError(
            f"Invalid output file extension - valid extensions are: "
            f"{SUPPORTED_EXTENSIONS}"
        )
    if profiling.counting():
        profiling.count("write.bytes", os.path.getsize(path))


def read_audio(path: str):
    """Minimal PCM reader for round-tripping in tests.

    Returns (channels (C, T) float64 in [-1, 1), sample_rate, bit_depth).
    """
    with open(path, "rb") as fh:
        blob = fh.read()
    magic = blob[:4]
    if magic == b"RIFF":
        return _read_wav(blob)
    if magic == b"FORM":
        return _read_aiff(blob)
    raise AudioFormatError("unrecognised audio container")


def _chunks(blob: bytes, offset: int, end: int, big_endian: bool):
    fmt = ">4sI" if big_endian else "<4sI"
    while offset + 8 <= end:
        cid, size = struct.unpack_from(fmt, blob, offset)
        yield cid, offset + 8, size
        offset += 8 + size + (size & 1)


def _decode_pcm(payload: bytes, nch: int, bit_depth: int, big_endian: bool):
    if bit_depth == 16:
        dt = ">i2" if big_endian else "<i2"
        flat = np.frombuffer(payload, dtype=dt).astype(np.float64)
    elif bit_depth == 24:
        raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            vals = (
                raw[:, 0].astype(np.int32) << 16
                | raw[:, 1].astype(np.int32) << 8
                | raw[:, 2].astype(np.int32)
            )
        else:
            vals = (
                raw[:, 2].astype(np.int32) << 16
                | raw[:, 1].astype(np.int32) << 8
                | raw[:, 0].astype(np.int32)
            )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        flat = vals.astype(np.float64)
    else:
        raise AudioFormatError(f"unsupported bit depth {bit_depth}")
    full = float(2 ** (bit_depth - 1))
    return (flat / full).reshape(-1, nch).T


def _read_wav(blob: bytes):
    nch = sr = bits = None
    data = None
    for cid, off, size in _chunks(blob, 12, len(blob), big_endian=False):
        if cid == b"fmt ":
            _, nch, sr, _, _, bits = struct.unpack_from("<HHIIHH", blob, off)
        elif cid == b"data":
            data = blob[off : off + size]
    if nch is None or data is None:
        raise AudioFormatError("malformed WAV")
    return _decode_pcm(data, nch, bits, big_endian=False), float(sr), bits


def _read_aiff(blob: bytes):
    nch = bits = None
    sr = 0.0
    data = None
    for cid, off, size in _chunks(blob, 12, len(blob), big_endian=True):
        if cid == b"COMM":
            nch, _, bits = struct.unpack_from(">HIH", blob, off)
            exp_sign, mant = struct.unpack_from(">HQ", blob, off + 8)
            exp = (exp_sign & 0x7FFF) - 16383
            sr = mant / float(1 << 63) * 2.0**exp
            if exp_sign & 0x8000:
                sr = -sr
        elif cid == b"SSND":
            data = blob[off + 8 : off + size]
    if nch is None or data is None:
        raise AudioFormatError("malformed AIFF")
    return _decode_pcm(data, nch, bits, big_endian=True), float(sr), bits
