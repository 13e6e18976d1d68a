"""Dependency-free TensorBoard event-file writer.

A copy of ``pigan_thz_tpu/utils/tensorboard.py`` (pure Python, no JAX).

The reference Logger constructs a `torch.utils.tensorboard.SummaryWriter`
unconditionally (`core/utils/logger.py:5,47`) and logs scalars into
timestamped run dirs.  This module provides the same capability with ZERO
dependencies (no torch, no tensorboard package): a tfevents file is just a
TFRecord stream of serialized `tensorflow.Event` protos, and the two
messages scalar logging needs (Event{wall_time, step, file_version|summary}
and Summary{Value{tag, simple_value}}) are small enough to hand-encode.

Format (readable by any stock TensorBoard):
- records: uint64 LE length, uint32 LE masked-crc32c(length bytes),
  payload, uint32 LE masked-crc32c(payload);
- masked crc: ((crc32c >> 15) | (crc32c << 17)) + 0xa282ead8 (mod 2^32)
  with the Castagnoli polynomial;
- first record is an Event carrying file_version "brain.Event:2".

`TfEventsWriter.add_scalar` mirrors SummaryWriter.add_scalar's tag/value/
step contract; files are named `events.out.tfevents.<ts>.<host>` like the
original so TensorBoard's run discovery picks them up.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _string(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _zigzag_int64(n: int) -> int:
    # Event.step is int64 (plain varint, two's complement for negatives)
    return n & 0xFFFFFFFFFFFFFFFF


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _tag(1, 1) + struct.pack("<d", wall_time)          # wall_time
    if step is not None:
        msg += _tag(2, 0) + _varint(_zigzag_int64(int(step)))  # step
    if file_version is not None:
        msg += _string(3, file_version.encode())
    if summary is not None:
        msg += _string(5, summary)                            # Summary
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = (
        _string(1, tag.encode())                              # Value.tag
        + _tag(2, 5) + struct.pack("<f", float(value))        # simple_value
    )
    return _string(1, val)                                    # Summary.value


class TfEventsWriter:
    """Append-only scalar event writer, one file per instance.

    Thread-safe; flushes on every `flush()` and on `close()`.  Use exactly
    like the torch SummaryWriter for scalars:

        w = TfEventsWriter(logdir)
        w.add_scalar("loss/train", 0.12, step=3)
        w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "local"
        fname = f"events.out.tfevents.{int(time.time())}.{host}{filename_suffix}"
        self.path = os.path.join(logdir, fname)
        self._fh = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        rec = (
            header
            + struct.pack("<I", _masked_crc(header))
            + payload
            + struct.pack("<I", _masked_crc(payload))
        )
        with self._lock:
            self._fh.write(rec)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _event(time.time(), step=step, summary=_scalar_summary(tag, value))
        )

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


def read_scalar_events(path: str, strict: bool = False):
    """Decode (tag, value, step) scalar tuples from a tfevents file.

    Test/debug utility (a minimal TFRecord+proto reader, the writer's
    inverse); skips the file_version record and non-scalar events.

    A killed writer can leave a HALF-WRITTEN final record — exactly the
    files the kill-on-timeout supervisors produce — so by default a
    truncated or crc-corrupt tail ends the stream gracefully (every
    complete record before it is returned), matching TensorBoard's own
    reader behaviour.  ``strict=True`` raises instead."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        end = off + 12 + length + 4
        if end > len(data):
            if strict:
                raise ValueError(f"truncated record at offset {off}")
            break
        payload = data[off + 12: off + 12 + length]
        expect = struct.unpack_from("<I", data, off + 8)[0]
        if _masked_crc(data[off: off + 8]) != expect:
            if strict:
                raise ValueError(f"corrupt length crc at offset {off}")
            break
        if _masked_crc(payload) != struct.unpack_from(
            "<I", data, off + 12 + length
        )[0]:
            if strict:
                raise ValueError(f"corrupt payload crc at offset {off}")
            break
        out.extend(_decode_event(payload))
        off = end
    return out


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[off]
        n |= (b & 0x7F) << shift
        off += 1
        if not b & 0x80:
            return n, off
        shift += 7


def _decode_event(buf: bytes):
    step = 0
    summaries = []
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
            if field == 2:
                step = v
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            if field == 5:
                summaries.append(buf[off: off + ln])
            off += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
    out = []
    for s in summaries:
        off = 0
        while off < len(s):
            key, off = _read_varint(s, off)
            if key >> 3 == 1 and key & 7 == 2:
                ln, off = _read_varint(s, off)
                out.append(_decode_value(s[off: off + ln], step))
                off += ln
            else:
                break
    return [o for o in out if o is not None]


def _decode_value(buf: bytes, step: int):
    tag, value = None, None
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, off = _read_varint(buf, off)
            if field == 1:
                tag = buf[off: off + ln].decode()
            off += ln
        elif wire == 5:
            if field == 2:
                (value,) = struct.unpack_from("<f", buf, off)
            off += 4
        elif wire == 0:
            _, off = _read_varint(buf, off)
        elif wire == 1:
            off += 8
    if tag is None or value is None:
        return None
    return (tag, value, step)
