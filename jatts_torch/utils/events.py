"""Scalar event files that TensorBoard reads, written without it.

The trainer logs its scalars here as the JAX trainer logs them through
tensorboardX's ``SummaryWriter(outdir).add_scalar``: one file
``events.out.tfevents.<time>.<host>`` in ``outdir``. The format is
TFRecord framing (a little-endian uint64 length, its masked CRC-32C, the
payload, the payload's masked CRC-32C) around ``tensorflow.Event``
messages: the first holds ``file_version`` "brain.Event:2", each later one
a ``wall_time``, a ``step`` and a ``Summary`` of one ``simple_value`` under
its ``tag``. The few protobuf fields are encoded by hand.

:func:`read_scalars` reads such a file back, checking every CRC, so a run
can be inspected where TensorBoard is not installed:
``python -m jatts_torch.utils.events <outdir or file>`` prints
``step tag value`` lines.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import sys
import time
from typing import Dict, Iterator, List, Tuple

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, tag: str = None, value: float = None,
                 file_version: str = None) -> bytes:
    """A ``tensorflow.Event``: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) of one value: tag (1, string),
    simple_value (2, float)."""
    msg = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        msg += _field(2, 0) + _varint(int(step))
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if tag is not None:
        val = _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", float(value))
        msg += _bytes_field(5, _bytes_field(1, val))
    return msg


def frame(payload: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, payload, masked CRC."""
    header = struct.pack("<Q", len(payload))
    return header + struct.pack("<I", masked_crc32c(header)) + payload + struct.pack("<I", masked_crc32c(payload))


class EventWriter:
    """``add_scalar(tag, value, step)`` into an event file in ``logdir``,
    flushed after every scalar (a run read while it trains sees every
    logged step)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        self._f.write(frame(payload))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step, tag, value))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(number, wire type, value) of each field of a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, v


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, every CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        payload = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(payload) != n or crc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {i}")
        yield payload
        i += 16 + n


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """``(step, tag, simple_value)`` of every scalar in an event file (or in
    the event files of a directory), in the order written."""
    paths = sorted(glob.glob(os.path.join(path, "events.out.tfevents.*"))) if os.path.isdir(path) else [path]
    out: List[Tuple[int, str, float]] = []
    for p in paths:
        for payload in read_records(p):
            step = 0
            for number, _, v in _fields(payload):
                if number == 2:
                    step = v
                elif number == 5:
                    for vn, _, value in _fields(v):
                        if vn != 1:
                            continue
                        f: Dict[int, object] = {n: x for n, _, x in _fields(value)}
                        if 1 in f and 2 in f:
                            out.append((step, f[1].decode(), struct.unpack("<f", f[2])[0]))
    return out


if __name__ == "__main__":
    for step, tag, value in read_scalars(sys.argv[1]):
        print(step, tag, repr(value))
