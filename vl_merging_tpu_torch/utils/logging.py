"""Small runtime utilities: seeding, config printing, and a TensorBoard
event-file writer in plain Python.

``EventWriter`` writes the scalar events that ``torch.utils.tensorboard``'s
``SummaryWriter.add_scalar`` writes, without importing ``tensorboard``,
``tensorflow`` or ``torch.utils.tensorboard`` (the last imports TensorFlow
where it is installed, and TensorFlow imports JAX).  The file is a
sequence of TFRecords: a little-endian u64 length, the masked CRC-32C of
those 8 bytes, the bytes, their masked CRC-32C.  Each record is an
``Event`` protobuf encoded by hand: ``wall_time`` (field 1, double),
``step`` (2, varint), ``file_version`` (3, "brain.Event:2", the first
record only) and ``summary`` (5), whose ``Value``s carry ``tag`` (1) and
``simple_value`` (2, float).
"""

from __future__ import annotations

import itertools
import os
import random
import socket
import struct
import time

import numpy as np


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def print_config(cfg: dict) -> None:
    import json

    def default(o):
        return str(o)

    print(json.dumps(cfg, indent=2, default=default))


def _crc32c_table() -> tuple:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    c = 0xFFFFFFFF
    for byte in data:
        c = _CRC32C[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the bytes, their masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1   # int64 fields: negatives as two's complement
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, *,
                 file_version: str = None, scalars: dict = None) -> bytes:
    """An ``Event`` message: its wall time and step, and either the file
    version or a ``Summary`` of ``{tag: simple_value}``."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version is not None:
        out += _field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field(1, _field(1, tag.encode()) + _varint(2 << 3 | 5)
                   + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _field(5, summary)
    return out


class EventWriter:
    """Scalars to ``{log_dir}/events.out.tfevents.{time}.{host}.{pid}.{n}``,
    one event per scalar as ``SummaryWriter.add_scalar`` writes them."""

    _count = itertools.count()

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
                     f".{os.getpid()}.{next(self._count)}")
        self._fh = open(self.path, "wb")
        self._fh.write(tfrecord(encode_event(now,
                                             file_version="brain.Event:2")))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(tfrecord(encode_event(time.time(), step,
                                             scalars={tag: float(value)})))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
