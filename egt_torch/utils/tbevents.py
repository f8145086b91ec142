"""Dependency-free TensorBoard scalar event writer.

The port's own copy of `egt_tpu/utils/tbevents.py`: standard
`events.out.tfevents.*` files readable by TensorBoard, the Event protobuf and
TFRecord framing encoded by hand (the reference gets this through Keras
callbacks). Scalars only, which is all the training loop logs.

Wire format per record: uint64 length, masked crc32c(length), payload,
masked crc32c(payload). Event proto fields used: wall_time(1, double),
step(2, int64), file_version(3, string) / summary(5, message) with
Summary.Value{tag(1, string), simple_value(2, float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


class EventWriter:
    """Append-only scalar event file, TensorBoard-compatible."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.v2")
        self._f = open(os.path.join(log_dir, name), "ab")
        # the version header event TensorBoard expects
        self._write_event(_double_field(1, time.time())
                          + _bytes_field(3, b"brain.Event:2"))

    def _write_event(self, event: bytes):
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))

    def add_scalar(self, tag: str, value: float, step: int):
        val = (_bytes_field(1, tag.encode()) + _float_field(2, float(value)))
        summary = _bytes_field(1, val)
        event = (_double_field(1, time.time()) + _int64_field(2, int(step))
                 + _bytes_field(5, summary))
        self._write_event(event)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
