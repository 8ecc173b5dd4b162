"""The protobuf wire format, write side: the few encoders that the ONNX,
SavedModel and TensorBundle writers build their messages from (no protobuf
package needed). A message is the concatenation of its fields' encodings."""

from __future__ import annotations

import struct


def varint(n: int) -> bytes:
    """Base-128 varint; a negative int64 as its two's complement, 10 bytes."""
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


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def f_int(field: int, v: int) -> bytes:
    return tag(field, 0) + varint(int(v))


def f_bytes(field: int, v: bytes) -> bytes:
    return tag(field, 2) + varint(len(v)) + v


def f_str(field: int, v: str) -> bytes:
    return f_bytes(field, v.encode())


def f_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", float(v))


def f_fixed32(field: int, v: int) -> bytes:
    return tag(field, 5) + struct.pack("<I", v)


def f_map(field: int, items, value_field) -> bytes:
    """A map<string, V> field: one entry message (key 1, value 2) an item,
    `value_field(2, value)` encoding each value."""
    return b"".join(f_bytes(field, f_str(1, k) + value_field(2, v)) for k, v in items)
