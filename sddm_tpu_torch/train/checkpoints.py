"""Read-only loader of the JAX package's checkpoints (counterpart of
``sddm_tpu/train/checkpoints.py::load_checkpoint``).

A checkpoint is one msgpack document written by
``flax.serialization.msgpack_serialize``: a map with ``arch``,
``config_json``, ``epoch``, ``monitor_best``, ``opt_state`` and ``params``.
Arrays are msgpack ext type 1, whose payload is itself a packed
``(shape, dtype_name, raw C-order bytes)``; numpy scalars are ext type 3 with
the same payload.  This module decodes that subset of msgpack in pure Python
so that the port needs neither flax nor msgpack.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder of the msgpack types flax checkpoints use: nil, bool, ints,
    floats, str, bin, arrays, maps and ext types 1 and 3."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # tag -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "ext":
                return self._ext(n)
            return {"str": self._str, "array": self._array, "map": self._map}[kind](n)
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self._unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unsupported msgpack tag 0x{b:02x} at byte {self.pos - 1}")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        shape, dtype_name, raw = inner.read()
        if inner.pos != len(payload):
            raise ValueError("malformed ndarray payload")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def msgpack_restore(data: bytes):
    """Decode one flax msgpack document into dicts, lists and numpy arrays."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def load_checkpoint(path, with_opt_state: bool = False) -> dict:
    """``{"arch", "epoch", "monitor_best", "config", "params"}`` (and
    ``"opt_state"`` when asked) from a JAX checkpoint file; arrays are numpy."""
    raw = msgpack_restore(Path(path).read_bytes())
    out = {
        "arch": raw["arch"],
        "epoch": int(raw["epoch"]),
        "monitor_best": float(raw["monitor_best"]),
        "config": json.loads(raw.get("config_json", "{}")),
        "params": raw["params"],
    }
    if with_opt_state:
        out["opt_state"] = raw["opt_state"]
    return out
