"""A reader of flax-msgpack checkpoints, kept with the benchmark so that the
references read the frozen artifacts without the program under test.

Checkpoints are nested maps whose array leaves are msgpack ext objects
(code 1: ndarray; code 3: numpy scalar), each payload itself a msgpack tuple
``(shape, dtype_name, bytes)``; arrays above 1 GiB are split into flax's
``__msgpack_chunked_array__`` form. bfloat16 leaves, which numpy cannot hold,
become CPU torch tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw  # keep str as bytes (flax's ndarray payloads)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buffer = _Reader(data, raw=True).value()
        if dtype_name == b"bfloat16":
            t = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
            return t if code == _EXT_NDARRAY else t.reshape(())
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def value(self) -> Any:  # noqa: C901 - one branch per msgpack type byte
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self.ext(self.unpack(">b"), n)
        if t == 0xCA:
            return self.unpack(">f")
        if t == 0xCB:
            return self.unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[t - 0xCC])
        if 0xD4 <= t <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _unchunk_in_place(d):
    if isinstance(d, dict):
        for k, v in d.items():
            if isinstance(v, dict):
                if "__msgpack_chunked_array__" in v:
                    shape = tuple(v["shape"][str(i)] for i in range(len(v["shape"])))
                    chunks = [v["chunks"][str(i)] for i in range(len(v["chunks"]))]
                    d[k] = np.concatenate(chunks).reshape(shape)
                else:
                    _unchunk_in_place(v)
    return d


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A flax-msgpack file -> nested dicts of numpy arrays and scalars."""
    with open(path, "rb") as f:
        r = _Reader(f.read(), raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_in_place(out)
