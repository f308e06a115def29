"""Experiment artifacts, read and written in the JAX package's formats:

    <artifacts_root>/<stage>/<experiment>/
        fold_idx_dict.json          # persisted CV split (written once)
        <experiment>.log
        fold_<k>/
            model_best.msgpack      # checkpoint (best val accuracy)
            model_last.msgpack      # + optimizer state and epoch, for resume
            model_<which>.spec.json # architecture descriptor
            training_log.json       # per-epoch history

Checkpoints are flax-msgpack pytrees: nested maps whose array leaves are
msgpack ext objects (code 1: ndarray; code 3: numpy scalar), each payload
itself a msgpack tuple ``(shape, dtype_name, bytes)``, and arrays above 1 GiB
split into flax's ``__msgpack_chunked_array__`` form. ``msgpack_restore``
reads and ``msgpack_serialize`` writes that subset in pure Python, so
neither needs ``msgpack`` nor ``flax``; trees are nested dicts of numpy
arrays in the JAX layouts (the models' ``params_to_jax`` make them).
``save_checkpoint`` writes the bytes ``flax.serialization.to_bytes`` writes
for the same bundle, so the JAX package's ``load_checkpoint_raw`` and its
resume read a port checkpoint.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

BEST = "best"
LAST = "last"

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


def msgpack_restore(data: bytes) -> Any:
    """flax-msgpack bytes -> nested dicts of numpy arrays / scalars."""
    r = _Reader(data, raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_in_place(out)


class _Writer:
    """msgpack encoder for the subset flax writes, with msgpack-python's
    choices (smallest int form, float64, str8 and bin types)."""

    def __init__(self):
        self.out = bytearray()

    def head(self, fix_base: int, fix_max: int, codes, n: int):
        if n <= fix_max:
            self.out.append(fix_base | n)
        elif n <= 0xFF and codes[0] is not None:
            self.out += struct.pack(">BB", codes[0], n)
        elif n <= 0xFFFF:
            self.out += struct.pack(">BH", codes[1], n)
        else:
            self.out += struct.pack(">BI", codes[2], n)

    def int_(self, v: int):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
                 (0xCF, ">Q", 0, 2**64 - 1)) if v > 0 else \
                ((0xD0, ">b", -128, 127), (0xD1, ">h", -2**15, 2**15 - 1),
                 (0xD2, ">i", -2**31, 2**31 - 1), (0xD3, ">q", -2**63, 2**63 - 1))
        for code, fmt, lo, hi in forms:
            if lo <= v <= hi:
                self.out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")

    def ext(self, code: int, data: bytes):
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        n = len(data)
        if n in fixed:
            self.out += struct.pack(">Bb", fixed[n], code)
        else:
            self.out += struct.pack(">B", 0xC7 if n <= 0xFF else 0xC8 if n <= 0xFFFF else 0xC9)
            self.out += struct.pack(">B" if n <= 0xFF else ">H" if n <= 0xFFFF else ">I", n)
            self.out += struct.pack(">b", code)
        self.out += data

    def value(self, v: Any):  # noqa: C901 - one branch per msgpack type
        if v is None:
            self.out.append(0xC0)
        elif v is True or v is False:
            self.out.append(0xC3 if v else 0xC2)
        elif type(v) is int:
            self.int_(v)
        elif type(v) is float:
            self.out += struct.pack(">Bd", 0xCB, v)
        elif type(v) is str:
            b = v.encode("utf-8")
            self.head(0xA0, 0x1F, (0xD9, 0xDA, 0xDB), len(b))
            self.out += b
        elif type(v) is bytes:
            self.head(0, -1, (0xC4, 0xC5, 0xC6), len(v))
            self.out += v
        elif type(v) in (list, tuple):
            self.head(0x90, 0x0F, (None, 0xDC, 0xDD), len(v))
            for x in v:
                self.value(x)
        elif type(v) is dict:
            self.head(0x80, 0x0F, (None, 0xDE, 0xDF), len(v))
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        else:
            raise TypeError(f"cannot serialize {type(v).__name__}")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    w = _Writer()
    w.value((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))
    return bytes(w.out)


_MAX_CHUNK_BYTES = 2**30  # flax's MAX_CHUNK_SIZE


def _chunked(arr: np.ndarray) -> Dict:
    step = max(1, _MAX_CHUNK_BYTES // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i : i + step]
                       for j, i in enumerate(range(0, flat.size, step))}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK_BYTES:
        return _chunked(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dicts of numpy arrays / scalars -> flax-msgpack bytes, as
    ``flax.serialization.msgpack_serialize(tree, in_place=True)`` writes them
    (dict order as given)."""
    w = _Writer()
    w.value(_chunk_leaves(tree))
    return bytes(w.out)


def _sorted_tree(tree):
    """Dicts with their keys sorted at every level, leaves as numpy: the tree
    ``jax.device_get`` gives the JAX package's writer."""
    if isinstance(tree, dict):
        return {str(k): _sorted_tree(tree[k]) for k in sorted(tree, key=str)}
    return np.asarray(tree)


def save_checkpoint(
    fold_dir: str,
    which: str,
    params: Any,
    state: Any = None,
    spec: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    opt: Optional[Dict[str, Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Serialize ``{'params', 'state'[, 'opt', 'meta']}`` to msgpack + spec JSON.

    ``params``/``state`` are nested dicts of numpy arrays in the JAX layout;
    ``opt`` is ``{"step", "mu", "nu"}`` (AdamW's count and moments, in the
    params' layout) and ``meta`` holds ``epoch`` and ``best_acc``: what the
    JAX package's resume reads."""
    os.makedirs(fold_dir, exist_ok=True)
    bundle = {"params": _sorted_tree(params),
              "state": _sorted_tree(state) if state is not None else {}}
    if opt is not None:
        bundle["opt"] = {"step": np.asarray(opt["step"]), "mu": _sorted_tree(opt["mu"]),
                         "nu": _sorted_tree(opt["nu"])}
    if meta is not None:
        bundle["meta"] = {k: np.asarray(v) for k, v in meta.items()}
    path = _ckpt_path(fold_dir, which)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(bundle))
    if spec is not None:
        spec_dict = spec.to_dict() if hasattr(spec, "to_dict") else dict(spec)
        if extra:
            spec_dict = {**spec_dict, "__extra__": extra}
        with open(_spec_path(fold_dir, which), "w") as f:
            json.dump(spec_dict, f, indent=2, default=_json_default)
    return path


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def checkpoint_exists(fold_dir: str, which: str) -> bool:
    return os.path.exists(_ckpt_path(fold_dir, which))


def save_fold_split(output_dir: str, fold_idx_dict: Dict) -> str:
    path = os.path.join(output_dir, "fold_idx_dict.json")
    clean = {str(k): {s: [int(i) for i in idx] for s, idx in v.items()}
             for k, v in fold_idx_dict.items()}
    with open(path, "w") as f:
        json.dump(clean, f)
    return path


def load_fold_split(output_dir: str) -> Optional[Dict[int, Dict[str, list]]]:
    path = os.path.join(output_dir, "fold_idx_dict.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def save_training_log(fold_dir: str, history: Dict[str, list]) -> str:
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir, "training_log.json")
    with open(path, "w") as f:
        json.dump(history, f, indent=2, default=_json_default)
    return path


def load_training_log(fold_dir: str) -> Optional[Dict[str, list]]:
    path = os.path.join(fold_dir, "training_log.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _ckpt_path(fold_dir: str, which: str) -> str:
    return os.path.join(fold_dir, f"model_{which}.msgpack")


def _spec_path(fold_dir: str, which: str) -> str:
    return os.path.join(fold_dir, f"model_{which}.spec.json")


def load_spec_dict(fold_dir: str, which: str = BEST) -> Optional[Dict[str, Any]]:
    path = _spec_path(fold_dir, which)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_checkpoint_raw(fold_dir: str, which: str) -> Dict[str, Any]:
    """Deserialize ``model_<which>.msgpack`` without a template."""
    with open(_ckpt_path(fold_dir, which), "rb") as f:
        return msgpack_restore(f.read())
