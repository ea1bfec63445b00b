"""Read what `flax.serialization.to_bytes` writes for a parameter tree,
without flax or msgpack.

The JAX package saves weights with `flax.serialization.to_bytes`
(`rrtmil_tpu/train/checkpoint.py:38-46`): `msgpack.packb` of the tree as
nested maps, with flax's extension types for arrays.  This module decodes
that subset of msgpack (https://github.com/msgpack/msgpack/blob/master/
spec.md):

  * nil, booleans, integers (fixint, uint8-64, int8-64), float32 / 64,
    strings (fixstr, str8-32), binaries (bin8-32), arrays and maps;
  * ext types (fixext1-16, ext8-32), of which flax 0.12 defines three:
    1 an ndarray, 2 a native complex, 3 a numpy scalar.  An ndarray's (and
    a scalar's) payload is itself msgpack: the array [shape, dtype name,
    C-order bytes].  'bfloat16' comes back as its uint16 bits (numpy has no
    bfloat16), which convert.flax_to_torch views as torch.bfloat16.
  * flax's chunked arrays: an array over `MAX_CHUNK_SIZE` bytes is written
    as the map {'__msgpack_chunked_array__': True, 'shape': {'0': ...},
    'chunks': {'0': flat chunk, ...}}, joined here again.

`read(path)` returns the tree (dicts, numpy arrays, Python scalars);
`train/checkpoint.load_params` hands it to `convert.flax_to_torch`.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(_LEN[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(_LEN[b])
            return self.ext(self.unpack(">b"), n)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            return self.ext(self.unpack(">b"), n)
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(_LEN[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(_LEN[b]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_LEN[b]))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts "
                         f"no value")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            re, im = decode(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
        0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
        0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's `_ndarray_to_bytes`: msgpack [shape, dtype name, bytes]."""
    shape, name, raw = decode(payload)
    name = name.decode() if isinstance(name, bytes) else name
    dtype = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
    a = np.frombuffer(raw, dtype=dtype).reshape(tuple(shape))
    if name == "bfloat16":
        a = _Bf16(a)
    return a


class _Bf16(np.ndarray):
    """A uint16 array that holds bfloat16 bits (convert.flax_to_torch reads
    `bfloat16_bits` and makes a torch.bfloat16 tensor of it)."""

    bfloat16_bits = True

    def __new__(cls, bits: np.ndarray):
        return bits.view(cls)


def decode(data: bytes) -> Any:
    """One msgpack value, all of `data`."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         f"value")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        out = flat.reshape(shape)
        return _Bf16(out) if isinstance(chunks[0], _Bf16) else out
    return {k: _unchunk(v) for k, v in tree.items()}


def read(path: str) -> Any:
    """The tree in a file `flax.serialization.to_bytes` wrote: dicts,
    numpy arrays (bfloat16 as uint16 bits) and Python scalars."""
    with open(path, "rb") as f:
        return _unchunk(decode(f.read()))
