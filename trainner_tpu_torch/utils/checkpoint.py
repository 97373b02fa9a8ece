"""Loading the generator's weights: counterpart of
``trainner_tpu/utils/checkpoint.py::load_params:52``.

Two formats load:

* the flax msgpack ``.ckpt`` that the JAX trainer writes (``save_params``,
  ``flax.serialization.to_bytes``). msgpack is not a dependency of the port,
  so ``msgpack_restore`` decodes the subset that flax writes: maps, arrays,
  strings, binary, scalars, and flax's ndarray ext type (code 1, a msgpack
  triple of shape, dtype name and C-order bytes);
* a reference ESRGAN ``.pth`` in either key layout.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .torch_interop import load_esrgan_pth, params_from_jax

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    """bfloat16 bytes -> float32, exactly (bf16 is the top half of f32)."""
    u16 = np.frombuffer(raw, dtype="<u2")
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _ndarray(data: bytes) -> np.ndarray:
    (shape, dtype, buf), end = _decode(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes in a msgpack ndarray")
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        arr = _bf16_to_f32(buf)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype))
    return arr.reshape(tuple(shape)).copy()


# fixed-width headers: first byte -> (struct format, kind)
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"), 0xCA: (">f", "float"),
    0xCB: (">d", "float"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(b: bytes, i: int) -> Tuple[Any, int]:
    t = b[i]
    i += 1
    if t <= 0x7F:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if 0x80 <= t <= 0x8F:
        return _container("map", t & 0x0F, b, i)
    if 0x90 <= t <= 0x9F:
        return _container("array", t & 0x0F, b, i)
    if 0xA0 <= t <= 0xBF:
        n = t & 0x1F
        return b[i:i + n].decode(), i + n
    if t == 0xC0:
        return None, i
    if t in (0xC2, 0xC3):
        return t == 0xC3, i
    if t in _FIXEXT:
        return _ext(b[i], b[i + 1:i + 1 + _FIXEXT[t]]), i + 1 + _FIXEXT[t]
    if t not in _FIXED:
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")
    fmt, kind = _FIXED[t]
    (v,) = struct.unpack_from(fmt, b, i)
    i += struct.calcsize(fmt)
    if kind in ("int", "float"):
        return v, i
    if kind == "str":
        return b[i:i + v].decode(), i + v
    if kind == "bin":
        return bytes(b[i:i + v]), i + v
    if kind == "ext":
        return _ext(b[i], b[i + 1:i + 1 + v]), i + 1 + v
    return _container(kind, v, b, i)


def _container(kind: str, n: int, b: bytes, i: int) -> Tuple[Any, int]:
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _decode(b, i)
            out.append(v)
        return out, i
    d: Dict[Any, Any] = {}
    for _ in range(n):
        k, i = _decode(b, i)
        v, i = _decode(b, i)
        d[k] = v
    return d, i


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not supported")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts of numpy arrays (the
    counterpart of ``flax.serialization.msgpack_restore``)."""
    tree, end = _decode(memoryview(data).tobytes(), 0)
    if end != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    if _has_chunks(tree):
        raise NotImplementedError(
            "chunked msgpack arrays (leaves over 1 GiB) are not supported")
    return tree


def _has_chunks(node: Any) -> bool:
    if isinstance(node, dict):
        return "__msgpack_chunked_array__" in node or any(
            _has_chunks(v) for v in node.values())
    return False


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """One generator's weights -> the port's ``RRDBNet`` state_dict, from a
    flax ``.ckpt`` or a reference ``.pth``/``.pt``."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pth", ".pt"):
        return load_esrgan_pth(path)
    with open(path, "rb") as f:
        return params_from_jax(msgpack_restore(f.read()))
