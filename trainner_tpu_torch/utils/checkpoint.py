"""Checkpoints in the JAX package's own format: counterpart of
``trainner_tpu/utils/checkpoint.py`` (``_backup:36``, ``save_params:43``,
``load_params:52``, ``save_state:96``, ``load_state:112``,
``_state_iter:124``, ``latest_state_path:140``, ``save_checkpoint:161``).

* ``{tag}_G.ckpt``, ``{tag}_D.ckpt``, ``{tag}_emaG.ckpt``,
  ``{tag}_swaG.ckpt``: one network's flax param tree (for D its ``params``
  alone, as the JAX trainer saves it; the EMA and SWA weights in G's tree,
  the SWA one wrapped with its refreshed ``batch_stats`` when G has batch
  norms), as
  ``flax.serialization.to_bytes`` writes it;
* ``{tag}_G_A.ckpt``, ``{tag}_G_B.ckpt``, ``{tag}_D_A.ckpt``,
  ``{tag}_D_B.ckpt`` in place of those for a CycleGAN state, and
  ``{tag}_G.ckpt``, ``{tag}_D_S.ckpt``, ``{tag}_D_T.ckpt`` for a WBC
  state;
* ``{tag}.state``: the whole training state as the JAX ``SRTrainState``'s
  state dict (``utils/torch_interop.py::train_state_to_jax``; a net's
  ``batch_stats``, G's running statistics among them, in its ``extra``),
  beside a
  JSON sidecar ``{tag}.state.json`` with ``{epoch, iter}``. The port adds
  the state of its latent-noise generator to the sidecar
  (``noise_generator``), where the JAX reader ignores it; the msgpack tree
  holds only what flax's ``from_bytes`` accepts on a JAX template.

msgpack is not a dependency of the port, so ``msgpack_serialize`` and
``msgpack_restore`` write and read the subset that flax uses: maps,
arrays, strings, binary, nil, booleans, numbers, and flax's ndarray ext
type (code 1, a msgpack triple of shape, dtype name and C-order bytes; code
3 for a numpy scalar). A reference ESRGAN ``.pth`` loads too. The orbax
backend of the JAX package is not ported (ROADMAP Queue A 8.3).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .torch_interop import (cyclegan_state_from_jax, g_from_jax,
                            load_esrgan_pth, load_train_state,
                            rrdbnet_like, srresnet_to_params,
                            train_state_from_state_dict, train_state_to_jax)

CKPT_EXT = ".ckpt"
STATE_EXT = ".state"
_MAX_CHUNK = 2 ** 30  # flax splits larger arrays, which this writer refuses

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


def load_tree(path: str) -> Any:
    """A ``.ckpt`` or ``.state`` file -> its tree of nested dicts and
    numpy leaves, as the JAX ``load_params`` without a template gives
    it."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), the dicts' keys in sorted order, as ``jax.tree.map``
    visits a tree of dicts; returns the tree of results."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("the trees differ in structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def load_params(path: str, net: Optional[torch.nn.Module] = None
                ) -> Dict[str, torch.Tensor]:
    """One generator's weights -> the state_dict of the port's ``net``
    (its parameters; a ``.ckpt`` holds no running statistics), from a flax
    ``.ckpt`` or a reference ``.pth``/``.pt`` (an ESRGAN layout, or for an
    ``SRResNet`` its Sequential layout). Without ``net``, a plain
    ``RRDBNet``'s."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pth", ".pt"):
        if type(net).__name__ == "SRResNet":
            sd = torch.load(path, map_location="cpu", weights_only=True)
            for wrapper in ("state_dict", "params"):
                if isinstance(sd, dict) and isinstance(sd.get(wrapper),
                                                       dict):
                    sd = sd[wrapper]
            return g_from_jax(srresnet_to_params(
                {k: v for k, v in sd.items()
                 if isinstance(v, torch.Tensor)}), None, net)
        return load_esrgan_pth(path)
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return g_from_jax(tree, None, rrdbnet_like(tree) if net is None
                      else net)


# ---------------------------------------------------------------------------
# writing: the encoder that pairs with msgpack_restore
# ---------------------------------------------------------------------------


def _pack_len(n: int, fix_base: Optional[int], fix_max: int,
              codes: Tuple[int, int, int]) -> bytes:
    """The header of a sized msgpack object: the fix form when it fits,
    else the 8-, 16- or 32-bit length form (``codes``; 0 where the family
    has no 8-bit form)."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    if codes[0] and n <= 0xFF:
        return bytes([codes[0], n])
    if n <= 0xFFFF:
        return bytes([codes[1]]) + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return bytes([codes[2]]) + struct.pack(">I", n)
    raise ValueError("msgpack object too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext_head(code: int, n: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    head = bytes([fix]) if fix else _pack_len(n, None, -1,
                                              (0xC7, 0xC8, 0xC9))
    return head + bytes([code])


def _pack_ndarray(code: int, arr: np.ndarray, out: List) -> None:
    """An array as flax's ext type: the triple (shape, dtype name, C-order
    bytes), its buffer appended as a view, not copied."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    if arr.nbytes > _MAX_CHUNK:
        raise NotImplementedError(
            "arrays over 1 GiB are written in chunks by flax; not supported")
    head: List = []
    _pack([list(arr.shape), arr.dtype.name], head)
    head[0] = b"\x93"  # a triple: the two items above and the bytes
    head.append(_pack_len(arr.nbytes, None, -1, (0xC4, 0xC5, 0xC6)))
    inner = b"".join(head)
    out.append(_ext_head(code, len(inner) + arr.nbytes) + inner)
    out.append(memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B"))


def _pack(obj: Any, out: List) -> None:
    """Appends the msgpack encoding of ``obj`` to ``out`` as chunks."""
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        # in key order, as flax writes a tree that JAX has flattened
        out.append(_pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"{type(obj).__name__} does not serialize to msgpack")


def _chunks(tree: Any) -> List:
    out: List = []
    _pack(tree, out)
    return out


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dicts, lists, strings, numbers, None and numpy arrays ->
    msgpack bytes as ``flax.serialization.msgpack_serialize`` writes them
    (``to_bytes`` of a state dict), byte for byte: maps in key order,
    arrays and numpy scalars as flax's ext types 1 and 3."""
    return b"".join(_chunks(tree))


# ---------------------------------------------------------------------------
# the checkpoint files
# ---------------------------------------------------------------------------


def _backup(path: str) -> None:
    """Keeps a ``previous_*`` copy of a file that is about to be
    overwritten."""
    if os.path.exists(path):
        d, b = os.path.split(path)
        shutil.copy2(path, os.path.join(d, "previous_" + b))


def _write(path: str, tree: Any, backup: bool) -> None:
    """``tree`` msgpack-encoded into ``path``, chunk by chunk (the arrays'
    buffers are written as they lie, not joined first)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if backup and os.path.exists(path):
        _backup(path)
    with open(path, "wb") as f:
        f.writelines(_chunks(tree))


def save_params(tree: Any, path: str, backup: bool = True) -> None:
    """One network's flax param tree (numpy leaves; ``params_to_jax`` of a
    G, ``discriminator_to_jax(...)[0]`` of a D) -> ``path``."""
    _write(path, tree, backup)


def _generator_meta(gen: Optional[torch.Generator]) -> Optional[dict]:
    if gen is None:
        return None
    return {"device": gen.device.type,
            "state": gen.get_state().cpu().numpy().tobytes().hex()}


def save_state(state, path: str, epoch: int = 0,
               backup: bool = True, write: bool = True) -> None:
    """The whole training state -> ``path`` (the JAX ``SRTrainState``'s
    state dict) and ``path + ".json"`` (``{epoch, iter}``, and the port's
    ``noise_generator``). Under a mesh every rank calls it (an optimizer
    split over the fsdp axis is put together first) and the one with
    ``write`` writes."""
    tree = train_state_to_jax(state)
    if write:
        _write_state(tree, state, path, epoch, backup)


def _write_state(tree: Any, state, path: str, epoch: int,
                 backup: bool) -> None:
    _write(path, tree, backup)
    meta = {"epoch": int(epoch), "iter": int(state.step)}
    noise = _generator_meta(state.noise_generator)
    if noise is not None:
        meta["noise_generator"] = noise
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_state(path: str, state) -> Tuple[Any, dict]:
    """A ``.state`` file (the JAX package's or the port's) -> into
    ``state``, in place; returns ``(state, meta)``. The latent-noise
    generator takes the sidecar's saved state where the port wrote one on
    the same kind of device, else the seed of the file's ``rng``
    (``key_to_seed``)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if hasattr(state, "D_FIELDS"):
        carried = cyclegan_state_from_jax(tree, state)
    else:
        carried = train_state_from_state_dict(
            tree, state.g.net, state.d.net if state.d is not None else None)
    load_train_state(state, carried)
    meta = {"epoch": 0, "iter": int(state.step)}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    noise = meta.get("noise_generator")
    gen = state.noise_generator
    if gen is not None and noise and noise.get("device") == gen.device.type:
        raw = np.frombuffer(bytes.fromhex(noise["state"]), np.uint8)
        gen.set_state(torch.from_numpy(raw.copy()))
    return state, meta


def _state_iter(state_dir: str, fname: str) -> int:
    """The iteration a ``.state`` file holds: from its numeric stem, else
    from its sidecar (``latest.state``), else -1."""
    stem = fname[: -len(STATE_EXT)]
    if stem.isdigit():
        return int(stem)
    sidecar = os.path.join(state_dir, fname + ".json")
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                return int(json.load(f).get("iter", -1))
        except (ValueError, OSError, json.JSONDecodeError):
            return -1
    return -1


def latest_state_path(state_dir: str) -> Optional[str]:
    """The newest ``.state`` file of a directory, by the iteration each
    holds (not by name, which would rank the ``previous_*`` backups first);
    the backups are skipped, and among equal iterations the most recently
    modified file wins."""
    if not os.path.isdir(state_dir):
        return None
    states: List[str] = [f for f in os.listdir(state_dir)
                         if f.endswith(STATE_EXT)
                         and not f.startswith("previous_")]
    if not states:
        return None
    best = max(states, key=lambda f: (
        _state_iter(state_dir, f),
        os.path.getmtime(os.path.join(state_dir, f))))
    return os.path.join(state_dir, best)


def save_checkpoint(state, opt: dict, epoch: int, niter: int,
                    latest_only: bool = False,
                    swa_extra: Optional[dict] = None,
                    write: bool = True) -> None:
    """``{tag}_G.ckpt``, ``{tag}_D.ckpt`` (when there is a D),
    ``{tag}_swaG.ckpt`` (when there are SWA weights: their param tree, or
    ``{"params": ..., **swa_extra}`` with the batch-norm statistics
    refreshed for them) and ``{tag}_emaG.ckpt`` (when there are EMA
    weights) under ``path.models`` and ``{tag}.state`` under
    ``path.training_state``; ``tag`` is the iteration, or ``latest``.
    A CycleGAN state writes ``{tag}_G_A.ckpt``, ``{tag}_G_B.ckpt``,
    ``{tag}_D_A.ckpt`` and ``{tag}_D_B.ckpt`` instead of G's and D's
    files, a WBC state ``{tag}_G.ckpt``, ``{tag}_D_S.ckpt`` and
    ``{tag}_D_T.ckpt`` (the names of each state's ``named_params``; JAX
    ``utils/checkpoint.py:175-181``). Under a mesh every rank calls it
    (``save_state``) and the one with ``write`` writes."""
    model_dir = opt["path"]["models"]
    state_dir = opt["path"]["training_state"]
    tag = "latest" if latest_only else str(niter)
    tree = train_state_to_jax(state)
    if not write:
        return
    if hasattr(state, "D_FIELDS"):
        # one file per net, as the JAX package writes them
        g = tree["g"]["params"]
        nets = [(n, g[n]) for n in ("G_A", "G_B")] \
            if isinstance(state.g.net, torch.nn.ModuleDict) else [("G", g)]
        nets += [("D_" + w[2:].upper(), (tree[w] or {}).get("params"))
                 for w in state.D_FIELDS]
        for name, params in nets:
            if params is not None:
                save_params(params, os.path.join(
                    model_dir, f"{tag}_{name}{CKPT_EXT}"))
        _write_state(tree, state, os.path.join(
            state_dir, f"{tag}{STATE_EXT}"), epoch, backup=True)
        return
    save_params(tree["g"]["params"],
                os.path.join(model_dir, f"{tag}_G{CKPT_EXT}"))
    if tree["d"] is not None:
        save_params(tree["d"]["params"],
                    os.path.join(model_dir, f"{tag}_D{CKPT_EXT}"))
    if tree["swa_params"] is not None:
        swa_tree = tree["swa_params"]
        if swa_extra:
            swa_tree = {"params": swa_tree, **swa_extra}
        save_params(swa_tree,
                    os.path.join(model_dir, f"{tag}_swaG{CKPT_EXT}"))
    if tree["ema_params"] is not None:
        save_params(tree["ema_params"],
                    os.path.join(model_dir, f"{tag}_emaG{CKPT_EXT}"))
    _write_state(tree, state, os.path.join(state_dir, f"{tag}{STATE_EXT}"),
                 epoch, backup=True)
