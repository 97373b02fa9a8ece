"""Host-side image IO, tensor conversion and the paired crop and flip.

Counterpart of ``trainner_tpu/data/common.py`` (``_lmdb_reader:36``,
``scan_images:44``, ``read_img:60``, ``rgb2ycbcr:116``, ``ycbcr2rgb:128``,
``channel_convert:137``, ``augment_pair:155``, ``paired_random_crop:178``,
``img2tensor:202``, ``tensor2img:218``, ``save_img:232``). Host images are
numpy HWC float32 RGB in [0, 1]. ``encode_png`` and ``save_img`` write and
``decode_png`` / ``read_png`` read 8-bit PNG with the standard library
(``zlib``, ``struct``); ``read_img`` decodes with ``cv2`` where it is
installed (imported only when called) and with ``decode_png`` where it is
not. A ``*.lmdb`` dataroot lists virtual paths ``<root>::<key>``, whose
values ``read_img`` reads through ``data/lmdb_io.py``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
                  ".webp")


def is_image_file(path: str) -> bool:
    return path.lower().endswith(IMG_EXTENSIONS)


_LMDB_READERS: dict = {}


def _lmdb_reader(root: str):
    """One ``LmdbReader`` per root, kept for the process."""
    if root not in _LMDB_READERS:
        from .lmdb_io import LmdbReader

        _LMDB_READERS[root] = LmdbReader(root)
    return _LMDB_READERS[root]


def is_lmdb_path(path: str) -> bool:
    """A virtual path ``<root>.lmdb::<key>`` of an LMDB dataroot."""
    return "::" in path and ".lmdb" in path


def scan_images(root: str) -> List[str]:
    """Sorted recursive image listing; a ``*.lmdb`` root lists
    ``<root>::<key>`` for each key of ``lmdb_io.lmdb_paths``."""
    if str(root).endswith(".lmdb"):
        from .lmdb_io import lmdb_paths

        return [f"{root}::{k}" for k in lmdb_paths(root)]
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if is_image_file(f):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Undoes the Paeth filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def read_png(path: str) -> np.ndarray:
    """8-bit PNG file -> uint8 array (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """8-bit PNG bytes -> uint8 array, HW for gray, HWC in RGB(A) order
    otherwise. Reads gray, RGB and RGBA, non-interlaced, with all five
    row filters; anything else raises. Rows filtered with Average or Paeth
    (as OpenCV's encoder writes them) are undone a byte at a time in
    Python, so such a file decodes far more slowly than one written by
    ``encode_png``'s default."""
    if data[:8] != _PNG_SIGNATURE:
        raise IOError(f"not a PNG file [{path}]")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise IOError(f"PNG without a header [{path}]")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(
            f"read_png reads 8-bit gray, RGB and RGBA without interlace; "
            f"[{path}] has depth {depth}, colour type {color}, interlace "
            f"{interlace} (install OpenCV for the rest)")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise IOError(f"PNG data of the wrong length [{path}]")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = rows[:, 0]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(filters[y]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ft == 3 else _paeth_row)(buf, prev.tobytes(),
                                                      bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise IOError(f"PNG row filter {ft} [{path}]")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def decode_image(path: str) -> np.ndarray:
    """Image file -> array as stored (uint8, or uint16 through OpenCV), HW
    or HWC in RGB(A) order. Without OpenCV only 8-bit PNG is read."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        if path.lower().endswith(".png"):
            return read_png(path)
        raise ImportError(f"reading [{path}] needs OpenCV: without it only "
                          "8-bit PNG files are read")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image [{path}]")
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[:, :, [2, 1, 0, 3]]
    elif img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    return img


def decode_image_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded image -> array as stored, HW or HWC in RGB(A) order:
    ``cv2.imdecode`` where OpenCV is installed, else ``decode_png`` (8-bit
    PNG only)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        if data[:8] == _PNG_SIGNATURE:
            return decode_png(data, name)
        raise ImportError(f"decoding [{name}] needs OpenCV: without it only "
                          "8-bit PNG is read")
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot decode image [{name}]")
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[:, :, [2, 1, 0, 3]]
    elif img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    return img


def read_lmdb_value(path: str) -> np.ndarray:
    """The decoded value of a virtual path ``<root>.lmdb::<key>``."""
    root, key = path.split("::", 1)
    buf = _lmdb_reader(root).get(key.encode("ascii"))
    if buf is None:
        raise IOError(f"lmdb key not found [{path}]")
    return decode_image_bytes(bytes(buf), path)


def read_img(path: str, out_nc: int = 3) -> np.ndarray:
    """Image file (or LMDB value) -> float32 RGB HWC in [0, 1]; an alpha
    channel is dropped. An LMDB value is divided by 255 whatever its depth,
    as the JAX package divides it."""
    if is_lmdb_path(path):
        img = (read_lmdb_value(path) / 255.0).astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        return fix_img_channels(np.ascontiguousarray(img), out_nc)
    img = decode_image(path)
    img = (img / (65535.0 if img.dtype == np.uint16 else 255.0)
           ).astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return fix_img_channels(np.ascontiguousarray(img), out_nc)


def fix_img_channels(img: np.ndarray, out_nc: int = 3) -> np.ndarray:
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if out_nc == 3 and c == 1:
        img = np.repeat(img, 3, axis=2)
    elif out_nc == 1 and c == 3:
        img = rgb2ycbcr(img, only_y=True)[:, :, None]
    elif c > out_nc:
        img = img[:, :, :out_nc]
    return img


_YCBCR = np.array([[65.481, -37.797, 112.0],
                   [128.553, -74.203, -93.786],
                   [24.966, 112.0, -18.214]], np.float32) / 255.0


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """ITU-R BT.601 studio swing, RGB input in [0, 1]."""
    if only_y:
        return img @ _YCBCR[:, 0] + 16.0 / 255.0
    return img @ _YCBCR + np.array([16, 128, 128], np.float32) / 255.0


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb2ycbcr(only_y=False)``."""
    inv = np.linalg.inv(_YCBCR.T).astype(np.float32)
    return (img - np.array([16, 128, 128], np.float32) / 255.0) @ inv.T


def channel_convert(img: np.ndarray, color: Optional[str]) -> np.ndarray:
    """'gray' | 'y' | 'RGB' conversions."""
    if not color or color in ("RGB", "rgb"):
        return img
    if color in ("gray", "grey"):
        return img.mean(axis=2, keepdims=True) if img.shape[2] == 3 else img
    if color.lower() == "y":
        return rgb2ycbcr(img, only_y=True)[:, :, None]
    return img


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def augment_pair(imgs: Sequence[np.ndarray], hflip: bool = True,
                 rot: bool = True,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[np.ndarray]:
    """The same random flips and transpose for every image of a list."""
    rng = rng or np.random.default_rng()
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def one(img):
        if do_h:
            img = img[:, ::-1]
        if do_v:
            img = img[::-1]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [one(i) for i in imgs]


def paired_random_crop(hr: np.ndarray, lr: np.ndarray, hr_crop: int,
                       scale: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned random crop: ``hr_crop`` px of HR and ``hr_crop / scale`` of
    LR at the same place; images smaller than the crop are reflect-padded."""
    rng = rng or np.random.default_rng()
    lr_crop = hr_crop // scale
    lh, lw = lr.shape[:2]
    if lh < lr_crop or lw < lr_crop:
        lr = np.pad(lr, ((0, max(0, lr_crop - lh)),
                         (0, max(0, lr_crop - lw)), (0, 0)), "reflect")
        hr = np.pad(hr, ((0, max(0, lr_crop - lh) * scale),
                         (0, max(0, lr_crop - lw) * scale), (0, 0)),
                    "reflect")
        lh, lw = lr.shape[:2]
    y = int(rng.integers(0, lh - lr_crop + 1))
    x = int(rng.integers(0, lw - lr_crop + 1))
    lr_c = lr[y: y + lr_crop, x: x + lr_crop]
    hr_c = hr[y * scale: y * scale + hr_crop,
              x * scale: x * scale + hr_crop]
    return hr_c, lr_c


def img2tensor(img: np.ndarray, znorm: bool = False,
               wire_u8: bool = False) -> np.ndarray:
    """HWC float32 [0, 1] -> network input array (HWC); znorm maps to
    [-1, 1]. ``wire_u8`` keeps the array uint8 on the wire (a quarter of
    the bytes to the device, lossless for 8-bit sources); the device
    normalises it (``ops.blocks.wire_to_f01``)."""
    if wire_u8:
        return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    img = img.astype(np.float32)
    if znorm:
        img = img * 2.0 - 1.0
    return img


def tensor2img(t, znorm: bool = False, out_type=np.uint8) -> np.ndarray:
    """Model output (HWC or NHWC numpy array or tensor, [0, 1] or [-1, 1])
    -> uint8 HWC RGB."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    arr = np.asarray(t, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if znorm:
        arr = (arr + 1.0) / 2.0
    arr = np.clip(arr, 0.0, 1.0)
    if out_type == np.uint8:
        return (arr * 255.0).round().astype(np.uint8)
    return arr


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth_filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The Paeth filter of every row of an (h, stride) uint8 image at once:
    its predictor reads only unfiltered neighbours."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, level: int = 6,
               row_filter: int = 0) -> bytes:
    """uint8 HWC (RGB, RGBA or gray) or HW image -> 8-bit PNG bytes, every
    row filtered with ``row_filter`` (0, none, or 4, Paeth), the data
    deflated at zlib ``level``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png writes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color = 0
    elif img.shape[2] == 3:
        color = 2
    elif img.shape[2] == 4:
        color = 6
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    if row_filter not in (0, 4):
        raise ValueError(f"row filter {row_filter}: 0 (none) or 4 (Paeth)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    if row_filter == 4:
        rows = _paeth_filter(rows, 1 if img.ndim == 2 else img.shape[2])
    raw = np.concatenate([np.full((h, 1), row_filter, np.uint8), rows],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def save_img(img: np.ndarray, path: str) -> None:
    """uint8 HWC (RGB, RGBA or gray) or HW image -> 8-bit PNG file."""
    png = encode_png(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
