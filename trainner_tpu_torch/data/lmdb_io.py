"""Reader and writer of LMDB environments, with the standard library
alone: the port's copy of ``trainner_tpu/data/lmdb_io.py``
(``LmdbReader:36``, ``write_lmdb:240``, ``read_lmdb_img:355``,
``lmdb_paths:368``), so that neither package needs the ``lmdb`` library.

The format, as liblmdb writes it with default options (no DUPSORT, no
named sub-databases), which is what ``scripts/create_lmdb.py`` of either
package writes:

  * one file, ``data.mdb``, little-endian 64-bit, pages of ``psize`` bytes
    (stored in the free DB's ``md_pad`` of the meta page; 4096 as a rule);
  * pages 0 and 1 are meta pages (magic 0xBEEFC0DE, version 1); the live
    one is the one with the larger txnid;
  * the main DB's root is a B+tree of branch and leaf pages; a leaf node
    holds its value inline or, past the node limit, points at a run of
    contiguous overflow pages (``F_BIGDATA``).

Values are encoded images; ``read_lmdb_img`` decodes one with the port's
decoder (``data/common.py::decode_image_bytes``: OpenCV where it is
installed, else the standard-library PNG reader).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
F_BIGDATA = 0x01

_PAGE_HDR = 16  # pgno(8) pad(2) flags(2) lower(2) upper(2)


class LmdbReader:
    """Read-only access to an LMDB environment directory (or data.mdb)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        # mmap, not read(): reference-scale LMDBs are multi-GB and one
        # reader is cached per root per loader worker — a full read()
        # would multiply that across n_workers and OOM the host.
        # struct.unpack_from / slicing work unchanged on the mmap buffer.
        import mmap

        self._file = open(path, "rb")
        self._buf = mmap.mmap(self._file.fileno(), 0,
                              access=mmap.ACCESS_READ)
        m0 = self._parse_meta(0)
        psize = m0["psize"]
        m1 = self._parse_meta(psize)
        meta = m0 if m0["txnid"] >= m1["txnid"] else m1
        self.psize = meta["psize"]
        self.root = meta["root"]
        self.entries = meta["entries"]

    def close(self) -> None:
        try:
            self._buf.close()
            self._file.close()
        except Exception:
            pass

    def __del__(self):  # best-effort; mmap also closes on GC
        self.close()

    def _parse_meta(self, off: int) -> dict:
        b = self._buf
        # MDB_page header then MDB_meta
        flags = struct.unpack_from("<H", b, off + 10)[0]
        if not flags & P_META:
            raise ValueError(f"{self.path}: not an LMDB meta page @ {off}")
        mo = off + _PAGE_HDR
        magic, version = struct.unpack_from("<II", b, mo)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: bad LMDB magic {magic:#x}")
        # mm_address(8) mm_mapsize(8) then mm_dbs[2] then last_pg, txnid
        dbs_off = mo + 8 + 8 + 8
        # MDB_db: pad(4) flags(2) depth(2) branch(8) leaf(8) ovf(8)
        #         entries(8) root(8)  -> 48 bytes
        psize = struct.unpack_from("<I", b, dbs_off)[0]
        main_off = dbs_off + 48
        entries, root = struct.unpack_from("<Qq", b, main_off + 32)
        last_pg, txnid = struct.unpack_from("<QQ", b, main_off + 48)
        return {"psize": psize, "root": root, "entries": entries,
                "txnid": txnid}

    # -- page access --------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int]:
        off = pgno * self.psize
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        return off, flags

    def _leaf_nodes(self, off: int) -> List[Tuple[bytes, bytes]]:
        b = self._buf
        lower = struct.unpack_from("<H", b, off + 12)[0]
        n = (lower - _PAGE_HDR) // 2
        out = []
        for i in range(n):
            ptr = struct.unpack_from("<H", b, off + _PAGE_HDR + 2 * i)[0]
            no = off + ptr
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", b, no)
            dsize = lo | (hi << 16)
            key = b[no + 8: no + 8 + ksize]
            if nflags & F_BIGDATA:
                ovf_pgno = struct.unpack_from(
                    "<Q", b, no + 8 + ksize)[0]
                po, pflags = self._page(ovf_pgno)
                assert pflags & P_OVERFLOW, "expected overflow page"
                data = b[po + _PAGE_HDR: po + _PAGE_HDR + dsize]
            else:
                data = b[no + 8 + ksize: no + 8 + ksize + dsize]
            out.append((key, data))
        return out

    def _branch_children(self, off: int) -> List[int]:
        b = self._buf
        lower = struct.unpack_from("<H", b, off + 12)[0]
        n = (lower - _PAGE_HDR) // 2
        kids = []
        for i in range(n):
            ptr = struct.unpack_from("<H", b, off + _PAGE_HDR + 2 * i)[0]
            no = off + ptr
            lo, hi = struct.unpack_from("<HH", b, no)
            kids.append(lo | (hi << 16) | (
                struct.unpack_from("<H", b, no + 4)[0] << 32))
        return kids

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self.root < 0:
            return
        stack = [self.root]
        order: List[int] = []
        while stack:
            pgno = stack.pop()
            off, flags = self._page(pgno)
            if flags & P_LEAF:
                order.append(pgno)
            elif flags & P_BRANCH:
                stack.extend(reversed(self._branch_children(off)))
        for pgno in order:
            off, _ = self._page(pgno)
            yield from self._leaf_nodes(off)

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup by B+tree descent."""
        if self.root < 0:
            return None
        pgno = self.root
        while True:
            off, flags = self._page(pgno)
            if flags & P_LEAF:
                for k, v in self._leaf_nodes(off):
                    if k == key:
                        return v
                return None
            b = self._buf
            lower = struct.unpack_from("<H", b, off + 12)[0]
            n = (lower - _PAGE_HDR) // 2
            nxt = None
            for i in range(n):
                ptr = struct.unpack_from("<H", b,
                                         off + _PAGE_HDR + 2 * i)[0]
                no = off + ptr
                lo, hi, _f, ksize = struct.unpack_from("<HHHH", b, no)
                child = lo | (hi << 16)
                k = b[no + 8: no + 8 + ksize]
                if i == 0 or key >= k:
                    nxt = child
                else:
                    break
            pgno = nxt
            if pgno is None:
                return None

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]


# ---------------------------------------------------------------------------
# writer (single transaction, bulk build — enough for dataset creation)
# ---------------------------------------------------------------------------


class _Pages:
    def __init__(self, psize: int):
        self.psize = psize
        self.pages: List[bytes] = []

    def add(self, raw: bytes) -> int:
        assert len(raw) % self.psize == 0
        pgno = 2 + sum(len(p) // self.psize for p in self.pages)
        self.pages.append(raw)
        return pgno


def _mk_page(psize: int, pgno: int, flags: int,
             nodes: List[bytes]) -> bytes:
    lower = _PAGE_HDR + 2 * len(nodes)
    sizes = [len(n) + (len(n) & 1) for n in nodes]  # 2-byte aligned
    upper = psize - sum(sizes)
    assert upper >= lower, "page overflow"
    ptrs = []
    pos = psize
    body = bytearray(psize)
    for node, sz in zip(nodes, sizes):
        pos -= sz
        ptrs.append(pos)
        body[pos: pos + len(node)] = node
    struct.pack_into("<QHHHH", body, 0, pgno, 0, flags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", body, _PAGE_HDR + 2 * i, p)
    return bytes(body)


def _leaf_node(key: bytes, data: bytes,
               ovf_pgno: Optional[int]) -> bytes:
    if ovf_pgno is not None:
        dsize = len(data)
        return struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16,
                           F_BIGDATA, len(key)) + key + \
            struct.pack("<Q", ovf_pgno)
    dsize = len(data)
    return struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, 0,
                       len(key)) + key + data


def _branch_node(key: bytes, child: int) -> bytes:
    return struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                       (child >> 32) & 0xFFFF, len(key)) + key


def write_lmdb(path: str, items: Dict[bytes, bytes],
               psize: int = 4096) -> None:
    """Create <path>/data.mdb holding `items` (sorted by key), matching
    the reader above and liblmdb's read-only expectations."""
    os.makedirs(path, exist_ok=True)
    pages_out = _Pages(psize)
    nodemax = (psize - _PAGE_HDR) // 2 - 16  # conservative inline limit

    pairs = sorted(items.items())
    leaf_nodes: List[bytes] = []
    n_ovf = 0
    prepared: List[Tuple[bytes, bytes, Optional[int]]] = []
    for key, data in pairs:
        if len(data) > nodemax:
            npages = -(-(len(data) + _PAGE_HDR) // psize)
            raw = bytearray(npages * psize)
            raw[_PAGE_HDR: _PAGE_HDR + len(data)] = data
            pgno = pages_out.add(bytes(raw))
            struct.pack_into("<QHHI", raw, 0, pgno, 0, P_OVERFLOW, npages)
            pages_out.pages[-1] = bytes(raw)
            prepared.append((key, data, pgno))
            n_ovf += npages
        else:
            prepared.append((key, data, None))

    # pack leaves
    leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur: List[bytes] = []
    cur_first: Optional[bytes] = None
    cur_used = 0

    def flush_leaf():
        nonlocal cur, cur_first, cur_used
        if not cur:
            return
        pgno = pages_out.add(_mk_page(psize, 0, P_LEAF, cur))
        # rewrite with correct pgno
        raw = bytearray(pages_out.pages[-1])
        struct.pack_into("<Q", raw, 0, pgno)
        pages_out.pages[-1] = bytes(raw)
        leaves.append((cur_first, pgno))
        cur, cur_first, cur_used = [], None, 0

    for key, data, ovf in prepared:
        node = _leaf_node(key, data, ovf)
        need = len(node) + (len(node) & 1) + 2
        if cur and _PAGE_HDR + cur_used + need > psize:
            flush_leaf()
        if not cur:
            cur_first = key
        cur.append(node)
        cur_used += need
    flush_leaf()

    n_leaf = len(leaves)
    depth = 1
    level = leaves
    n_branch = 0
    while len(level) > 1:
        nxt: List[Tuple[bytes, int]] = []
        group: List[Tuple[bytes, int]] = []
        used = 0

        def flush_branch():
            nonlocal group, used, n_branch
            if not group:
                return
            nodes = []
            for j, (k, child) in enumerate(group):
                nodes.append(_branch_node(b"" if j == 0 else k, child))
            pgno = pages_out.add(_mk_page(psize, 0, P_BRANCH, nodes))
            raw = bytearray(pages_out.pages[-1])
            struct.pack_into("<Q", raw, 0, pgno)
            pages_out.pages[-1] = bytes(raw)
            nxt.append((group[0][0], pgno))
            n_branch += 1
            group, used = [], 0

        for k, child in level:
            need = len(_branch_node(k, child)) + 2 + 1
            if group and _PAGE_HDR + used + need > psize:
                flush_branch()
            group.append((k, child))
            used += need
        flush_branch()
        level = nxt
        depth += 1

    root = level[0][1] if level else -1
    last_pg = 1 + sum(len(p) // psize for p in pages_out.pages)

    def meta_page(pgno: int, txnid: int) -> bytes:
        body = bytearray(psize)
        struct.pack_into("<QHHHH", body, 0, pgno, 0, P_META, 0, 0)
        mo = _PAGE_HDR
        struct.pack_into("<II", body, mo, MAGIC, 1)
        struct.pack_into("<QQ", body, mo + 8, 0, psize * (last_pg + 1))
        dbs = mo + 24
        # free DB: psize in md_pad, empty root
        struct.pack_into("<IHH", body, dbs, psize, 0, 0)
        struct.pack_into("<QQQQq", body, dbs + 8, 0, 0, 0, 0, -1)
        main = dbs + 48
        struct.pack_into("<IHH", body, main, 0, 0, depth)
        struct.pack_into("<QQQQq", body, main + 8, n_branch, n_leaf,
                         n_ovf, len(pairs), root)
        struct.pack_into("<QQ", body, main + 48, last_pg, txnid)
        return bytes(body)

    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for p in pages_out.pages:
            f.write(p)


def read_lmdb_img(reader: LmdbReader, key: str):
    """One value decoded as OpenCV's ``IMREAD_COLOR`` gives it: uint8, HWC,
    three channels in BGR order."""
    import numpy as np

    from .common import decode_image_bytes

    buf = reader.get(key.encode("ascii"))
    if buf is None:
        raise KeyError(f"lmdb key not found: {key}")
    img = decode_image_bytes(bytes(buf), key)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def lmdb_paths(dataroot: str) -> List[str]:
    """The keys that ``meta_info.txt`` lists (each line's text before its
    first ``.``), or every key of the environment, in key order, where
    there is no such file."""
    meta = os.path.join(dataroot, "meta_info.txt")
    if os.path.exists(meta):
        with open(meta) as f:
            return [line.split(".")[0] for line in f if line.strip()]
    return [k.decode("ascii") for k in LmdbReader(dataroot).keys()]
