"""Pure-Python reader of the LMDB file format (the port's copy of the
reader half of the JAX package's `data/lmdb_lite.py`).

The TED Gesture DB splits are LMDB environments written by the reference's
preprocessing (utils/data_preprocessor.py:163-178, the `lmdb` C binding).
Where that binding is not installed, `ted_db.iter_lmdb_videos` reads them
with this module, which implements the on-disk format of LMDB 0.9.x
(64-bit `data.mdb`, mdb.c's struct layouts).

Format notes:

  page 0/1          meta pages: 16-byte page header (P_META) + MDB_meta
  MDB_meta          magic 0xBEEFC0DE, version 1, mapsize, MDB_db[2]
                    (FREE_DBI, MAIN_DBI), last_pg, txnid; the env page size
                    lives in FREE_DBI.md_pad (mm_psize), env flags in
                    FREE_DBI.md_flags
  MDB_db (48 B)     pad u32, flags u16, depth u16, branch/leaf/overflow
                    page counts u64, entries u64, root u64 (~0 = empty)
  data page         header: pgno u64, pad u16, flags u16, lower u16,
                    upper u16, then indx_t ptrs[] (sorted key order);
                    node bytes grow down from the page end
  MDB_node (8 B)    lo u16, hi u16, flags u16, ksize u16, then key bytes,
                    then (leaf) inline value or (F_BIGDATA) u64 overflow
                    pgno; branch nodes pack the 48-bit child pgno into
                    lo|hi<<16|flags<<32 and carry no value
  overflow chain    first page: header with flags=P_OVERFLOW and the u32
                    page count in the lower/upper slot; value bytes start
                    at offset 16 and run contiguously through the following
                    pages (which have no headers)

The reader walks whichever meta page has the larger txnid, as
mdb_env_pick_meta does. Only plain (non-DUPSORT, non-LEAF2) main-DB trees
are supported: that is what the TED caches are.

API: the part of the `lmdb` binding that `ted_db.iter_lmdb_videos` uses,
``open()`` / ``Environment`` / ``Transaction.cursor()`` /
``Transaction.get()``. It writes nothing.
"""

from __future__ import annotations

import builtins
import os
import struct
from typing import Iterator

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
NODESZ = 8
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF

DEFAULT_PSIZE = 4096

_PAGEHDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_META_HEAD = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_META_TAIL = struct.Struct("<QQ")  # last_pg, txnid
_NODEHDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, pad=0, flags=0, depth=0, branch_pages=0,
                 leaf_pages=0, overflow_pages=0, entries=0,
                 root=INVALID_PGNO):
        self.pad = pad
        self.flags = flags
        self.depth = depth
        self.branch_pages = branch_pages
        self.leaf_pages = leaf_pages
        self.overflow_pages = overflow_pages
        self.entries = entries
        self.root = root

    @classmethod
    def unpack(cls, buf: bytes, off: int) -> "_Db":
        vals = _DB.unpack_from(buf, off)
        return cls(*vals)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class LmdbFormatError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        meta = self._pick_meta()
        self.psize = meta["psize"]
        self.main = meta["main"]
        self.last_pg = meta["last_pg"]

    def _read_meta(self, off: int) -> dict:
        buf = self.data
        magic, version, _addr, mapsize = _META_HEAD.unpack_from(
            buf, off + PAGEHDRSZ)
        if magic != MAGIC:
            raise LmdbFormatError(f"bad LMDB magic {magic:#x}")
        if version != DATA_VERSION:
            raise LmdbFormatError(f"unsupported LMDB data version {version}")
        dboff = off + PAGEHDRSZ + _META_HEAD.size
        free = _Db.unpack(buf, dboff)
        main = _Db.unpack(buf, dboff + _DB.size)
        last_pg, txnid = _META_TAIL.unpack_from(buf, dboff + 2 * _DB.size)
        psize = free.pad or DEFAULT_PSIZE  # mm_psize aliases FREE_DBI.md_pad
        return {"psize": psize, "mapsize": mapsize, "free": free,
                "main": main, "last_pg": last_pg, "txnid": txnid}

    def _pick_meta(self) -> dict:
        if len(self.data) < 2 * DEFAULT_PSIZE:
            # env psize could be < 4096 only on exotic platforms; meta1
            # offset needs the real psize, which meta0 carries
            if len(self.data) < PAGEHDRSZ + _META_HEAD.size:
                raise LmdbFormatError("file too small for an LMDB env")
        m0 = self._read_meta(0)
        m1 = self._read_meta(m0["psize"])
        return m1 if m1["txnid"] > m0["txnid"] else m0

    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self.data):
            raise LmdbFormatError(f"page {pgno} beyond end of file")
        _pg, pad, flags, lower, upper = _PAGEHDR.unpack_from(self.data, off)
        return off, pad, flags, lower, upper

    def _node(self, page_off: int, ptr_idx: int):
        (ptr,) = struct.unpack_from("<H", self.data,
                                    page_off + PAGEHDRSZ + 2 * ptr_idx)
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self.data, noff)
        key = self.data[noff + NODESZ:noff + NODESZ + ksize]
        return lo, hi, flags, key, noff + NODESZ + ksize

    def _overflow_value(self, pgno: int, size: int) -> bytes:
        off, _pad, flags, _lo, _up = self._page(pgno)
        if not flags & P_OVERFLOW:
            raise LmdbFormatError(f"page {pgno} is not an overflow page")
        start = off + PAGEHDRSZ
        if start + size > len(self.data):
            raise LmdbFormatError("overflow value runs past end of file")
        return self.data[start:start + size]

    def iter_tree(self, root: int) -> Iterator[tuple[bytes, bytes]]:
        if root == INVALID_PGNO:
            return
        off, _pad, flags, lower, upper = self._page(root)
        nkeys = (lower - PAGEHDRSZ) // 2
        if flags & P_LEAF2:
            raise LmdbFormatError("LEAF2 (DUPFIXED) pages unsupported")
        if flags & P_BRANCH:
            for i in range(nkeys):
                lo, hi, nflags, _key, _doff = self._node(off, i)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self.iter_tree(child)
        elif flags & P_LEAF:
            for i in range(nkeys):
                lo, hi, nflags, key, doff = self._node(off, i)
                if nflags & (F_DUPDATA | F_SUBDATA):
                    raise LmdbFormatError("DUPSORT/sub-DB nodes unsupported")
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    (ovf_pgno,) = struct.unpack_from("<Q", self.data, doff)
                    yield key, self._overflow_value(ovf_pgno, dsize)
                else:
                    yield key, self.data[doff:doff + dsize]
        else:
            raise LmdbFormatError(
                f"page {root} has unexpected flags {flags:#x}")

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        yield from self.iter_tree(self.main.root)

    def stat(self) -> dict:
        m = self.main
        return {"psize": self.psize, "depth": m.depth,
                "branch_pages": m.branch_pages, "leaf_pages": m.leaf_pages,
                "overflow_pages": m.overflow_pages, "entries": m.entries}


# ---------------------------------------------------------------------------
# `lmdb` binding API shim (the read surface ted_db uses)
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, items: list[tuple[bytes, bytes]]):
        self._items = items

    def __iter__(self):
        return iter(self._items)

    def iternext(self, keys: bool = True, values: bool = True):
        if keys and values:
            return iter(self._items)
        if keys:
            return iter([k for k, _ in self._items])
        return iter([v for _, v in self._items])


class Transaction:
    def __init__(self, reader: _Reader):
        self._reader = reader
        self._items: list[tuple[bytes, bytes]] | None = None

    def _all(self) -> list[tuple[bytes, bytes]]:
        if self._items is None:
            self._items = list(self._reader.items())
        return self._items

    def cursor(self) -> _Cursor:
        return _Cursor(self._all())

    def get(self, key: bytes, default=None):
        for k, v in self._all():
            if k == key:
                return v
        return default

    def stat(self) -> dict:
        return self._reader.stat()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Environment:
    """Read-only `lmdb.Environment` lookalike over a data.mdb file."""

    def __init__(self, path: str, readonly: bool = True, lock: bool = False,
                 subdir: bool = True, **_ignored):
        if not readonly:
            raise NotImplementedError("lmdb_lite environments are read-only")
        data_path = os.path.join(path, "data.mdb") if subdir else path
        with builtins.open(data_path, "rb") as f:
            self._reader = _Reader(f.read())
        self.path_ = path

    def begin(self, write: bool = False, **_ignored) -> Transaction:
        if write:
            raise NotImplementedError("lmdb_lite is read-only")
        return Transaction(self._reader)

    def stat(self) -> dict:
        return self._reader.stat()

    def close(self):
        self._reader = None  # type: ignore[assignment]


def open(path: str, **kwargs) -> Environment:  # noqa: A001 - binding parity
    return Environment(path, **kwargs)
