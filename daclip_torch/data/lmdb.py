"""Pure-Python LMDB (read + bulk write), without the `lmdb` package.

Copy of `daclip_tpu/data/lmdb.py` (the port imports nothing of the JAX
package). BasicSR-style image LMDBs hold raw uint8 HWC bytes keyed by image
name, with the shapes in meta_info.pkl (reference data/LQGT_dataset.py:58-74,
data/util.py:57-65). The on-disk format follows liblmdb's layout (mdb.c:
MDB_page / MDB_node / MDB_meta; 64-bit little-endian, 4096-byte pages):

  * `LmdbReader` — mmap + B+tree descent; `get()` returns a memoryview into
    the map, which `np.frombuffer` takes without a copy.
  * `LmdbWriter` — a bulk-loaded B+tree (sorted leaves packed bottom-up,
    overflow pages for big values) that liblmdb reads. Used by
    `tools/create_lmdb.py`.

Scope: the default environment layout (no MDB_DUPSORT, no named sub-DBs,
psize 4096), which BasicSR and the reference write and read.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGESIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
# largest node that fits a leaf (mdb.c mdb_env_max_nodesize):
# ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2  with MDB_MINKEYS = 2
NODEMAX = ((PAGESIZE - PAGEHDRSZ) // 2) & ~1


def _data_file(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only view of an lmdb environment (subdir or single-file)."""

    def __init__(self, path: str):
        import mmap

        self._f = open(_data_file(path), "rb")
        self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        m = memoryview(self._map)
        meta0 = self._parse_meta(m, 0)
        meta1 = self._parse_meta(m, 1)
        meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self._root = meta["main_root"]
        self.entries = meta["main_entries"]
        self._mv = m

    @staticmethod
    def _parse_meta(m: memoryview, pgno: int) -> Dict:
        base = pgno * PAGESIZE + PAGEHDRSZ
        magic, version = struct.unpack_from("<II", m, base)
        if magic != MDB_MAGIC:
            raise ValueError("not an LMDB data file (bad meta magic)")
        # MDB_meta: magic, version, address(8), mapsize(8), dbs[2] (48 each),
        # last_pg(8), txnid(8)
        main = base + 8 + 16 + 48  # second MDB_db (MAIN)
        (_, _, _, _, _, _, entries,
         root) = struct.unpack_from("<IHHQQQQQ", m, main)
        (last_pg, txnid) = struct.unpack_from("<QQ", m, base + 8 + 16 + 96)
        return {"main_root": root, "main_entries": entries, "txnid": txnid}

    # -- B+tree descent -----------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """(base, flags, numkeys, pgno)"""
        base = pgno * PAGESIZE
        flags, = struct.unpack_from("<H", self._mv, base + 10)
        lower, = struct.unpack_from("<H", self._mv, base + 12)
        numkeys = (lower - PAGEHDRSZ) // 2
        return base, flags, numkeys, pgno

    def _node(self, base: int, i: int) -> Tuple[int, int, int, bytes]:
        """(node_offset, data_size_or_pgno_lo48, flags, key)"""
        off, = struct.unpack_from("<H", self._mv, base + PAGEHDRSZ + 2 * i)
        n = base + off
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mv, n)
        key = bytes(self._mv[n + NODESZ: n + NODESZ + ksize])
        return n, lo | (hi << 16), flags, key

    def get(self, key: bytes) -> Optional[memoryview]:
        if isinstance(key, str):
            key = key.encode("ascii")
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            base, flags, nkeys, _ = self._page(pgno)
            if flags & P_LEAF:
                lo_i, hi_i = 0, nkeys - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    n, dsize, nflags, nkey = self._node(base, mid)
                    if nkey == key:
                        dstart = n + NODESZ + len(nkey)
                        if nflags & F_BIGDATA:
                            ovpg, = struct.unpack_from("<Q", self._mv, dstart)
                            ovbase = ovpg * PAGESIZE
                            return self._mv[ovbase + PAGEHDRSZ:
                                            ovbase + PAGEHDRSZ + dsize]
                        return self._mv[dstart: dstart + dsize]
                    if nkey < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            if not flags & P_BRANCH:
                raise ValueError(f"unexpected page flags {flags:#x}")
            # branch: rightmost child whose key <= target (first key = -inf)
            child = None
            for i in range(nkeys):
                n, pg48, nflags, nkey = self._node(base, i)
                pgno_i = pg48 | (nflags << 32)
                if i == 0 or nkey <= key:
                    child = pgno_i
                else:
                    break
            pgno = child

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def keys(self) -> Iterator[bytes]:
        if self._root == P_INVALID:
            return

        def walk(pgno):
            base, flags, nkeys, _ = self._page(pgno)
            if flags & P_LEAF:
                for i in range(nkeys):
                    _, _, _, nkey = self._node(base, i)
                    yield nkey
            else:
                for i in range(nkeys):
                    _, pg48, nflags, _ = self._node(base, i)
                    yield from walk(pg48 | (nflags << 32))

        yield from walk(self._root)

    def begin(self, write: bool = False):
        """`with env.begin() as txn: txn.get(key)` compatibility shim."""
        assert not write, "LmdbReader is read-only"
        return _Txn(self)

    def close(self):
        self._mv.release()
        try:
            self._map.close()
        except BufferError:
            # zero-copy views returned by get() are still alive; the mmap is
            # reclaimed when they are garbage-collected
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _Txn:
    def __init__(self, env):
        self._env = env

    def get(self, key):
        return self._env.get(key)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class LmdbWriter:
    """Bulk writer: collect puts, build the tree on close.

    Produces a standard single-process lmdb environment readable by liblmdb
    (and by LmdbReader).  Keys are sorted with memcmp semantics, matching
    liblmdb's default comparator.
    """

    def __init__(self, path: str, subdir: bool = True, map_size: int = 0):
        if subdir:
            os.makedirs(path, exist_ok=True)
            self._file = os.path.join(path, "data.mdb")
        else:
            self._file = path
        # values are spooled to disk as they arrive; only (offset, length)
        # per key stays in memory — packing a multi-GB image set must not
        # hold the whole dataset in RAM
        self._spool_path = self._file + ".spool"
        self._spool = open(self._spool_path, "w+b")
        self._items: Dict[bytes, Tuple[int, int]] = {}
        self._map_size = map_size

    def put(self, key, value):
        if isinstance(key, str):
            key = key.encode("ascii")
        value = bytes(value)
        off = self._spool.seek(0, 2)
        self._spool.write(value)
        self._items[bytes(key)] = (off, len(value))

    # -- tree construction ---------------------------------------------------
    def close(self):
        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0,1 are meta
        n_leaf = n_branch = n_ov = 0

        def alloc(n=1):
            nonlocal next_pg
            pg = next_pg
            next_pg += n
            return pg

        def page_bytes(pgno, flags, nodes):
            """nodes: list of (key, payload, nflags) already packed."""
            ptrs, blob_parts = [], []
            upper = PAGESIZE
            for key, payload, nflags in nodes:
                sz = NODESZ + len(key) + len(payload)
                sz += sz & 1
                upper -= sz
                ptrs.append(upper)
            lower = PAGEHDRSZ + 2 * len(nodes)
            buf = bytearray(PAGESIZE)
            struct.pack_into("<QHHHH", buf, 0, pgno, 0, flags, lower, ptrs and min(ptrs) or PAGESIZE)
            struct.pack_into(f"<{len(nodes)}H", buf, PAGEHDRSZ, *ptrs)
            for (key, payload, nflags), off in zip(nodes, ptrs):
                if flags & P_LEAF:
                    dsize = len(payload) if not nflags & F_BIGDATA else self._big_sizes[key]
                    lo, hi = dsize & 0xFFFF, dsize >> 16
                else:  # branch: payload empty, nflags carries pgno
                    pg48 = nflags
                    lo, hi, nflags = pg48 & 0xFFFF, (pg48 >> 16) & 0xFFFF, pg48 >> 32
                struct.pack_into("<HHHH", buf, off, lo, hi, nflags, len(key))
                buf[off + NODESZ: off + NODESZ + len(key)] = key
                buf[off + NODESZ + len(key):
                    off + NODESZ + len(key) + len(payload)] = payload
            return bytes(buf)

        # 1. leaves (+ overflow)
        self._spool.flush()

        def fetch(key: bytes) -> bytes:
            off, vlen = self._items[key]
            self._spool.seek(off)
            return self._spool.read(vlen)

        self._big_sizes = {}
        keys = sorted(self._items)
        leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        cur_nodes, cur_space = [], PAGESIZE - PAGEHDRSZ
        ov_chunks: List[Tuple[int, bytes]] = []  # (pgno, key) — streamed later

        def flush_leaf():
            nonlocal cur_nodes, cur_space, n_leaf
            if not cur_nodes:
                return
            pg = alloc()
            leaves.append((cur_nodes[0][0], pg))
            pages[pg] = page_bytes(pg, P_LEAF, cur_nodes)
            n_leaf += 1
            cur_nodes, cur_space = [], PAGESIZE - PAGEHDRSZ

        for k in keys:
            vlen = self._items[k][1]
            if NODESZ + len(k) + vlen > NODEMAX:
                self._big_sizes[k] = vlen
                # overflow chain: header + data over ceil((16+len)/psize) pages
                novp = -(-(PAGEHDRSZ + vlen) // PAGESIZE)
                ovpg = alloc(novp)
                n_ov += novp
                ov_chunks.append((ovpg, k))
                payload, nflags = struct.pack("<Q", ovpg), F_BIGDATA
            else:
                payload, nflags = fetch(k), 0
            sz = NODESZ + len(k) + len(payload)
            sz += sz & 1
            if sz + 2 > cur_space:
                flush_leaf()
            cur_nodes.append((k, payload, nflags))
            cur_space -= sz + 2
        flush_leaf()

        # 2. branches bottom-up
        level = leaves
        depth = 1
        while len(level) > 1:
            nxt: List[Tuple[bytes, int]] = []
            cur: List[Tuple[bytes, int]] = []
            space = PAGESIZE - PAGEHDRSZ

            def flush_branch():
                nonlocal cur, space, n_branch
                if not cur:
                    return
                pg = alloc()
                # liblmdb never compares a branch page's index-0 key
                # (mdb_node_search: low = 1 on branch pages), so keeping the
                # real first key is compatible; ordering is all that matters.
                nodes = [(sep, b"", child_pg) for sep, child_pg in cur]
                pages[pg] = page_bytes(pg, P_BRANCH, nodes)
                nxt.append((cur[0][0], pg))
                n_branch += 1
                cur, space = [], PAGESIZE - PAGEHDRSZ

            for sep, child in level:
                sz = NODESZ + len(sep)
                sz += sz & 1
                if sz + 2 > space:
                    flush_branch()
                cur.append((sep, child))
                space -= sz + 2
            flush_branch()
            level = nxt
            depth += 1

        root = level[0][1] if level else P_INVALID
        entries = len(keys)
        last_pg = next_pg - 1 if next_pg > 2 else 1

        # 3. serialise file
        size = max(next_pg * PAGESIZE, self._map_size or (1 << 20))
        with open(self._file, "wb") as f:
            f.truncate(size)
            for pgno in (0, 1):
                f.seek(pgno * PAGESIZE)
                buf = bytearray(PAGESIZE)
                struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_META, 0, 0)
                o = PAGEHDRSZ
                struct.pack_into("<II", buf, o, MDB_MAGIC, MDB_DATA_VERSION)
                struct.pack_into("<QQ", buf, o + 8, 0, size)  # address, mapsize
                # FREE db (empty)
                struct.pack_into("<IHHQQQQQ", buf, o + 24, 0, 0, 0, 0, 0, 0, 0,
                                 P_INVALID)
                # MAIN db
                struct.pack_into("<IHHQQQQQ", buf, o + 72, 0, 0,
                                 depth if entries else 0,
                                 n_branch, n_leaf, n_ov, entries,
                                 root if entries else P_INVALID)
                struct.pack_into("<QQ", buf, o + 120, last_pg, pgno)  # txnid 0/1
                f.write(buf)
            for pgno, data in sorted(pages.items()):
                f.seek(pgno * PAGESIZE)
                f.write(data)
            for ovpg, k in ov_chunks:
                off, vlen = self._items[k]
                f.seek(ovpg * PAGESIZE)
                buf = bytearray(PAGEHDRSZ)
                novp = -(-(PAGEHDRSZ + vlen) // PAGESIZE)
                struct.pack_into("<QHHI", buf, 0, ovpg, 0, P_OVERFLOW, novp)
                f.write(buf)
                self._spool.seek(off)
                remaining = vlen
                while remaining:
                    chunk = self._spool.read(min(remaining, 1 << 22))
                    f.write(chunk)
                    remaining -= len(chunk)
        self._spool.close()
        os.unlink(self._spool_path)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
