"""OCDBT key-value stores in a local directory, read and written.

OCDBT is the B-tree database that tensorstore keeps under an orbax
checkpoint (``<step>/default/manifest.ocdbt`` and the files it points
into). :class:`OcdbtReader` reads one with no tensorstore: the manifest, the
latest version in its version list (the manifest always holds the
newest versions inline; version-tree nodes hold only older ones), and
that version's B-tree, whose leaves hold each key's value inline or as
a (file, offset, length) reference into a data file.

Every file is framed the same way: a 4-byte big-endian magic, the
file's length as a little-endian u64, a format version and a
compression method (varints; 1 = zstd), the body, and a crc32c of all
that precedes it. A bad magic, length or crc, or a truncated file,
raises ``ValueError`` naming the file.

:func:`write_database` writes a new database of one version from a
``{key: value}`` mapping, uncompressed (method 0), framed as the reader
checks: one data file ``d/<32 hex>`` holding the values longer than
``max_inline_value_bytes`` and the B-tree nodes, and the manifest.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

from multiverse_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1     # offset and length of an empty tree's root

_CRC32C = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C.append(_c)
del _i, _c


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's file footers hold it."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Body:
    """A decoded body read forward; every read bounds-checked."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise ValueError("%s: %s" % (self.where, what))

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail("truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack("<%dQ" % n, self.take(8 * n)))

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail("%d bytes after the end" % (len(self.data) - self.pos))


@dataclass(frozen=True)
class _Ref:
    """Where a node or value lies: a file under the root, an offset and a
    length. ``base`` is the file's base path, which the data-file tables
    of a node read from it are relative to."""

    base: str
    path: str
    offset: int
    length: int


def _data_file_table(b: _Body, base: str) -> List[Tuple[str, str]]:
    """(base path, full path) of each data file a node names. Paths are
    prefix-compressed against the previous entry; each base path is the
    first ``base_length`` bytes of its path, under ``base``."""
    n = b.varint()
    prefix = [0] + b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    base_len = b.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            b.fail("data file table entry %d out of range" % i)
        path = prev[:prefix[i]] + b.take(suffix[i])
        prev = path
        try:
            text = path.decode()
        except UnicodeDecodeError:
            b.fail("data file path is not UTF-8")
        out.append((base + text[:base_len[i]], base + text))
    return out


def _refs(b: _Body, table, n: int) -> List[_Ref]:
    ids = b.varints(n)
    offsets = b.varints(n)
    lengths = b.varints(n)
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if i >= len(table):
            b.fail("data file id %d out of range" % i)
        out.append(_Ref(table[i][0], table[i][1], o, ln))
    return out


@dataclass(frozen=True)
class Version:
    generation: int
    root: Optional[_Ref]     # None: the empty tree
    root_height: int


def _versions(b: _Body, table) -> List[Version]:
    n = b.varint()
    gens = b.varints(n)
    heights = list(b.take(n))
    roots = _refs(b, table, n)
    b.varints(3 * n)        # num_keys, num_tree_bytes, num_indirect_bytes
    b.u64s(n)               # commit_time
    return [Version(g, None if r.offset == _MISSING else r, h)
            for g, h, r in zip(gens, heights, roots)]


def _skip_version_nodes(b: _Body, table):
    """The manifest's references to version-tree nodes, which hold only
    versions older than its inline ones: read past, not followed."""
    n = b.varint()
    b.varints(n)            # generation
    _refs(b, table, n)
    b.varints(n)            # num_generations
    b.u64s(n)               # commit_time
    b.take(n)               # height


class OcdbtReader:
    """The keys and values of an OCDBT database rooted at ``root``, as
    of its latest version. Values are read from their files with
    seek-and-read when asked for."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        version = self._read_manifest()
        self.generation = version.generation
        self._entries: Dict[bytes, Union[bytes, _Ref]] = {}
        if version.root is not None:
            self._walk(version.root, version.root_height, b"")

    # ---------------------------------------------------------- files
    def _path(self, rel: str) -> str:
        path = os.path.normpath(os.path.join(self.root, rel))
        if os.path.commonpath([path, self.root]) != self.root:
            raise ValueError("%s: data file path %r leaves the database"
                             % (self.root, rel))
        return path

    def _read_range(self, rel: str, offset: int, length: int) -> bytes:
        path = self._path(rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise ValueError("%s: cannot read: %s" % (path, e)) from e
        if len(data) != length:
            raise ValueError("%s: truncated: %d bytes at offset %d, expected "
                             "%d" % (path, len(data), offset, length))
        return data

    def _decode(self, data: bytes, magic: int, where: str) -> _Body:
        if len(data) < 18:
            raise ValueError("%s: truncated (%d bytes)" % (where, len(data)))
        got_magic, length = struct.unpack(">I", data[:4])[0], \
            struct.unpack("<Q", data[4:12])[0]
        if got_magic != magic:
            raise ValueError("%s: bad magic %08x, expected %08x"
                             % (where, got_magic, magic))
        if length != len(data):
            raise ValueError("%s: length field %d, but %d bytes"
                             % (where, length, len(data)))
        want = struct.unpack("<I", data[-4:])[0]
        if crc32c(data[:-4]) != want:
            raise ValueError("%s: crc32c mismatch" % where)
        head = _Body(data[12:-4], where)
        version, method = head.varint(), head.varint()
        if version != 0:
            raise ValueError("%s: format version %d, only 0 is read"
                             % (where, version))
        body = data[12 + head.pos:-4]
        if method == 1:
            try:
                body = zstd.decompress(body)
            except ValueError as e:
                raise ValueError("%s: %s" % (where, e)) from e
        elif method != 0:
            raise ValueError("%s: unknown compression method %d"
                             % (where, method))
        return _Body(body, where)

    def _node(self, ref: _Ref, magic: int) -> _Body:
        where = "%s:%d:%d" % (self._path(ref.path), ref.offset, ref.length)
        return self._decode(self._read_range(ref.path, ref.offset,
                                             ref.length), magic, where)

    # -------------------------------------------------------- manifest
    def _read_manifest(self) -> Version:
        path = self._path("manifest.ocdbt")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ValueError("%s: cannot read: %s" % (path, e)) from e
        b = self._decode(data, MANIFEST_MAGIC, path)
        b.take(16)                                  # uuid
        kind = b.varint()
        if kind != 0:
            b.fail("manifest kind %d (numbered manifests are not read)"
                   % kind)
        b.varint()                                  # max_inline_value_bytes
        b.varint()                                  # max_decoded_node_bytes
        b.u8()                                      # version_tree_arity_log2
        compression = b.varint()
        if compression == 1:
            b.take(4)                               # zstd level, i32
        elif compression != 0:
            b.fail("unknown compression method %d" % compression)
        table = _data_file_table(b, "")
        versions = _versions(b, table)
        _skip_version_nodes(b, table)
        b.end()
        if not versions:
            b.fail("the manifest lists no version")
        return max(versions, key=lambda v: v.generation)

    # ---------------------------------------------------------- B-tree
    def _keys(self, b: _Body, n: int, with_subtree_prefix: bool):
        prefix = [0] + b.varints(max(n - 1, 0))
        suffix = b.varints(n)
        common = b.varints(n) if with_subtree_prefix else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                b.fail("key %d shares more than the previous key" % i)
            prev = prev[:prefix[i]] + b.take(suffix[i])
            keys.append(prev)
        return keys, common

    def _walk(self, ref: _Ref, height: int, key_prefix: bytes):
        b = self._node(ref, BTREE_MAGIC)
        got = b.u8()
        if got != height:
            b.fail("height %d, its parent says %d" % (got, height))
        table = _data_file_table(b, ref.base)
        n = b.varint()
        if height == 0:
            keys, _ = self._keys(b, n, False)
            lengths = b.varints(n)
            kinds = list(b.take(n))
            if any(k > 1 for k in kinds):
                b.fail("unknown value kind")
            # an indirect value has a file and an offset; its length is
            # the entry's value length
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids = b.varints(len(indirect))
            offsets = b.varints(len(indirect))
            for i, f, o in zip(indirect, ids, offsets):
                if f >= len(table):
                    b.fail("data file id %d out of range" % f)
                self._entries[key_prefix + keys[i]] = _Ref(
                    table[f][0], table[f][1], o, lengths[i])
            for i, key in enumerate(keys):
                if kinds[i] == 0:
                    self._entries[key_prefix + key] = b.take(lengths[i])
            b.end()
            return
        keys, common = self._keys(b, n, True)
        children = _refs(b, table, n)
        b.varints(3 * n)    # num_keys, num_tree_bytes, num_indirect_bytes
        b.end()
        for key, c, child in zip(keys, common, children):
            if c > len(key):
                b.fail("subtree prefix longer than its key")
            self._walk(child, height - 1, key_prefix + key[:c])

    # ------------------------------------------------------------- API
    def keys(self) -> List[bytes]:
        """Every key of the version read, in order."""
        return sorted(self._entries)

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value of ``key``; ``KeyError`` where there is none."""
        if isinstance(key, str):
            key = key.encode()
        value = self._entries[key]
        if isinstance(value, bytes):
            return value
        return self._read_range(value.path, value.offset, value.length)


# ------------------------------------------------------------------ writer

# orbax's configuration of the databases it writes (a manifest of the
# JAX package's checkpoints reads: max_inline_value_bytes 1024,
# max_decoded_node_bytes 100000000, version_tree_arity_log2 4)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _frame(magic: int, body: bytes) -> bytes:
    """``body`` framed as :meth:`OcdbtReader._decode` reads it: format
    version 0, compression method 0, crc32c of all that precedes it."""
    head = _varint(0) + _varint(0)
    length = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", crc32c(data))


def _file_table(path: Optional[str]) -> bytes:
    """A data file table naming ``path`` (its base path empty), or no
    file."""
    if path is None:
        return _varint(0)
    name = path.encode()
    return _varint(1) + _varint(len(name)) + _varint(0) + name


def _key_columns(keys: List[bytes], common: Optional[List[int]]) -> bytes:
    """Keys prefix-compressed against the previous one: the shared
    lengths, the suffix lengths, (interior nodes) the subtree common
    prefix lengths, then the suffixes."""
    shared, suffixes = [], []
    for prev, key in zip([b""] + keys[:-1], keys):
        n = 0
        while n < min(len(prev), len(key)) and prev[n] == key[n]:
            n += 1
        shared.append(n)
        suffixes.append(key[n:])
    return (_varints(shared[1:]) + _varints(len(s) for s in suffixes)
            + (_varints(common) if common is not None else b"")
            + b"".join(suffixes))


def _leaf_node(entries, path: str) -> bytes:
    """A height-0 node of ``entries``: (key, inline bytes or (offset,
    length) into ``path``)."""
    keys = [k for k, _ in entries]
    indirect = [v for _, v in entries if isinstance(v, tuple)]
    lengths = [v[1] if isinstance(v, tuple) else len(v) for _, v in entries]
    kinds = bytes(int(isinstance(v, tuple)) for _, v in entries)
    body = (bytes([0]) + _file_table(path if indirect else None)
            + _varint(len(entries)) + _key_columns(keys, None)
            + _varints(lengths) + kinds
            + _varints(0 for _ in indirect) + _varints(o for o, _ in indirect)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))
    return _frame(BTREE_MAGIC, body)


def _interior_node(height: int, children, path: str) -> bytes:
    """A node of ``height`` over ``children``: (first key, offset,
    length, num_keys, num_tree_bytes, num_indirect_bytes), each child's
    keys stored whole (a subtree common prefix of 0)."""
    n = len(children)
    body = (bytes([height]) + _file_table(path) + _varint(n)
            + _key_columns([c[0] for c in children], [0] * n)
            + _varints([0] * n) + _varints(c[1] for c in children)
            + _varints(c[2] for c in children)
            + b"".join(_varints(c[i] for c in children) for i in (3, 4, 5)))
    return _frame(BTREE_MAGIC, body)


def _split(items: list, size, limit: int) -> List[list]:
    """``items`` in runs of consecutive items whose ``size`` sum stays
    within ``limit`` (an item alone may exceed it; the node is then
    checked when made)."""
    runs, run, total = [], [], 0
    for item in items:
        s = size(item)
        if run and total + s > limit:
            runs.append(run)
            run, total = [], 0
        run.append(item)
        total += s
    if run:
        runs.append(run)
    return runs


def write_database(
        root: str, entries: Mapping[bytes, bytes],
        max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
        max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> None:
    """Write a new OCDBT database of ``entries`` into the directory
    ``root`` (made if missing; it must hold no database yet): one
    version, generation 1, whose B-tree's nodes each decode to at most
    ``max_decoded_node_bytes``. The exact inverse of
    :class:`OcdbtReader`; tensorstore's ``ocdbt`` driver reads it too."""
    if not entries:
        raise ValueError("%s: an OCDBT database of no keys" % root)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    manifest = os.path.join(root, "manifest.ocdbt")
    if os.path.exists(manifest):
        raise ValueError("%s: a database is already there" % root)
    path = "d/" + uuid.uuid4().hex
    keys = sorted(entries)
    data = bytearray()
    leaf_entries, indirect_bytes = [], 0
    for key in keys:
        value = bytes(entries[key])
        if len(value) > max_inline_value_bytes:
            leaf_entries.append((key, (len(data), len(value))))
            data += value
            indirect_bytes += len(value)
        else:
            leaf_entries.append((key, value))
    # an entry's share of a leaf: its key and value, at most 5 varints of
    # 10 bytes and its kind; of an interior node: its key and 8 varints;
    # a node's own share: its framing and file table
    overhead = 64 + len(path)

    def entry_size(e):
        return len(e[0]) + 51 + (len(e[1]) if isinstance(e[1], bytes) else 0)

    level = []      # (first key, offset, length, keys, tree, indirect)
    for run in _split(leaf_entries, entry_size,
                      max_decoded_node_bytes - overhead):
        node = _leaf_node(run, path)
        level.append((run[0][0], len(data), len(node), len(run), len(node),
                      sum(v[1] for _, v in run if isinstance(v, tuple))))
        if len(node) > max_decoded_node_bytes:
            raise ValueError("%s: key %r makes a node of %d bytes, more "
                             "than %d" % (root, run[0][0], len(node),
                                          max_decoded_node_bytes))
        data += node
    height = 0
    while len(level) > 1:
        height += 1
        parents = []
        for run in _split(level, lambda c: len(c[0]) + 80,
                          max_decoded_node_bytes - overhead):
            node = _interior_node(height, run, path)
            parents.append((run[0][0], len(data), len(node),
                            sum(c[3] for c in run),
                            sum(c[4] for c in run) + len(node),
                            sum(c[5] for c in run)))
            data += node
        if len(parents) == len(level):
            raise ValueError("%s: max_decoded_node_bytes %d holds one child "
                             "a node" % (root, max_decoded_node_bytes))
        level = parents
    _, offset, length, num_keys, tree_bytes, _ = level[0]
    with open(os.path.join(root, path), "wb") as f:
        f.write(data)
    body = (uuid.uuid4().bytes + _varint(0)
            + _varint(max_inline_value_bytes) + _varint(max_decoded_node_bytes)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0)
            + _file_table(path)
            + _varint(1) + _varint(1) + bytes([height])
            + _varints([0, offset, length, num_keys, tree_bytes,
                        indirect_bytes])
            + struct.pack("<Q", time.time_ns())
            + _varint(0))
    with open(manifest, "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, body))
