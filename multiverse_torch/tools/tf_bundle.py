"""TensorFlow V2 checkpoints (tensor bundles), read with no tensorflow.

A bundle is ``<prefix>.index`` and ``<prefix>.data-NNNNN-of-MMMMM``.
The index is a LevelDB table, sorted by key: a 48-byte footer (the
metaindex and index block handles as varints, padded, then the magic
``0xdb4775248b80fb57``), an index block whose values are the handles of
the data blocks, and data blocks of prefix-compressed entries with a
restart array; each block is followed by its compression type and a
masked crc32c of the block and that type. The key ``""`` holds a
``BundleHeaderProto``; every other key is a tensor's name, whose value
is a ``BundleEntryProto``: its dtype, shape, data shard, offset, size
and the masked crc32c of its bytes. This module decodes both protos
with a minimal protobuf wire-format decoder of its own.

:class:`BundleReader` offers what the converter takes from
``tf.train.load_checkpoint``: ``get_variable_to_shape_map()`` and
``get_tensor(name)``; a checkpoint directory resolves through its
``checkpoint`` file, as ``tf.train.latest_checkpoint`` does. It reads
what ``tf.compat.v1.train.Saver`` writes (TF's bundle writer compresses
no block) in DT_FLOAT, DT_DOUBLE, DT_INT32 and DT_INT64. A compressed
block, a sliced (partitioned) variable, a big-endian bundle, another
dtype, a bad crc or magic, or a truncated file raises ``ValueError``
naming the file (and the key where one is at fault).
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from multiverse_torch.train.ocdbt import crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
_MASK_DELTA = 0xA282EAD8
# TF's DataType enum -> numpy (little-endian)
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
          9: np.dtype("<i8")}
_BIG_ENDIAN = 1


def mask_crc(crc: int) -> int:
    """LevelDB's and TF's masked crc32c."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ------------------------------------------------------------ protobuf


def _varint(data: bytes, pos: int, where: str) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("%s: truncated varint" % where)
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 63:
            raise ValueError("%s: varint too long" % where)


def parse_message(data: bytes, where: str) -> Dict[int, list]:
    """A protobuf message's fields: number -> the values of each
    occurrence (an int for varint, fixed32 and fixed64 fields, bytes for
    length-delimited ones). Groups and unknown wire types raise."""
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _varint(data, pos, where)
        number, wire = tag >> 3, tag & 7
        if number == 0:
            raise ValueError("%s: field number 0" % where)
        if wire == 0:
            value, pos = _varint(data, pos, where)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            if pos + n > len(data):
                raise ValueError("%s: truncated fixed%d field %d"
                                 % (where, 8 * n, number))
            value = int.from_bytes(data[pos:pos + n], "little")
            pos += n
        elif wire == 2:
            n, pos = _varint(data, pos, where)
            if pos + n > len(data):
                raise ValueError("%s: truncated field %d" % (where, number))
            value = bytes(data[pos:pos + n])
            pos += n
        else:
            raise ValueError("%s: wire type %d of field %d is not read"
                             % (where, wire, number))
        fields.setdefault(number, []).append(value)
    return fields


def _last(fields: Dict[int, list], number: int, default=0):
    """A scalar field: its last occurrence wins, as protobuf merges."""
    return fields[number][-1] if number in fields else default


# ------------------------------------------------------- LevelDB table


def _block(data: bytes, handle: Tuple[int, int], where: str) -> bytes:
    """A block's contents, its trailer checked."""
    offset, size = handle
    end = offset + size
    if end + 5 > len(data):
        raise ValueError("%s: truncated: the block at %d (%d bytes and its "
                         "trailer) runs past the file's %d bytes"
                         % (where, offset, size, len(data)))
    contents = data[offset:end]
    kind = data[end]
    crc = struct.unpack("<I", data[end + 1:end + 5])[0]
    if mask_crc(crc32c(data[offset:end + 1])) != crc:
        raise ValueError("%s: crc32c mismatch in the block at %d"
                         % (where, offset))
    if kind != 0:
        raise ValueError("%s: the block at %d is compressed (type %d); "
                         "TF's bundle writer compresses none, and only "
                         "uncompressed blocks are read"
                         % (where, offset, kind))
    return contents


def _block_entries(block: bytes, where: str) -> List[Tuple[bytes, bytes]]:
    """(key, value) of every entry of a block, in order."""
    if len(block) < 4:
        raise ValueError("%s: a block of %d bytes" % (where, len(block)))
    n_restarts = struct.unpack("<I", block[-4:])[0]
    limit = len(block) - 4 * (n_restarts + 1)
    if n_restarts == 0 or limit < 0:
        raise ValueError("%s: a block with %d restart points"
                         % (where, n_restarts))
    restarts = set(struct.unpack("<%dI" % n_restarts, block[limit:-4]))
    out, key, pos, starts = [], b"", 0, set()
    while pos < limit:
        at = pos
        starts.add(at)
        shared, pos = _varint(block, pos, where)
        unshared, pos = _varint(block, pos, where)
        size, pos = _varint(block, pos, where)
        if shared > len(key) or pos + unshared + size > limit \
                or (at in restarts and shared):
            raise ValueError("%s: malformed block entry at %d"
                             % (where, at))
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        out.append((key, block[pos:pos + size]))
        pos += size
    if not restarts <= starts:
        raise ValueError("%s: a restart point is not an entry" % where)
    return out


def _handle(value: bytes, where: str) -> Tuple[int, int]:
    offset, pos = _varint(value, 0, where)
    size, _ = _varint(value, pos, where)
    return offset, size


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of the LevelDB table in ``path``, in key
    order."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError("%s: cannot read: %s" % (path, e)) from e
    if len(data) < FOOTER_BYTES:
        raise ValueError("%s: truncated (%d bytes, less than the footer)"
                         % (path, len(data)))
    footer = data[-FOOTER_BYTES:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != TABLE_MAGIC:
        raise ValueError("%s: bad magic %016x, expected %016x"
                         % (path, magic, TABLE_MAGIC))
    _, pos = _varint(footer, 0, path)           # the metaindex handle
    _, pos = _varint(footer, pos, path)
    index = _handle(footer[pos:], path)
    entries: List[Tuple[bytes, bytes]] = []
    for _, value in _block_entries(_block(data, index, path), path):
        entries.extend(_block_entries(
            _block(data, _handle(value, path), path), path))
    keys = [k for k, _ in entries]
    if any(a >= b for a, b in zip(keys, keys[1:])):
        raise ValueError("%s: the table's keys are not in order" % path)
    return entries


# -------------------------------------------------------------- bundle


def resolve_prefix(path: str) -> str:
    """A bundle's prefix: ``path`` itself, or for a directory the
    ``model_checkpoint_path`` of its ``checkpoint`` file (relative to the
    directory unless absolute), as ``tf.train.latest_checkpoint`` reads
    it."""
    if not os.path.isdir(path):
        return path
    state = os.path.join(path, "checkpoint")
    try:
        with open(state) as f:
            text = f.read()
    except OSError as e:
        raise ValueError("%s: a directory without a readable checkpoint "
                         "file: %s" % (path, e)) from e
    m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', text,
                  re.M)
    if not m:
        raise ValueError("%s: no model_checkpoint_path" % state)
    return os.path.join(path, m.group(1).encode().decode("unicode_escape"))


class _Entry:
    """A BundleEntryProto's fields."""

    def __init__(self, value: bytes, where: str):
        f = parse_message(value, where)
        if 7 in f:
            raise ValueError("%s: a sliced (partitioned) variable; only "
                             "whole tensors are read" % where)
        self.dtype = _last(f, 1)
        self.shape = []
        for shape in f.get(2, []):
            s = parse_message(shape, where)
            if _last(s, 3):
                raise ValueError("%s: a shape of unknown rank" % where)
            self.shape = [_last(parse_message(d, where), 1)
                          for d in s.get(2, [])]
        self.shard = _last(f, 3)
        self.offset = _last(f, 4)
        self.size = _last(f, 5)
        self.crc = _last(f, 6, None)
        if self.dtype not in DTYPES:
            raise ValueError("%s: dtype %d is not read (only DT_FLOAT, "
                             "DT_DOUBLE, DT_INT32, DT_INT64)"
                             % (where, self.dtype))
        if any(d >= 1 << 63 for d in self.shape):
            raise ValueError("%s: a negative dimension in %s"
                             % (where, self.shape))
        n = int(np.prod(self.shape, dtype=np.int64))
        if self.size != n * DTYPES[self.dtype].itemsize:
            raise ValueError("%s: %d bytes for shape %s" % (where, self.size,
                                                          self.shape))
        if self.crc is None:
            raise ValueError("%s: no crc32c" % where)


class BundleReader:
    """The tensors of the bundle at ``path`` (a prefix, or a directory
    holding a ``checkpoint`` file)."""

    def __init__(self, path: str):
        self.prefix = resolve_prefix(path)
        self.index_path = self.prefix + ".index"
        table = read_table(self.index_path)
        if not table or table[0][0] != b"":
            raise ValueError("%s: no bundle header" % self.index_path)
        header = parse_message(table[0][1], self.index_path + " (header)")
        self.num_shards = _last(header, 1)
        if _last(header, 2) == _BIG_ENDIAN:
            raise ValueError("%s: a big-endian bundle; only little-endian "
                             "ones are read" % self.index_path)
        if self.num_shards < 1:
            raise ValueError("%s: %d shards" % (self.index_path,
                                                self.num_shards))
        self._entries: Dict[str, _Entry] = {}
        slices = []
        for key, value in table[1:]:
            if key.startswith(b"\0"):
                # a slice of a partitioned variable, keyed by its encoded
                # name and extent: refused below, naming its variable first
                slices.append(key)
                continue
            try:
                name = key.decode()
            except UnicodeDecodeError:
                raise ValueError("%s: a key that is not UTF-8: %r"
                                 % (self.index_path, key)) from None
            entry = _Entry(value, "%s: %s" % (self.index_path, name))
            if entry.shard >= self.num_shards:
                raise ValueError("%s: %s is in shard %d of %d"
                                 % (self.index_path, name, entry.shard,
                                    self.num_shards))
            self._entries[name] = entry
        if slices:
            raise ValueError("%s: %r is a slice of a partitioned variable; "
                             "only whole tensors are read"
                             % (self.index_path, slices[0]))

    def data_path(self, shard: int) -> str:
        return "%s.data-%05d-of-%05d" % (self.prefix, shard, self.num_shards)

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {name: list(e.shape) for name, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor ``name`` as a numpy array (native byte order);
        ``KeyError`` where the bundle has none."""
        entry: Optional[_Entry] = self._entries.get(name)
        if entry is None:
            raise KeyError("%s: no tensor %s" % (self.index_path, name))
        path = self.data_path(entry.shard)
        try:
            with open(path, "rb") as f:
                f.seek(entry.offset)
                raw = f.read(entry.size)
        except OSError as e:
            raise ValueError("%s: cannot read %s: %s" % (path, name, e)) \
                from e
        if len(raw) != entry.size:
            raise ValueError("%s: truncated: %s has %d of its %d bytes at "
                             "offset %d" % (path, name, len(raw), entry.size,
                                            entry.offset))
        if mask_crc(crc32c(raw)) != entry.crc:
            raise ValueError("%s: crc32c mismatch in %s" % (path, name))
        dtype = DTYPES[entry.dtype]
        return np.frombuffer(raw, dtype).reshape(entry.shape) \
            .astype(dtype.newbyteorder("="))
