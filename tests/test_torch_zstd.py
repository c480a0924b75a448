"""The port's zstd decoder (``multiverse_torch/native/zstd_decode.cpp``)
against ``zstandard``: every drawn payload, compression level and frame
option decodes to the same bytes; skippable frames and frames back to
back; and every malformed input raises ``ValueError`` in a subprocess
that exits cleanly (a crash there would be a failure, not a dead test
worker)."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multiverse_torch.native import zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 128 * 1024
LEVELS = [-5, 1, 3, 19, 22]


def _payload(kind: str, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return bytes(size)
    if kind == "random":
        return rng.bytes(size)
    if kind == "text":
        words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
                 b"trajectory", b"multiverse", b"\n"]
        out = b" ".join(words[i] for i in rng.integers(0, len(words),
                                                       size // 4 + 1))
        return out[:size]
    # f32 weights: zarr's chunks of a checkpoint
    return rng.standard_normal(size // 4 + 1).astype(np.float32).tobytes()[
        :size]


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["zeros", "random", "text", "f32"]),
       size=st.one_of(st.integers(0, 300), st.integers(0, 3 * BLOCK + 77)),
       seed=st.integers(0, 2**31 - 1),
       content_size=st.booleans(), checksum=st.booleans())
def _check_level(level, kind, size, seed, content_size, checksum):
    data = _payload(kind, size, seed)
    frame = zstandard.ZstdCompressor(
        level=level, write_content_size=content_size,
        write_checksum=checksum).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    # without a content size, into a buffer that grows until it fits
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("level", LEVELS)
def test_decoder_equals_zstandard(level):
    """Zeros (RLE blocks), random bytes (raw blocks and literals), text
    and f32 weights (Huffman literals, FSE sequences, repeat offsets and
    tables across blocks), from 0 bytes to several 128 KiB blocks, with
    and without the content size and the checksum."""
    _check_level(level)


@pytest.mark.parametrize("level", LEVELS)
def test_a_large_weight_chunk(level):
    """A 1.5 MB f32 chunk written as orbax writes one (no content size):
    many blocks, each decoded into the one output buffer."""
    data = _payload("f32", 12 * BLOCK + 5, level + 100)
    frame = zstandard.ZstdCompressor(
        level=level, write_content_size=False).compress(data)
    assert zstd.decompress(frame, len(data)) == data


def _skippable(payload: bytes, k: int = 3) -> bytes:
    return struct.pack("<II", 0x184D2A50 + k, len(payload)) + payload


def test_skippable_and_back_to_back_frames():
    """Frames back to back decode to their contents concatenated, with
    skippable frames anywhere among them contributing nothing."""
    parts = [_payload(k, s, i) for i, (k, s) in enumerate(
        [("text", 5000), ("zeros", 200000), ("f32", 70000), ("random", 9)])]
    frames = [zstandard.ZstdCompressor(level=3, write_checksum=i % 2 == 0)
              .compress(p) for i, p in enumerate(parts)]
    joined = (_skippable(b"meta") + frames[0] + frames[1]
              + _skippable(b"", 15) + frames[2] + frames[3]
              + _skippable(bytes(100), 0))
    want = b"".join(parts)
    assert zstd.decompress(joined) == want
    assert zstd.decompress(joined, len(want)) == want
    assert zstd.decompress(_skippable(b"x"), 0) == b""


def _frame(data: bytes, **kw) -> bytes:
    return zstandard.ZstdCompressor(level=3, **kw).compress(data)


def _with_dictionary_id(frame: bytes) -> bytes:
    """The frame with a one-byte dictionary id written into its header
    (a single-segment frame: descriptor, then the id, then the size)."""
    desc = frame[4]
    assert desc & 0x20 and not desc & 3
    return frame[:4] + bytes([desc | 1, 7]) + frame[5:]


TEXT = _payload("text", 50000, 1)
FRAME = _frame(TEXT, write_checksum=True)
FLIPPED = bytearray(FRAME)
FLIPPED[len(FRAME) // 2] ^= 0x10
MALFORMED = {
    # name: (data, size, message)
    "truncated": (FRAME[:len(FRAME) // 2], len(TEXT), "truncated"),
    "no_checksum_bytes": (FRAME[:-2], len(TEXT), "truncated"),
    "flipped_byte": (bytes(FLIPPED), len(TEXT), "malformed"),
    "wrong_checksum": (FRAME[:-1] + bytes([FRAME[-1] ^ 1]), len(TEXT),
                       "checksum"),
    "size_too_small": (FRAME, len(TEXT) - 1, "more than the expected"),
    "size_too_large": (_frame(TEXT, write_content_size=False),
                       len(TEXT) + 1, "decodes to 50000 bytes"),
    "dictionary_id": (_with_dictionary_id(_frame(TEXT)), len(TEXT),
                      "dictionary"),
    "bad_magic": (b"\x00" + FRAME[1:], len(TEXT), "bad magic"),
    # a single-segment frame of 5 bytes whose one block has type 3
    "reserved_block_type": (b"\x28\xb5\x2f\xfd\x20\x05"
                            + (1 | 3 << 1 | 5 << 3).to_bytes(3, "little")
                            + b"abcde", 5, "reserved block type"),
    "empty": (b"", 0, "empty"),
}


def _in_subprocess(code: str, timeout: float = 120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_input_raises_value_error(case, tmp_path):
    """Each malformed frame raises ValueError with its reason; the
    decoding process exits cleanly."""
    data, size, message = MALFORMED[case]
    path = tmp_path / "frame.bin"
    path.write_bytes(data)
    proc = _in_subprocess(
        "from multiverse_torch.native import zstd\n"
        "data = open(%r, 'rb').read()\n"
        "try:\n"
        "    zstd.decompress(data, %d)\n"
        "except ValueError as e:\n"
        "    print('RAISED', e)\n"
        "else:\n"
        "    print('DECODED')\n" % (str(path), size))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout, proc.stdout
    assert message in proc.stdout, proc.stdout


def test_corrupted_frames_never_crash():
    """Thousands of frames with random bytes flipped, cut or inserted:
    each decodes (to the original, or to other bytes where no checksum
    guards it) or raises ValueError; the process never crashes."""
    code = r"""
import numpy as np, zstandard
from multiverse_torch.native import zstd
rng = np.random.default_rng(5)
raised = decoded = 0
sources = [rng.standard_normal(20000).astype(np.float32).tobytes(),
           b' '.join(b'w%d' % i for i in rng.integers(0, 50, 8000)),
           bytes(30000), rng.bytes(3000)]
for trial in range(3000):
    data = sources[trial % 4]
    frame = bytearray(zstandard.ZstdCompressor(
        level=int(rng.choice([-5, 1, 3, 19])),
        write_checksum=bool(trial % 3),
        write_content_size=bool(trial % 2)).compress(data))
    for _ in range(int(rng.integers(1, 4))):
        op, at = int(rng.integers(0, 3)), int(rng.integers(0, len(frame)))
        if op == 0:
            frame[at] ^= 1 << int(rng.integers(0, 8))
        elif op == 1:
            del frame[at:]
            if not frame:
                frame = bytearray(b'\x28')
        else:
            frame.insert(at, int(rng.integers(0, 256)))
    try:
        zstd.decompress(bytes(frame), len(data))
        decoded += 1
    except ValueError:
        raised += 1
print('RAISED', raised, 'DECODED', decoded)
"""
    proc = _in_subprocess(code, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout
    assert int(proc.stdout.split()[1]) > 2000, proc.stdout
