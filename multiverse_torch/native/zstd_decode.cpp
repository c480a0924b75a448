// Zstandard frame decoder (RFC 8878), for reading the zarr chunks and
// OCDBT nodes of the JAX package's orbax checkpoints without a zstd
// library.
//
// Covers what a writer may emit: raw, RLE and compressed blocks;
// literals raw, RLE, Huffman-compressed or treeless, in 1 or 4 streams,
// with direct or FSE-coded Huffman weights; sequences in predefined,
// RLE, FSE-compressed or repeat modes; the three repeat offsets;
// skippable frames; frames back to back; the XXH64 content checksum,
// verified when present. A frame that names a dictionary is refused.
//
// The whole output is one flat buffer, so the window is the frame's
// output so far: a match may reach back no further than that, nor than
// the frame's window size. Every read of the input and every write of
// the output is bounds-checked; malformed input returns -1 with a
// message, never reads or writes outside the buffers it was given.
//
// Build: g++ -O3 -shared -fPIC -o libmvt_zstd.so zstd_decode.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the bit readers assume a little-endian host");

namespace {

struct Corrupt {
  const char* msg;
};

// The output does not fit the buffer the caller gave.
struct Overflow {};

[[noreturn]] void fail(const char* msg) { throw Corrupt{msg}; }

inline void check(bool ok, const char* msg) {
  if (!ok) fail(msg);
}

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;

int highest_bit(uint64_t v) {  // floor(log2(v)); v > 0
  return 63 - __builtin_clzll(v);
}

// ------------------------------------------------------------- readers

// Bytes read forward, every read bounds-checked.
struct ByteReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;

  size_t left() const { return n - pos; }
  const uint8_t* take(size_t k, const char* what) {
    check(k <= left(), what);
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
  uint64_t le(size_t k, const char* what) {  // k <= 8
    const uint8_t* b = take(k, what);
    uint64_t v = 0;
    for (size_t i = 0; i < k; i++) v |= uint64_t(b[i]) << (8 * i);
    return v;
  }
  uint8_t byte(const char* what) { return *take(1, what); }
};

// Bits read forward, least significant first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;

  uint32_t read(int k) {  // k <= 24
    check(bit + size_t(k) <= n * 8, "FSE table description truncated");
    uint32_t v = 0;
    for (int i = 0; i < k; i++, bit++)
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  void rewind(int k) { bit -= size_t(k); }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A bitstream read backward from its last set bit (Huffman and FSE
// streams). Bits below the start read as 0, and pos goes negative, as
// RFC 8878 4.2.2 and 4.1 describe.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;

  BackwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    check(n > 0, "empty bitstream");
    uint8_t last = p[n - 1];
    check(last != 0, "bitstream has no end mark");
    pos = int64_t(n) * 8 - (8 - highest_bit(last));
  }
  uint64_t peek_at(int64_t at, int k) const {  // 0 <= at < n*8, k <= 56
    const size_t b = size_t(at >> 3);
    uint64_t w = 0;
    if (b + 8 <= n) {
      std::memcpy(&w, p + b, 8);
    } else {
      for (size_t i = b; i < n; i++) w |= uint64_t(p[i]) << (8 * (i - b));
    }
    w >>= (at & 7);
    return k == 0 ? 0 : (w & ((uint64_t(1) << k) - 1));
  }
  uint64_t read(int k) {  // k <= 48
    pos -= k;
    if (pos >= 0) return peek_at(pos, k);
    int64_t have = int64_t(k) + pos;  // bits at or above bit 0
    if (have <= 0) return 0;
    return peek_at(0, int(have)) << (-pos);
  }
};

// --------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t ld64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t ld32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xmerge(uint64_t h, uint64_t v) {
  h ^= xround(0, v);
  return h * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, ld64(p));
      v2 = xround(v2, ld64(p + 8));
      v3 = xround(v3, ld64(p + 16));
      v4 = xround(v4, ld64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xround(0, ld64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(ld32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------------- FSE

struct FseTable {
  int log = -1;  // -1: no table yet (a repeat mode has nothing to repeat)
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

// Normalised counts -> decoding table (RFC 8878 4.1.1).
void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint32_t> next(size_t(nsym), 0);
  uint32_t high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      check(high > 0, "FSE table overfull");
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint32_t(norm[s]);
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  check(pos == 0, "FSE table spread does not close");
  for (uint32_t i = 0; i < size; i++) {
    uint32_t d = next[t.sym[i]]++;
    check(d > 0, "FSE table state without a count");
    int nb = log - highest_bit(d);
    check(nb >= 0, "FSE table state overflows");
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((d << nb) - size);
  }
}

void fse_rle(FseTable& t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// An FSE table description read forward from `r` (RFC 8878 4.1.1).
void fse_read(FseTable& t, ByteReader& r, int max_log, int max_sym) {
  ForwardBits b{r.p + r.pos, r.left()};
  const int log = 5 + int(b.read(4));
  check(log <= max_log, "FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int s = 0;
  while (remaining > 0) {
    check(s <= max_sym, "FSE table has too many symbols");
    const int bits = highest_bit(uint64_t(remaining) + 1) + 1;
    uint32_t v = b.read(bits);
    const uint32_t low_mask = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((v & low_mask) < threshold) {
      b.rewind(1);
      v &= low_mask;
    } else if (v > low_mask) {
      v -= threshold;
    }
    const int proba = int(v) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        int rep = int(b.read(2));
        for (int i = 0; i < rep; i++) {
          check(s <= max_sym, "FSE table has too many symbols");
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  check(remaining == 0, "FSE counts do not sum to the table size");
  r.pos += b.bytes_used();
  fse_build(t, norm, s, log);
}

// ------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;  // 0: no table yet (treeless literals need one)
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> entry;  // sym | nbits << 8, one load a symbol
};

void huf_from_weights(HufTable& t, const uint8_t* w, int n) {
  check(n >= 1 && n <= 255, "Huffman weight count out of range");
  uint32_t total = 0;
  for (int i = 0; i < n; i++) {
    check(w[i] <= 11, "Huffman weight too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  check(total > 0, "Huffman weights all zero");
  const int max_bits = highest_bit(total) + 1;
  check(max_bits <= 11, "Huffman table too deep");
  const uint32_t left = (1u << max_bits) - total;
  check((left & (left - 1)) == 0, "Huffman weights leave no power of two");
  uint8_t bits[256];
  const int nsym = n + 1;
  for (int i = 0; i < n; i++) bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
  bits[n] = uint8_t(max_bits + 1 - (highest_bit(left) + 1));
  uint32_t count[13] = {0};
  for (int i = 0; i < nsym; i++) count[bits[i]]++;
  const uint32_t size = 1u << max_bits;
  t.max_bits = max_bits;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t start[13];
  start[max_bits] = 0;
  for (int i = max_bits; i >= 1; i--) {
    start[i - 1] = start[i] + count[i] * (1u << (max_bits - i));
    check(start[i - 1] <= size, "Huffman codes overflow the table");
    std::memset(t.nbits.data() + start[i], i, start[i - 1] - start[i]);
  }
  check(start[0] == size, "Huffman codes do not fill the table");
  for (int i = 0; i < nsym; i++) {
    if (!bits[i]) continue;
    const uint32_t len = 1u << (max_bits - bits[i]);
    std::memset(&t.sym[start[bits[i]]], i, len);
    start[bits[i]] += len;
  }
  t.entry.resize(size);
  for (uint32_t i = 0; i < size; i++)
    t.entry[i] = uint16_t(t.sym[i] | (t.nbits[i] << 8));
}

// Huffman tree description (RFC 8878 4.2.1); returns its size.
size_t huf_read(HufTable& t, const uint8_t* p, size_t n) {
  ByteReader r{p, n};
  const uint8_t head = r.byte("Huffman tree description truncated");
  uint8_t w[256];
  int nw = 0;
  if (head >= 128) {
    nw = head - 127;
    const uint8_t* b = r.take(size_t(nw + 1) / 2, "Huffman weights truncated");
    for (int i = 0; i < nw; i++)
      w[i] = (i & 1) ? (b[i / 2] & 15) : (b[i / 2] >> 4);
  } else {
    check(head > 0, "empty FSE-coded Huffman weights");
    ByteReader fr{r.take(head, "Huffman weights truncated"), head};
    FseTable ft;
    fse_read(ft, fr, 6, 255);
    BackwardBits bs(fr.p + fr.pos, fr.left());
    const uint32_t mask = (1u << ft.log) - 1;
    uint32_t s1 = uint32_t(bs.read(ft.log)) & mask;
    uint32_t s2 = uint32_t(bs.read(ft.log)) & mask;
    for (;;) {
      check(nw < 255, "too many Huffman weights");
      w[nw++] = ft.sym[s1];
      s1 = (ft.base[s1] + uint32_t(bs.read(ft.nbits[s1]))) & mask;
      if (bs.pos < 0) {
        check(nw < 255, "too many Huffman weights");
        w[nw++] = ft.sym[s2];
        break;
      }
      check(nw < 255, "too many Huffman weights");
      w[nw++] = ft.sym[s2];
      s2 = (ft.base[s2] + uint32_t(bs.read(ft.nbits[s2]))) & mask;
      if (bs.pos < 0) {
        check(nw < 255, "too many Huffman weights");
        w[nw++] = ft.sym[s1];
        break;
      }
    }
  }
  huf_from_weights(t, w, nw);
  return r.pos;
}

// Huffman streams (RFC 8878 4.2.2), decoded by peeking each symbol's
// max_bits window and consuming its code's bits. Each stream is copied
// between 8 zero bytes on either side, so the 64-bit load of any window
// stays inside the copy and reads zeros below the stream's start. A
// valid stream has bits left before each of its symbols and none after
// the last; pos > 0 is checked before every symbol, which also keeps
// every load inside the copy. NS streams are interleaved, so their
// decodes overlap.
struct PaddedStream {
  std::vector<uint8_t> buf;
  int64_t pos;  // bits not yet consumed
};

void pad_stream(PaddedStream& s, const uint8_t* p, size_t n) {
  check(n > 0, "empty bitstream");
  check(p[n - 1] != 0, "bitstream has no end mark");
  s.buf.assign(n + 16, 0);
  std::memcpy(s.buf.data() + 8, p, n);
  s.pos = int64_t(n) * 8 - (8 - highest_bit(p[n - 1]));
}

inline uint8_t huf_symbol(const HufTable& t, PaddedStream& s,
                          uint32_t mask) {
  check(s.pos > 0, "Huffman stream too short");
  const int64_t at = s.pos - t.max_bits + 64;  // bits into the copy
  uint64_t w;
  std::memcpy(&w, s.buf.data() + (at >> 3), 8);
  const uint16_t e = t.entry[(w >> (at & 7)) & mask];
  s.pos -= e >> 8;
  return uint8_t(e);
}

template <int NS>
void huf_streams(const HufTable& t, const uint8_t* const* p, const size_t* n,
                 uint8_t* const* out, const size_t* count) {
  PaddedStream s[NS];
  size_t common = count[0];
  for (int k = 0; k < NS; k++) {
    pad_stream(s[k], p[k], n[k]);
    if (count[k] < common) common = count[k];
  }
  const uint32_t mask = (1u << t.max_bits) - 1;
  for (size_t i = 0; i < common; i++)
    for (int k = 0; k < NS; k++) out[k][i] = huf_symbol(t, s[k], mask);
  for (int k = 0; k < NS; k++) {
    for (size_t i = common; i < count[k]; i++)
      out[k][i] = huf_symbol(t, s[k], mask);
    check(s[k].pos == 0, "Huffman stream not consumed exactly");
  }
}

// ----------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,   32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83,  99,  131, 259,  515,  1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// One frame's state: tables and repeat offsets carried from block to
// block.
struct Frame {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  uint64_t window = 0;
  std::vector<uint8_t> lit;
};

struct Out {
  uint8_t* p;
  size_t cap;
  size_t pos;
  size_t frame_start;
};

void seq_table(FseTable& t, int mode, ByteReader& r, const int16_t* norm,
               int nnorm, int norm_log, int max_log, int max_sym) {
  switch (mode) {
    case 0:
      fse_build(t, norm, nnorm, norm_log);
      break;
    case 1: {
      uint8_t s = r.byte("RLE sequence symbol missing");
      check(s <= max_sym, "RLE sequence symbol out of range");
      fse_rle(t, s);
      break;
    }
    case 2:
      fse_read(t, r, max_log, max_sym);
      break;
    default:
      check(t.log >= 0, "repeat mode with no previous table");
  }
}

// Literals section (RFC 8878 3.1.1.3.1); returns its size in bytes.
size_t read_literals(Frame& f, const uint8_t* p, size_t n, size_t* nlit) {
  ByteReader r{p, n};
  const uint8_t b0 = r.byte("literals header truncated");
  const int type = b0 & 3, sf = (b0 >> 2) & 3;
  size_t regen, csize = 0;
  int streams = 1;
  if (type < 2) {
    if (sf == 0 || sf == 2) {
      regen = b0 >> 3;
    } else if (sf == 1) {
      regen = (b0 >> 4) + (size_t(r.byte("literals header truncated")) << 4);
    } else {
      regen = (b0 >> 4) + (r.le(2, "literals header truncated") << 4);
    }
  } else {
    int hb = sf < 2 ? 3 : sf + 2, bits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    streams = sf == 0 ? 1 : 4;
    uint64_t h = b0 | (r.le(size_t(hb - 1), "literals header truncated") << 8);
    regen = size_t((h >> 4) & ((1u << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
  }
  check(regen <= kBlockMax, "literals larger than a block");
  f.lit.resize(regen);
  *nlit = regen;
  if (type == 0) {
    const uint8_t* raw = r.take(regen, "raw literals truncated");
    if (regen) std::memcpy(f.lit.data(), raw, regen);
    return r.pos;
  }
  if (type == 1) {
    uint8_t b = r.byte("RLE literal missing");
    if (regen) std::memset(f.lit.data(), b, regen);
    return r.pos;
  }
  const uint8_t* c = r.take(csize, "compressed literals truncated");
  size_t used = 0;
  if (type == 2) {
    used = huf_read(f.huf, c, csize);
  } else {
    check(f.huf.max_bits > 0, "treeless literals with no previous table");
  }
  const uint8_t* s = c + used;
  const size_t total = csize - used;
  if (streams == 1) {
    uint8_t* out = f.lit.data();
    huf_streams<1>(f.huf, &s, &total, &out, &regen);
    return r.pos;
  }
  check(total >= 6, "4-stream jump table truncated");
  size_t len[4];
  len[0] = size_t(s[0]) | (size_t(s[1]) << 8);
  len[1] = size_t(s[2]) | (size_t(s[3]) << 8);
  len[2] = size_t(s[4]) | (size_t(s[5]) << 8);
  const size_t sum3 = len[0] + len[1] + len[2];
  check(sum3 + 6 <= total, "4-stream jump table exceeds literals");
  len[3] = total - 6 - sum3;
  const size_t seg = (regen + 3) / 4;
  check(3 * seg <= regen, "4-stream literals too short");
  const uint8_t* q[4] = {s + 6, s + 6 + len[0], s + 6 + len[0] + len[1],
                         s + 6 + sum3};
  uint8_t* out[4];
  size_t cnt[4];
  for (int i = 0; i < 4; i++) {
    out[i] = f.lit.data() + i * seg;
    cnt[i] = i < 3 ? seg : regen - 3 * seg;
  }
  huf_streams<4>(f.huf, q, len, out, cnt);
  return r.pos;
}

inline void room(const Out& o, size_t k) {
  if (k > o.cap - o.pos) throw Overflow{};
}

void copy_literals(Out& o, const uint8_t* src, size_t k) {
  room(o, k);
  if (k) std::memcpy(o.p + o.pos, src, k);
  o.pos += k;
}

void compressed_block(Frame& f, Out& o, const uint8_t* p, size_t n) {
  const size_t block_start = o.pos;
  size_t nlit = 0;
  const size_t lsz = read_literals(f, p, n, &nlit);
  ByteReader r{p + lsz, n - lsz};
  const uint8_t b0 = r.byte("sequences header truncated");
  size_t nseq;
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    nseq = (size_t(b0 - 128) << 8) + r.byte("sequences header truncated");
  } else {
    nseq = size_t(r.le(2, "sequences header truncated")) + 0x7F00;
  }
  const uint8_t* lit = f.lit.data();
  if (nseq == 0) {
    check(r.left() == 0, "bytes after an empty sequences section");
    copy_literals(o, lit, nlit);
    return;
  }
  const uint8_t modes = r.byte("sequence modes missing");
  check((modes & 3) == 0, "reserved sequence mode bits set");
  seq_table(f.ll, modes >> 6, r, kLLNorm, 36, 6, 9, 35);
  seq_table(f.of, (modes >> 4) & 3, r, kOFNorm, 29, 5, 8, 31);
  seq_table(f.ml, (modes >> 2) & 3, r, kMLNorm, 53, 6, 9, 52);
  BackwardBits bs(r.p + r.pos, r.left());
  const uint32_t llm = (1u << f.ll.log) - 1, ofm = (1u << f.of.log) - 1,
                 mlm = (1u << f.ml.log) - 1;
  uint32_t ls = uint32_t(bs.read(f.ll.log)) & llm;
  uint32_t os = uint32_t(bs.read(f.of.log)) & ofm;
  uint32_t ms = uint32_t(bs.read(f.ml.log)) & mlm;
  size_t lp = 0;
  for (size_t i = 0; i < nseq; i++) {
    const uint8_t oc = f.of.sym[os], lc = f.ll.sym[ls], mc = f.ml.sym[ms];
    check(lc <= 35 && mc <= 52 && oc <= 31, "sequence code out of range");
    const uint64_t ov = (uint64_t(1) << oc) + bs.read(oc);
    const size_t ml = kMLBase[mc] + size_t(bs.read(kMLBits[mc]));
    const size_t ll = kLLBase[lc] + size_t(bs.read(kLLBits[lc]));
    if (i + 1 < nseq) {
      ls = (f.ll.base[ls] + uint32_t(bs.read(f.ll.nbits[ls]))) & llm;
      ms = (f.ml.base[ms] + uint32_t(bs.read(f.ml.nbits[ms]))) & mlm;
      os = (f.of.base[os] + uint32_t(bs.read(f.of.nbits[os]))) & ofm;
    }
    uint64_t off;
    if (ov > 3) {
      off = ov - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = off;
    } else {
      const unsigned idx = unsigned(ov - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        off = f.rep[0];
      } else {
        off = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
        if (idx > 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = off;
      }
    }
    check(ll <= nlit - lp, "sequence reads past the literals");
    copy_literals(o, lit + lp, ll);
    lp += ll;
    const size_t produced = o.pos - o.frame_start;
    check(off >= 1 && off <= produced && off <= f.window,
          "match offset outside the window");
    room(o, ml);
    uint8_t* d = o.p + o.pos;
    const uint8_t* s = d - off;
    if (off >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (size_t k = 0; k < ml; k++) d[k] = s[k];
    }
    o.pos += ml;
    check(o.pos - block_start <= kBlockMax, "block larger than 128 KiB");
  }
  check(bs.pos == 0, "sequence bitstream not consumed exactly");
  copy_literals(o, lit + lp, nlit - lp);
  check(o.pos - block_start <= kBlockMax, "block larger than 128 KiB");
}

struct Header {
  bool has_size = false, checksum = false;
  uint64_t size = 0, window = 0;
};

Header frame_header(ByteReader& r) {
  Header h;
  const uint8_t d = r.byte("frame header truncated");
  const int fcs_flag = d >> 6, single = (d >> 5) & 1, did_flag = d & 3;
  check(((d >> 3) & 1) == 0, "reserved frame header bit set");
  h.checksum = (d >> 2) & 1;
  if (!single) {
    const uint8_t wd = r.byte("window descriptor missing");
    const int exp = wd >> 3, mant = wd & 7;
    check(exp <= 31, "window too large");
    const uint64_t base = uint64_t(1) << (10 + exp);
    h.window = base + (base / 8) * uint64_t(mant);
  }
  const size_t did_bytes = did_flag == 3 ? 4 : size_t(did_flag);
  if (did_bytes) {
    check(r.le(did_bytes, "dictionary id truncated") == 0,
          "frame names a dictionary; none is supported");
  }
  const size_t fcs_bytes =
      fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
  if (fcs_bytes) {
    h.has_size = true;
    h.size = r.le(fcs_bytes, "frame content size truncated");
    if (fcs_bytes == 2) h.size += 256;
  }
  if (single) h.window = h.size;
  return h;
}

void decode_frame(ByteReader& r, Out& o) {
  const Header h = frame_header(r);
  Frame f;
  f.window = h.window;
  o.frame_start = o.pos;
  if (h.has_size && h.size > o.cap - o.pos) throw Overflow{};
  for (;;) {
    const uint32_t bh = uint32_t(r.le(3, "block header truncated"));
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    check(bsize <= kBlockMax, "block larger than 128 KiB");
    if (type == 0) {
      copy_literals(o, r.take(bsize, "raw block truncated"), bsize);
    } else if (type == 1) {
      const uint8_t b = r.byte("RLE block truncated");
      room(o, bsize);
      if (bsize) std::memset(o.p + o.pos, b, bsize);
      o.pos += bsize;
    } else if (type == 2) {
      const uint8_t* block = r.take(bsize, "compressed block truncated");
      compressed_block(f, o, block, bsize);
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  const size_t produced = o.pos - o.frame_start;
  if (h.has_size) check(produced == h.size, "frame content size mismatch");
  if (h.checksum) {
    const uint32_t want = uint32_t(r.le(4, "content checksum truncated"));
    check(uint32_t(xxh64(o.p + o.frame_start, produced)) == want,
          "content checksum mismatch");
  }
}

// Skip one frame without decoding it; returns its content size, or -1
// where the frame carries none (0 for a skippable frame).
int64_t skip_frame(ByteReader& r) {
  const uint32_t magic = uint32_t(r.le(4, "frame magic truncated"));
  if ((magic & kSkippableMask) == kSkippableMagic) {
    r.take(size_t(r.le(4, "skippable frame size truncated")),
           "skippable frame truncated");
    return 0;
  }
  check(magic == kFrameMagic, "not a zstd frame (bad magic)");
  const Header h = frame_header(r);
  for (;;) {
    const uint32_t bh = uint32_t(r.le(3, "block header truncated"));
    const int type = (bh >> 1) & 3;
    check(type != 3, "reserved block type");
    r.take(type == 1 ? 1 : size_t(bh >> 3), "block truncated");
    if (bh & 1) break;
  }
  if (h.checksum) r.take(4, "content checksum truncated");
  if (!h.has_size) return -1;
  check(h.size <= uint64_t(INT64_MAX), "frame content size too large");
  return int64_t(h.size);
}

void set_err(char* err, size_t errlen, const char* msg) {
  if (err && errlen) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

// The summed content size of every frame in src; -1 where a frame
// carries none; -2 on malformed input (message in err).
extern "C" int64_t mvt_zstd_content_size(const uint8_t* src, size_t n,
                                         char* err, size_t errlen) {
  try {
    ByteReader r{src, n};
    check(n > 0, "no zstd frame in an empty input");
    int64_t total = 0;
    bool unknown = false;
    while (r.left()) {
      const int64_t s = skip_frame(r);
      if (s < 0) {
        unknown = true;
      } else {
        check(total <= INT64_MAX - s, "content size overflows");
        total += s;
      }
    }
    return unknown ? -1 : total;
  } catch (const Corrupt& c) {
    set_err(err, errlen, c.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return -2;
}

// Decode every frame of src into dst[0, cap); returns the bytes written,
// -1 on malformed input (message in err), or -2 where the output does
// not fit in cap bytes.
extern "C" int64_t mvt_zstd_decompress(const uint8_t* src, size_t n,
                                       uint8_t* dst, size_t cap, char* err,
                                       size_t errlen) {
  try {
    ByteReader r{src, n};
    Out o{dst, cap, 0, 0};
    check(n > 0, "no zstd frame in an empty input");
    while (r.left()) {
      const uint32_t magic = uint32_t(r.le(4, "frame magic truncated"));
      if ((magic & kSkippableMask) == kSkippableMagic) {
        r.take(size_t(r.le(4, "skippable frame size truncated")),
               "skippable frame truncated");
        continue;
      }
      check(magic == kFrameMagic, "not a zstd frame (bad magic)");
      decode_frame(r, o);
    }
    return int64_t(o.pos);
  } catch (const Overflow&) {
    set_err(err, errlen, "output larger than the buffer");
    return -2;
  } catch (const Corrupt& c) {
    set_err(err, errlen, c.msg);
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
  }
  return -1;
}
