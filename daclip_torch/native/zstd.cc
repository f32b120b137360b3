// daclip_torch native zstd: a Zstandard frame decoder written to RFC 8878,
// and CRC-32C, for reading orbax checkpoints (OCDBT nodes and zarr chunks)
// with no compression library on the machine.
//
// Scope: every part of RFC 8878 but dictionaries. Raw, RLE and compressed
// blocks; Huffman literals with direct or FSE-coded weights, one or four
// streams, and treeless (repeated) tables; FSE sequence tables predefined,
// RLE, compressed or repeated; the three repeat offsets; several frames in
// a row and skippable frames; the frame content size when present and the
// XXH64 content checksum when its flag is set. A frame that names a
// dictionary is refused.
//
// The whole output is one buffer the caller sized: a match may reach back to
// any byte of its own frame, so no window is kept. Every read is bounded by
// its input and every write by the caller's capacity; a malformed or
// truncated input returns an error and nothing is to be taken from the
// buffer.
//
// Python binding: daclip_torch/utils/zstd.py (ctypes; built there at first
// use).
// Build: g++ -O3 -fPIC -shared -std=c++17 -o libzstd_dec.so zstd.cc

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <new>

namespace {

constexpr int kMsgLen = 256;
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kMaxSymbols = 256;

struct Corrupt {
  const char* what;
};
struct TooSmall {};

[[noreturn]] void fail(const char* what) { throw Corrupt{what}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
inline uint64_t le64(const uint8_t* p) { return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32; }

// Forward reader over [p, end).
struct Bytes {
  const uint8_t* p;
  const uint8_t* end;
  size_t left() const { return size_t(end - p); }
  const uint8_t* take(size_t n, const char* what) {
    if (left() < n) fail(what);
    const uint8_t* r = p;
    p += n;
    return r;
  }
  uint8_t byte(const char* what) { return *take(1, what); }
};

// Backward bit stream (RFC 8878 4.1.2): read from the end, starting below
// the highest set bit of the last byte. Bits below the start read as 0.
struct BackBits {
  const uint8_t* s;
  size_t n;
  int64_t pos;
  BackBits(const uint8_t* s_, size_t n_) : s(s_), n(n_) {
    if (n == 0) fail("empty bitstream");
    if (s[n - 1] == 0) fail("bitstream without its end mark");
    pos = int64_t(n) * 8 - 8 + highbit(s[n - 1]);
  }
  inline uint64_t at(int64_t bit, int nb) const {  // nb <= 56
    size_t byte = size_t(bit >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, s + byte, 8);
    } else {
      v = 0;
      for (size_t i = byte; i < n; ++i) v |= uint64_t(s[i]) << (8 * (i - byte));
    }
    return (v >> (bit & 7)) & ((uint64_t(1) << nb) - 1);
  }
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    pos -= nb;
    if (pos >= 0) return at(pos, nb);
    int have = int(nb + pos);
    if (have <= 0) return 0;
    return at(0, have) << (-pos);
  }
};

// FSE decoding table (RFC 8878 4.1.1).
struct Fse {
  int log = -1;  // -1: no table yet
  uint8_t sym[512];
  uint8_t nb[512];
  uint16_t base[512];
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  uint16_t next[kMaxSymbols];
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table does not fill its states");
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    t.nb[i] = uint8_t(log - highbit(d));
    t.base[i] = uint16_t((d << t.nb[i]) - size);
  }
  t.log = log;
}

void fse_rle(Fse& t, uint8_t symbol) {
  t.sym[0] = symbol;
  t.nb[0] = 0;
  t.base[0] = 0;
  t.log = 0;
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t fse_header(Fse& t, const uint8_t* p, size_t n, int max_log, int max_sym) {
  const int64_t limit = int64_t(n) * 8;
  int64_t off = 0;
  auto bits = [&](int nb) -> uint32_t {  // bits past the end read as 0
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      int64_t b = off + i;
      if (b < limit) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    off += nb;
    return v;
  };
  const int log = int(bits(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  int16_t norm[kMaxSymbols + 3];
  int remaining = 1 << log, nsym = 0;
  while (remaining > 0) {
    if (nsym >= max_sym) fail("FSE table has too many symbols");
    const int nbits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = bits(nbits);
    const uint32_t lower = (1u << (nbits - 1)) - 1;
    const uint32_t threshold = (1u << nbits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      --off;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    const int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        const uint32_t rep = bits(2);
        for (uint32_t i = 0; i < rep; ++i) {
          if (nsym >= max_sym) fail("FSE table has too many symbols");
          norm[nsym++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  if (off > limit) fail("FSE table description truncated");
  fse_build(t, norm, nsym, log);
  return size_t((off + 7) >> 3);
}

// Huffman decoding table (RFC 8878 4.2.1).
struct Huf {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << 11];
  uint8_t nb[1 << 11];
  uint16_t dt[1 << 11];  // sym | nb << 8, one load a symbol
};

void huf_from_weights(Huf& h, uint8_t* w, int n) {
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > 11) fail("Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights leave no power of two for the last symbol");
  if (n >= kMaxSymbols) fail("too many Huffman symbols");
  w[n++] = uint8_t(highbit(left) + 1);
  int count[13] = {0};
  for (int i = 0; i < n; ++i)
    if (w[i]) ++count[max_bits + 1 - w[i]];
  int start[13];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + count[b] * (1 << (max_bits - b));
    std::memset(h.nb + start[b], b, size_t(start[b - 1] - start[b]));
  }
  if (start[0] != (1 << max_bits)) fail("Huffman table does not fill its states");
  for (int i = 0; i < n; ++i) {
    if (!w[i]) continue;
    const int b = max_bits + 1 - w[i], len = 1 << (max_bits - b);
    std::memset(h.sym + start[b], i, size_t(len));
    start[b] += len;
  }
  for (int i = 0; i < (1 << max_bits); ++i) h.dt[i] = uint16_t(h.sym[i] | h.nb[i] << 8);
  h.max_bits = max_bits;
}

// A Huffman tree description; returns the bytes it took.
size_t huf_header(Huf& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("Huffman tree description truncated");
  const uint8_t head = p[0];
  uint8_t w[kMaxSymbols + 1] = {0};
  int nw = 0;
  size_t used;
  if (head >= 128) {
    nw = head - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (n < used) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(head);
    if (head == 0 || n < used) fail("Huffman FSE weights truncated");
    Fse t;
    const size_t hs = fse_header(t, p + 1, head, 6, kMaxSymbols);
    if (hs >= head) fail("Huffman FSE weights have no bitstream");
    BackBits br(p + 1 + hs, head - hs);
    uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
    for (;;) {
      if (nw + 2 > kMaxSymbols - 1) fail("too many Huffman weights");
      w[nw++] = t.sym[s1];
      s1 = t.base[s1] + uint32_t(br.read(t.nb[s1]));
      if (br.pos < 0) {
        w[nw++] = t.sym[s2];
        break;
      }
      w[nw++] = t.sym[s2];
      s2 = t.base[s2] + uint32_t(br.read(t.nb[s2]));
      if (br.pos < 0) {
        w[nw++] = t.sym[s1];
        break;
      }
    }
  }
  huf_from_weights(h, w, nw);
  return used;
}

// Huffman streams. The decoding state is the next max_bits bits below a
// stream's read position, so a symbol is a table lookup on them and the
// position moves down by its code length; a stream must end exactly at bit 0.
// Symbols decode five at a time from one 64-bit load (57-63 bits below the
// position, five codes of at most 11 bits), four streams interleaved.
struct HufStream {
  const uint8_t* s;
  size_t n;
  int64_t p;
  uint8_t* out;
  size_t len, i;
};

inline uint64_t load_below(const HufStream& st, int& top) {
  const size_t b = size_t(st.p >> 3) - 7;
  uint64_t v;
  std::memcpy(&v, st.s + b, 8);
  top = int(st.p - int64_t(8 * b));
  return v;
}

void huf_finish(const Huf& h, HufStream& st) {
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  while (st.i < st.len && st.p >= 64) {
    int top;
    const uint64_t v = load_below(st, top);
    const int64_t base = st.p - top;
    while (top >= mb && st.i < st.len) {
      const uint32_t idx = uint32_t(v >> (top - mb)) & mask;
      st.out[st.i++] = h.sym[idx];
      top -= h.nb[idx];
    }
    st.p = base + top;
  }
  BackBits br(st.s, st.n);
  for (; st.i < st.len; ++st.i) {
    uint32_t idx = 0;
    if (st.p >= mb) {
      idx = uint32_t(br.at(st.p - mb, mb));
    } else if (st.p > 0) {
      idx = uint32_t(br.at(0, int(st.p)) << (mb - st.p));
    }
    st.out[st.i] = h.sym[idx];
    st.p -= h.nb[idx];
  }
  if (st.p != 0) fail("Huffman stream length does not match its symbols");
}

HufStream huf_open(const uint8_t* s, size_t n, uint8_t* out, size_t len) {
  BackBits br(s, n);
  return HufStream{s, n, br.pos, out, len, 0};
}

void huf_streams(const Huf& h, HufStream* st, int count) {
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  if (count == 4) {
    for (;;) {
      bool ok = true;
      for (int k = 0; k < 4; ++k) ok &= st[k].p >= 64 && st[k].len - st[k].i >= 5;
      if (!ok) break;
      int top[4];
      uint64_t v[4];
      int64_t base[4];
      for (int k = 0; k < 4; ++k) {
        v[k] = load_below(st[k], top[k]);
        base[k] = st[k].p - top[k];
      }
      for (int r = 0; r < 5; ++r) {
        for (int k = 0; k < 4; ++k) {
          const uint16_t e = h.dt[uint32_t(v[k] >> (top[k] - mb)) & mask];
          st[k].out[st[k].i++] = uint8_t(e);
          top[k] -= e >> 8;
        }
      }
      for (int k = 0; k < 4; ++k) st[k].p = base[k] + top[k];
    }
  }
  for (int k = 0; k < count; ++k) huf_finish(h, st[k]);
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// XXH64 with seed 0 (the frame checksum keeps its low 32 bits).
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct FrameHeader {
  bool checksum = false;
  bool has_size = false;
  uint64_t content_size = 0;
  uint64_t window = 0;
};

// Reads a frame header after its magic number.
FrameHeader frame_header(Bytes& in) {
  FrameHeader f;
  const uint8_t fhd = in.byte("frame header truncated");
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("frame header's reserved bit is set");
  f.checksum = (fhd >> 2) & 1;
  if (!single) {
    const uint8_t wd = in.byte("frame header truncated");
    const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
    f.window = base + (base >> 3) * (wd & 7);
  }
  static const int kDidSize[4] = {0, 1, 2, 4};
  const uint8_t* d = in.take(size_t(kDidSize[did_flag]), "frame header truncated");
  uint32_t did = 0;
  for (int i = 0; i < kDidSize[did_flag]; ++i) did |= uint32_t(d[i]) << (8 * i);
  if (did != 0) fail("frame needs a dictionary");
  static const int kFcsSize[4] = {0, 2, 4, 8};
  const int fcs_size = (fcs_flag == 0 && single) ? 1 : kFcsSize[fcs_flag];
  if (fcs_size) {
    const uint8_t* s = in.take(size_t(fcs_size), "frame header truncated");
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; ++i) v |= uint64_t(s[i]) << (8 * i);
    if (fcs_size == 2) v += 256;
    f.has_size = true;
    f.content_size = v;
  }
  if (single) f.window = f.content_size;
  return f;
}

class Decoder {
 public:
  Decoder(uint8_t* dst, size_t cap) : dst_(dst), cap_(cap), op_(0) {}

  size_t run(const uint8_t* src, size_t n) {
    Bytes in{src, src + n};
    if (n == 0) fail("no frame");
    while (in.left()) {
      const uint32_t magic = le32(in.take(4, "frame magic number truncated"));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        in.take(le32(in.take(4, "skippable frame truncated")), "skippable frame truncated");
        continue;
      }
      if (magic != 0xFD2FB528u) fail("not a zstd frame");
      frame(in);
    }
    return op_;
  }

 private:
  uint8_t* dst_;
  size_t cap_, op_;
  // per-frame state
  size_t frame_start_ = 0;
  uint64_t rep_[3];
  Huf huf_;
  Fse ll_, of_, ml_;
  uint8_t lit_buf_[kBlockMax];

  void frame(Bytes& in) {
    const FrameHeader f = frame_header(in);
    if (f.has_size && f.content_size > cap_ - op_) throw TooSmall{};
    frame_start_ = op_;
    rep_[0] = 1;
    rep_[1] = 4;
    rep_[2] = 8;
    huf_.max_bits = 0;
    ll_.log = of_.log = ml_.log = -1;
    const size_t block_max = f.window < kBlockMax ? size_t(f.window) : kBlockMax;
    for (;;) {
      const uint8_t* h = in.take(3, "block header truncated");
      const uint32_t bh = uint32_t(h[0]) | uint32_t(h[1]) << 8 | uint32_t(h[2]) << 16;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (size > block_max) fail("block larger than its maximum");
      if (type == 0) {
        const uint8_t* raw = in.take(size, "raw block truncated");
        reserve(size);
        std::memcpy(dst_ + op_, raw, size);
        op_ += size;
      } else if (type == 1) {
        const uint8_t v = in.byte("RLE block truncated");
        reserve(size);
        std::memset(dst_ + op_, v, size);
        op_ += size;
      } else if (type == 2) {
        const uint8_t* body = in.take(size, "compressed block truncated");
        const size_t start = op_;
        block(body, size);
        if (op_ - start > block_max) fail("block decodes past its maximum size");
      } else {
        fail("reserved block type");
      }
      if (last) break;
    }
    const size_t got = op_ - frame_start_;
    if (f.has_size && got != f.content_size) fail("frame content size does not match its data");
    if (f.checksum) {
      const uint32_t want = le32(in.take(4, "content checksum truncated"));
      if (uint32_t(xxh64(dst_ + frame_start_, got)) != want) fail("content checksum mismatch");
    }
  }

  void reserve(size_t n) {
    if (n > cap_ - op_) throw TooSmall{};
  }

  void block(const uint8_t* p, size_t n) {
    Bytes in{p, p + n};
    const uint8_t* lit;
    size_t nlit;
    literals(in, lit, nlit);
    sequences(in, lit, nlit);
  }

  void literals(Bytes& in, const uint8_t*& lit, size_t& nlit) {
    const uint8_t b0 = in.byte("literals section truncated");
    const int type = b0 & 3, sf = (b0 >> 2) & 3;
    if (type < 2) {
      size_t regen;
      if (sf == 0 || sf == 2) {
        regen = b0 >> 3;
      } else if (sf == 1) {
        regen = (b0 >> 4) + (size_t(in.byte("literals header truncated")) << 4);
      } else {
        const uint8_t* h = in.take(2, "literals header truncated");
        regen = (b0 >> 4) + (size_t(h[0]) << 4) + (size_t(h[1]) << 12);
      }
      if (regen > kBlockMax) fail("literals larger than a block");
      if (type == 0) {
        lit = in.take(regen, "raw literals truncated");
      } else {
        std::memset(lit_buf_, in.byte("RLE literals truncated"), regen);
        lit = lit_buf_;
      }
      nlit = regen;
      return;
    }
    size_t regen, comp;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      const uint8_t* h = in.take(2, "literals header truncated");
      const uint32_t v = b0 | uint32_t(h[0]) << 8 | uint32_t(h[1]) << 16;
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      const uint8_t* h = in.take(3, "literals header truncated");
      const uint32_t v = b0 | uint32_t(h[0]) << 8 | uint32_t(h[1]) << 16 | uint32_t(h[2]) << 24;
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
    } else {
      const uint8_t* h = in.take(4, "literals header truncated");
      const uint64_t v = b0 | uint64_t(h[0]) << 8 | uint64_t(h[1]) << 16 | uint64_t(h[2]) << 24 |
                         uint64_t(h[3]) << 32;
      regen = size_t((v >> 4) & 0x3FFFF);
      comp = size_t((v >> 22) & 0x3FFFF);
    }
    if (regen > kBlockMax) fail("literals larger than a block");
    const uint8_t* c = in.take(comp, "compressed literals truncated");
    size_t used = 0;
    if (type == 2) {
      used = huf_header(huf_, c, comp);
    } else if (huf_.max_bits == 0) {
      fail("treeless literals without an earlier Huffman table");
    }
    c += used;
    comp -= used;
    if (streams == 1) {
      HufStream st = huf_open(c, comp, lit_buf_, regen);
      huf_streams(huf_, &st, 1);
    } else {
      if (comp < 6) fail("four-stream literals without their jump table");
      const size_t s1 = c[0] | size_t(c[1]) << 8, s2 = c[2] | size_t(c[3]) << 8,
                   s3 = c[4] | size_t(c[5]) << 8;
      if (s1 + s2 + s3 > comp - 6) fail("literal streams overrun their section");
      const size_t s4 = comp - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for four streams");
      const uint8_t* q = c + 6;
      HufStream st[4] = {huf_open(q, s1, lit_buf_, seg),
                         huf_open(q + s1, s2, lit_buf_ + seg, seg),
                         huf_open(q + s1 + s2, s3, lit_buf_ + 2 * seg, seg),
                         huf_open(q + s1 + s2 + s3, s4, lit_buf_ + 3 * seg, regen - 3 * seg)};
      huf_streams(huf_, st, 4);
    }
    lit = lit_buf_;
    nlit = regen;
  }

  void table(Bytes& in, Fse& t, int mode, const int16_t* dflt, int ndflt, int dlog,
             int max_log, int max_sym) {
    if (mode == 0) {
      fse_build(t, dflt, ndflt, dlog);
    } else if (mode == 1) {
      const uint8_t s = in.byte("RLE sequence table truncated");
      if (s >= max_sym) fail("RLE sequence code out of range");
      fse_rle(t, s);
    } else if (mode == 2) {
      in.p += fse_header(t, in.p, in.left(), max_log, max_sym);
    } else if (t.log < 0) {
      fail("repeated sequence table without an earlier one");
    }
  }

  void sequences(Bytes& in, const uint8_t* lit, size_t nlit) {
    const uint8_t b0 = in.byte("sequences section truncated");
    size_t nseq;
    if (b0 < 128) {
      nseq = b0;
    } else if (b0 < 255) {
      nseq = (size_t(b0 - 128) << 8) + in.byte("sequences header truncated");
    } else {
      const uint8_t* h = in.take(2, "sequences header truncated");
      nseq = h[0] + (size_t(h[1]) << 8) + 0x7F00;
    }
    const uint8_t* lend = lit + nlit;
    if (nseq == 0) {
      if (in.left()) fail("data after an empty sequences section");
      copy_literals(lit, nlit);
      return;
    }
    const uint8_t modes = in.byte("sequences header truncated");
    if (modes & 3) fail("sequence modes' reserved bits are set");
    table(in, ll_, modes >> 6, kLLDefault, 36, 6, 9, 36);
    table(in, of_, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 32);
    table(in, ml_, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 53);
    BackBits br(in.p, in.left());
    uint32_t ls = uint32_t(br.read(ll_.log)), os = uint32_t(br.read(of_.log)),
             ms = uint32_t(br.read(ml_.log));
    for (size_t i = 0; i < nseq; ++i) {
      const int oc = of_.sym[os], lc = ll_.sym[ls], mc = ml_.sym[ms];
      if (oc > 31) fail("offset code out of range");
      const uint64_t ofv = (uint64_t(1) << oc) + br.read(oc);
      const size_t mlen = kMLBase[mc] + size_t(br.read(kMLBits[mc]));
      const size_t llen = kLLBase[lc] + size_t(br.read(kLLBits[lc]));
      if (i + 1 < nseq) {
        ls = ll_.base[ls] + uint32_t(br.read(ll_.nb[ls]));
        ms = ml_.base[ms] + uint32_t(br.read(ml_.nb[ms]));
        os = of_.base[os] + uint32_t(br.read(of_.nb[os]));
      }
      if (llen > size_t(lend - lit)) fail("sequence takes more literals than there are");
      copy_literals(lit, llen);
      lit += llen;
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = off;
      } else {
        const int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          off = rep_[0];
        } else {
          off = idx < 3 ? rep_[idx] : rep_[0] - 1;
          if (idx > 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = off;
        }
      }
      if (off == 0 || off > op_ - frame_start_) fail("match offset before the frame's start");
      reserve(mlen);
      uint8_t* o = dst_ + op_;
      const uint8_t* m = o - off;
      if (off >= mlen) {
        std::memcpy(o, m, mlen);
      } else {
        for (size_t k = 0; k < mlen; ++k) o[k] = m[k];
      }
      op_ += mlen;
    }
    if (br.pos != 0) fail("sequence bitstream length does not match its sequences");
    copy_literals(lit, size_t(lend - lit));
  }

  void copy_literals(const uint8_t* lit, size_t n) {
    reserve(n);
    std::memcpy(dst_ + op_, lit, n);
    op_ += n;
  }
};

void message(char* msg, const char* what) {
  if (msg) std::snprintf(msg, kMsgLen, "%s", what);
}

// Walks the frames, summing their content sizes; -1 when one lacks it.
int64_t content_size(const uint8_t* src, size_t n) {
  Bytes in{src, src + n};
  if (n == 0) fail("no frame");
  uint64_t total = 0;
  bool known = true;
  while (in.left()) {
    const uint32_t magic = le32(in.take(4, "frame magic number truncated"));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      in.take(le32(in.take(4, "skippable frame truncated")), "skippable frame truncated");
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame");
    const FrameHeader f = frame_header(in);
    for (;;) {
      const uint8_t* h = in.take(3, "block header truncated");
      const uint32_t bh = uint32_t(h[0]) | uint32_t(h[1]) << 8 | uint32_t(h[2]) << 16;
      if (((bh >> 1) & 3) == 3) fail("reserved block type");
      in.take(((bh >> 1) & 3) == 1 ? 1 : size_t(bh >> 3), "block truncated");
      if (bh & 1) break;
    }
    if (f.checksum) in.take(4, "content checksum truncated");
    if (!f.has_size) known = false;
    total += f.content_size;
    if (total > (uint64_t(1) << 62)) fail("content size out of range");
  }
  return known ? int64_t(total) : -1;
}

uint32_t crc_table[8][256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      crc_table[0][i] = c;
    }
    for (int t = 1; t < 8; ++t)
      for (int i = 0; i < 256; ++i)
        crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  }
} crc_init;

}  // namespace

extern "C" {

int dz_msg_len() { return kMsgLen; }

// Decodes every frame of src into dst. Returns the bytes written; -1 for a
// malformed or truncated input (msg says what), -2 when the output does not
// fit in cap.
int64_t dz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* msg) {
  try {
    return int64_t(std::make_unique<Decoder>(dst, cap)->run(src, n));
  } catch (const Corrupt& e) {
    message(msg, e.what);
    return -1;
  } catch (const TooSmall&) {
    message(msg, "output larger than its buffer");
    return -2;
  } catch (const std::bad_alloc&) {
    message(msg, "out of memory");
    return -1;
  }
}

// The sum of the frames' content sizes; -1 when a frame does not state it,
// -2 for a malformed input (msg says what).
int64_t dz_content_size(const uint8_t* src, size_t n, char* msg) {
  try {
    return content_size(src, n);
  } catch (const Corrupt& e) {
    message(msg, e.what);
    return -2;
  }
}

// CRC-32C (Castagnoli), as OCDBT's manifests and nodes end with.
uint32_t dz_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    const uint32_t lo = c ^ le32(p), hi = le32(p + 4);
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
        crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^ crc_table[3][hi & 0xFF] ^
        crc_table[2][(hi >> 8) & 0xFF] ^ crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
  }
  for (; n; --n, ++p) c = crc_table[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
