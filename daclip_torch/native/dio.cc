// daclip_torch native IO: PNG and baseline-JPEG decode with crop-at-decode,
// on zlib alone, and a pthread pool that decodes a batch without the GIL.
//
// Counterpart of daclip_tpu/native/dio.cc, which links libjpeg and libpng.
// This file includes no image library header:
//   * PNG: the IDAT stream is inflated with zlib and its rows unfiltered
//     here (all five filter types); 8-bit gray and RGB, palette without
//     tRNS, 1/2/4-bit gray, Adam7 or not. A crop stops inflating after the
//     window's last row.
//   * JPEG: a baseline / extended-sequential Huffman decoder (SOF0/SOF1,
//     8-bit samples, 1 or 3 components in one scan, sampling factors 1 or 2,
//     DRI restarts) written to give the bytes libjpeg-turbo gives: the
//     "islow" integer IDCT (CONST_BITS 13, PASS1_BITS 2, range-limited),
//     fancy (triangle) upsampling h2v1 / h1v2 / h2v2 with its alternating
//     rounding and replicated edges, and the fixed-point YCbCr->RGB tables
//     (SCALEBITS 16). A crop entropy-decodes the MCUs only up to the
//     window's last one, and runs the IDCT, upsampling and colour
//     conversion only on the blocks the window and its one-sample
//     upsampling context need.
// Output: rows of the window [x0, x0+cw) x [y0, y0+ch), BGR uint8 for colour
// and one gray channel otherwise, equal to cv2.imdecode(IMREAD_UNCHANGED)
// of the whole file then cropped. A file outside the set returns
// DIO_UNSUPPORTED so the caller reads it another way. A header above cv2's
// size limit, or far larger than its data can fill, is refused before any
// buffer is allocated for it.
//
// Python binding: daclip_torch/data/native_io.py (ctypes; built there at
// first use).
// Build: g++ -O3 -fPIC -shared -std=c++17 -o libdio.so dio.cc -lz -lpthread

#include <pthread.h>
#include <zlib.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum {
  DIO_NOT_IMAGE = -1,    // neither a JPEG nor a PNG signature
  DIO_UNSUPPORTED = -2,  // well-formed, outside the decoder's set
  DIO_CORRUPT = -3,      // malformed or truncated
  DIO_WINDOW = -4,       // the crop window is not inside the image
  DIO_MEMORY = -5,
};
constexpr int kMsgLen = 256;
// cv2's own limits on a decoded image (CV_IO_MAX_IMAGE_WIDTH / _HEIGHT /
// _PIXELS): a larger header is refused before anything is allocated for it
constexpr uint64_t kMaxSide = uint64_t(1) << 20, kMaxPixels = uint64_t(1) << 30;
// deflate's largest ratio: one 258-byte match in two bits
constexpr uint64_t kInflateRatio = 1032;

int fail(char* msg, int rc, const char* fmt, ...) {
  if (msg) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(msg, kMsgLen, fmt, ap);
    va_end(ap);
  }
  return rc;
}

int too_large(uint64_t w, uint64_t h, char* msg) {
  if (w > kMaxSide || h > kMaxSide || w * h > kMaxPixels)
    return fail(msg, DIO_UNSUPPORTED, "image of %llu x %llu is above cv2's size limit",
                (unsigned long long)w, (unsigned long long)h);
  return 0;
}

inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}
inline int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}
bool is_png(const uint8_t* buf, size_t len) {
  return len >= 8 && !memcmp(buf, "\x89PNG\r\n\x1a\n", 8);
}

// ==================================================================== PNG ===

// Undo one row's filter in place: cur holds the filtered bytes, prev the row
// above unfiltered (zeros for the first); the left neighbour is bpp bytes
// back. Returns false for an unknown filter type.
bool unfilter_row(uint8_t* cur, const uint8_t* prev, size_t n, int bpp, int ft) {
  size_t b = size_t(bpp) < n ? size_t(bpp) : n;
  switch (ft) {
    case 0:
      return true;
    case 1:
      for (size_t i = b; i < n; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < b; ++i) cur[i] = uint8_t(cur[i] + (prev[i] >> 1));
      for (size_t i = b; i < n; ++i)
        cur[i] = uint8_t(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:
      for (size_t i = 0; i < b; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
      for (size_t i = b; i < n; ++i) {
        int a = cur[i - bpp], up = prev[i], c = prev[i - bpp];
        int pa = abs(up - c), pb = abs(a - c), pc = abs(a + up - 2 * c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? up : c);
        cur[i] = uint8_t(cur[i] + pred);
      }
      return true;
    default:
      return false;
  }
}

struct Png {
  uint32_t W = 0, H = 0;
  int depth = 0, ctype = 0, interlace = 0;
  const uint8_t* plte = nullptr;
  int nplte = 0;
  bool trns = false;
  std::vector<std::pair<const uint8_t*, uint32_t>> idat;
};

int png_channels(int ctype) {
  switch (ctype) {
    case 0: case 3: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool png_depth_valid(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// Walk the chunks (each CRC checked). header_only stops after IHDR.
int png_parse(const uint8_t* buf, size_t len, Png* p, bool header_only, char* msg) {
  size_t pos = 8;
  bool header = false, iend = false;
  while (pos + 12 <= len) {
    uint32_t n = be32(buf + pos);
    const uint8_t* kind = buf + pos + 4;
    if (n > len - pos - 12) break;
    const uint8_t* body = buf + pos + 8;
    if (uint32_t(crc32(0, kind, n + 4)) != be32(body + n))
      return fail(msg, DIO_CORRUPT, "PNG chunk %.4s fails its CRC", kind);
    if (!memcmp(kind, "IHDR", 4)) {
      if (n != 13) return fail(msg, DIO_CORRUPT, "PNG IHDR has %u bytes", n);
      p->W = be32(body);
      p->H = be32(body + 4);
      p->depth = body[8];
      p->ctype = body[9];
      p->interlace = body[12];
      header = true;
      if (header_only) break;
    } else if (!header) {
      return fail(msg, DIO_CORRUPT, "PNG does not start with IHDR");
    } else if (!memcmp(kind, "PLTE", 4)) {
      if (n % 3) return fail(msg, DIO_CORRUPT, "PNG PLTE of %u bytes", n);
      p->plte = body;
      p->nplte = int(n / 3);
    } else if (!memcmp(kind, "tRNS", 4)) {
      p->trns = true;
    } else if (!memcmp(kind, "IDAT", 4)) {
      p->idat.emplace_back(body, n);
    } else if (!memcmp(kind, "IEND", 4)) {
      iend = true;
      break;
    } else if (!(kind[0] & 0x20)) {
      return fail(msg, DIO_CORRUPT, "unknown critical PNG chunk %.4s", kind);
    }
    pos += 12 + size_t(n);
  }
  if (!header) return fail(msg, DIO_CORRUPT, "PNG has no IHDR chunk");
  if (!header_only && !iend) return fail(msg, DIO_CORRUPT, "PNG ends before its IEND chunk");
  if (p->W == 0 || p->H == 0 || p->W > 0x7FFFFFFF || p->H > 0x7FFFFFFF)
    return fail(msg, DIO_CORRUPT, "PNG of %u x %u", p->W, p->H);
  if (int rc = too_large(p->W, p->H, msg)) return rc;
  if (!png_depth_valid(p->ctype, p->depth))
    return fail(msg, DIO_CORRUPT, "PNG colour type %d at bit depth %d is not valid",
                p->ctype, p->depth);
  if (p->interlace > 1)
    return fail(msg, DIO_CORRUPT, "PNG interlace method %d is not valid", p->interlace);
  return 0;
}

// Streams the concatenated IDAT payloads through zlib's inflate.
struct Inflater {
  z_stream zs;
  const Png& png;
  size_t next = 0;
  bool ok = false, ended = false;
  explicit Inflater(const Png& p) : png(p) {
    memset(&zs, 0, sizeof zs);
    ok = inflateInit(&zs) == Z_OK;
  }
  ~Inflater() {
    if (ok) inflateEnd(&zs);
  }
  // Fills dst[0, n); false when the stream ends early or is malformed.
  bool read(uint8_t* dst, size_t n) {
    zs.next_out = dst;
    zs.avail_out = uInt(n);
    while (zs.avail_out) {
      if (ended) return false;
      if (zs.avail_in == 0) {
        if (next == png.idat.size()) return false;
        zs.next_in = const_cast<Bytef*>(png.idat[next].first);
        zs.avail_in = png.idat[next].second;
        ++next;
        continue;
      }
      int r = inflate(&zs, Z_NO_FLUSH);
      if (r == Z_STREAM_END) {
        ended = true;
      } else if (r != Z_OK) {
        return false;
      }
    }
    return true;
  }
};

// One unfiltered row (packed samples for depths below 8) or one row of
// unpacked samples -> the window's BGR / gray bytes.
struct PngEmit {
  int ctype, depth, C, outc;
  const uint8_t* plte;
  int nplte;
  bool packed;
  int sample(const uint8_t* r, size_t i) const {
    if (!packed || depth == 8) return r[i];
    size_t bit = i * size_t(depth);
    return (r[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1 << depth) - 1);
  }
  bool row(const uint8_t* r, int x0, int cw, uint8_t* out) const {
    if (ctype == 2) {
      for (int x = 0; x < cw; ++x) {
        const uint8_t* s = r + size_t(x0 + x) * 3;
        out[3 * x] = s[2];
        out[3 * x + 1] = s[1];
        out[3 * x + 2] = s[0];
      }
    } else if (ctype == 3) {
      for (int x = 0; x < cw; ++x) {
        int i = sample(r, size_t(x0 + x));
        if (i >= nplte) return false;
        out[3 * x] = plte[3 * i + 2];
        out[3 * x + 1] = plte[3 * i + 1];
        out[3 * x + 2] = plte[3 * i];
      }
    } else {
      const int scale = 255 / ((1 << depth) - 1);  // libpng's gray expansion
      for (int x = 0; x < cw; ++x) out[x] = uint8_t(sample(r, size_t(x0 + x)) * scale);
    }
    return true;
  }
};

int png_decode_crop(const uint8_t* buf, size_t len, int x0, int y0, int cw, int ch,
                    uint8_t* out, char* msg) {
  Png p;
  int rc = png_parse(buf, len, &p, false, msg);
  if (rc) return rc;
  if (p.depth == 16) return fail(msg, DIO_UNSUPPORTED, "16-bit PNG");
  if (p.ctype == 4 || p.ctype == 6) return fail(msg, DIO_UNSUPPORTED, "PNG with alpha");
  if (p.trns) return fail(msg, DIO_UNSUPPORTED, "PNG with a tRNS chunk");
  if (p.ctype == 3 && !p.plte) return fail(msg, DIO_CORRUPT, "palette PNG has no PLTE chunk");
  const int W = int(p.W), H = int(p.H);
  if (x0 < 0 || y0 < 0 || cw < 1 || ch < 1 || x0 > W - cw || y0 > H - ch)
    return fail(msg, DIO_WINDOW, "window (%d, %d, %d, %d) outside a %d x %d image", x0, y0,
                cw, ch, W, H);
  const int C = png_channels(p.ctype);
  const int outc = p.ctype == 0 ? 1 : 3;
  const int bpp = C * p.depth / 8 > 1 ? C * p.depth / 8 : 1;
  Inflater inf(p);
  if (!inf.ok) return fail(msg, DIO_MEMORY, "inflateInit failed");
  PngEmit emit{p.ctype, p.depth, C, outc, p.plte, p.nplte, true};

  if (!p.interlace) {
    const size_t rowbytes = (size_t(W) * C * p.depth + 7) / 8;
    std::vector<uint8_t> a(rowbytes + 1, 0), b(rowbytes + 1, 0);
    uint8_t *prev = a.data(), *cur = b.data();
    for (int y = 0; y < y0 + ch; ++y) {  // rows past the window are not inflated
      if (!inf.read(cur, rowbytes + 1))
        return fail(msg, DIO_CORRUPT, "PNG image data is truncated or malformed (row %d)", y);
      if (!unfilter_row(cur + 1, prev + 1, rowbytes, bpp, cur[0]))
        return fail(msg, DIO_CORRUPT, "row %d has unknown PNG filter type %d", y, cur[0]);
      if (y >= y0 && !emit.row(cur + 1, x0, cw, out + size_t(y - y0) * cw * outc))
        return fail(msg, DIO_CORRUPT, "palette index out of range");
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
    return outc;
  }

  // Adam7: every pass covers the whole image, so all are decoded into
  // unpacked samples and the window is cut from those.
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  uint64_t raw = 0, compressed = 0;  // the passes' filtered bytes and the IDAT bytes
  for (const auto& ps : kPass) {
    const uint64_t pw = W > ps[0] ? (W - ps[0] + ps[2] - 1) / ps[2] : 0;
    const uint64_t ph = H > ps[1] ? (H - ps[1] + ps[3] - 1) / ps[3] : 0;
    if (pw && ph) raw += ph * (1 + (pw * C * p.depth + 7) / 8);
  }
  for (const auto& d : p.idat) compressed += d.second;
  if (raw > kInflateRatio * compressed + 1024)
    return fail(msg, DIO_CORRUPT, "PNG image data too short for %d x %d", W, H);
  std::vector<uint8_t> full(size_t(W) * H * C, 0);
  for (const auto& ps : kPass) {
    const int px = ps[0], py = ps[1], dx = ps[2], dy = ps[3];
    const int pw = W > px ? (W - px + dx - 1) / dx : 0;
    const int ph = H > py ? (H - py + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rowbytes = (size_t(pw) * C * p.depth + 7) / 8;
    std::vector<uint8_t> a(rowbytes + 1, 0), b(rowbytes + 1, 0);
    uint8_t *prev = a.data(), *cur = b.data();
    for (int j = 0; j < ph; ++j) {
      if (!inf.read(cur, rowbytes + 1))
        return fail(msg, DIO_CORRUPT, "PNG image data is truncated or malformed");
      if (!unfilter_row(cur + 1, prev + 1, rowbytes, bpp, cur[0]))
        return fail(msg, DIO_CORRUPT, "Adam7 row %d has unknown PNG filter type %d", j,
                    cur[0]);
      uint8_t* dst = full.data() + size_t(py + j * dy) * W * C;
      for (int i = 0; i < pw; ++i)
        for (int c = 0; c < C; ++c)
          dst[size_t(px + i * dx) * C + c] = uint8_t(emit.sample(cur + 1, size_t(i) * C + c));
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
  emit.packed = false;
  for (int y = 0; y < ch; ++y)
    if (!emit.row(full.data() + size_t(y0 + y) * W * C, x0, cw, out + size_t(y) * cw * outc))
      return fail(msg, DIO_CORRUPT, "palette index out of range");
  return outc;
}

// =================================================================== JPEG ===

const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kFastBits = 9;

struct Huff {
  bool defined = false;
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol; 0 when longer than kFastBits
  int32_t maxcode[18];            // largest code of each length, -1 when none
  int32_t valoffset[17];          // symbol index = code + valoffset[length]
  uint8_t vals[256];
};

bool build_huff(Huff* h, const uint8_t* counts, const uint8_t* vals, int total) {
  memset(h->fast, 0, sizeof h->fast);
  memcpy(h->vals, vals, size_t(total));
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    h->valoffset[l] = k - code;
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      if (code >= (1 << l)) return false;
      if (l <= kFastBits) {
        int lo = code << (kFastBits - l), hi = lo + (1 << (kFastBits - l));
        for (int f = lo; f < hi; ++f) h->fast[f] = uint16_t(l << 8 | vals[k]);
      }
    }
    h->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->defined = true;
  return true;
}

// The entropy-coded segment's bits. Stops at a marker and feeds zero bits
// after it, as libjpeg does; `fake` counts those zero bits still buffered so
// that consuming one (data cut short) is seen.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0, fake = 0, marker = 0;
  bool short_data = false;

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        b = *p++;
        if (b == 0xFF) {
          while (p < end && *p == 0xFF) ++p;  // fill bytes before a marker
          if (p < end && *p == 0x00) {
            ++p;  // a stuffed zero: the data byte 0xFF
          } else {
            marker = p < end ? *p++ : 0x100;
            b = 0;
            fake += 8;
          }
        }
      } else {
        if (!marker) marker = 0x100;  // the buffer ended
        fake += 8;
      }
      buf |= uint64_t(b) << (56 - n);
      n += 8;
    }
  }
  inline uint32_t peek16() {
    if (n < 16) fill();
    return uint32_t(buf >> 48);
  }
  inline void skip(int k) {
    buf <<= k;
    n -= k;
    if (n < fake) short_data = true;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    int v = int(buf >> (64 - k));
    skip(k);
    return v;
  }
  inline int decode(const Huff& h) {
    uint32_t look = peek16();
    uint16_t f = h.fast[look >> (16 - kFastBits)];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int l = kFastBits + 1; l <= 16; ++l) {
      int32_t code = int32_t(look >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[code + h.valoffset[l]];
      }
    }
    return -1;
  }
  // After a restart interval: drop the padding bits and take the RSTn marker.
  bool restart(int want) {
    buf = 0;
    n = 0;
    fake = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) ++p;
      if (p + 1 >= end) return false;
      marker = p[1];
      p += 2;
    }
    bool ok = marker == 0xD0 + want;
    marker = 0;
    return ok;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// libjpeg's IDCT output table: a value centred on 0, masked to 10 bits,
// becomes sample + 128 clamped to [0, 255].
struct Tables {
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  Tables() {
    for (int j = 0; j < 1024; ++j) {
      int v = (j ^ 512) - 512 + 128;
      idct_limit[j] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const Tables& tables() {
  static const Tables t;
  return t;
}
inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// jidctint.c jpeg_idct_islow: dequantise and inverse-DCT one block into 8
// rows of `out` (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, size_t stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  const uint8_t* lim = tables().idct_limit;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = int(in[0]) * qq[0] * (1 << P1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qq[16], z3 = int64_t(in[48]) * qq[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(in[0]) * qq[0];
    z3 = int64_t(in[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
            tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qq[56];
    tmp1 = int64_t(in[40]) * qq[40];
    tmp2 = int64_t(in[24]) * qq[24];
    tmp3 = int64_t(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB - P1;
    constexpr int64_t R = int64_t(1) << (S - 1);
    w[0] = int((tmp10 + tmp3 + R) >> S);
    w[56] = int((tmp10 - tmp3 + R) >> S);
    w[8] = int((tmp11 + tmp2 + R) >> S);
    w[48] = int((tmp11 - tmp2 + R) >> S);
    w[16] = int((tmp12 + tmp1 + R) >> S);
    w[40] = int((tmp12 - tmp1 + R) >> S);
    w[24] = int((tmp13 + tmp0 + R) >> S);
    w[32] = int((tmp13 - tmp0 + R) >> S);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = lim[((w[0] + (1 << (P1 + 2))) >> (P1 + 3)) & 1023];
      memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CB), tmp1 = (int64_t(w[0]) - w[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
            tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    constexpr int64_t R = int64_t(1) << (S - 1);
    o[0] = lim[int((tmp10 + tmp3 + R) >> S) & 1023];
    o[7] = lim[int((tmp10 - tmp3 + R) >> S) & 1023];
    o[1] = lim[int((tmp11 + tmp2 + R) >> S) & 1023];
    o[6] = lim[int((tmp11 - tmp2 + R) >> S) & 1023];
    o[2] = lim[int((tmp12 + tmp1 + R) >> S) & 1023];
    o[5] = lim[int((tmp12 - tmp1 + R) >> S) & 1023];
    o[3] = lim[int((tmp13 + tmp0 + R) >> S) & 1023];
    o[4] = lim[int((tmp13 - tmp0 + R) >> S) & 1023];
  }
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;  // Huffman table slots of the scan
  int sx = 1, sy = 1;  // upsampling ratio to the output grid
  int w = 0, hgt = 0;  // the component's real samples (downsampled size)
  bool fancy = false;
  int pred = 0;
  // the samples the window needs (inclusive) and their blocks
  int r0 = 0, r1 = 0, c0 = 0, c1 = 0, br0 = 0, br1 = 0, bc0 = 0, bc1 = 0;
  std::vector<uint8_t> plane;  // the needed blocks' samples
  size_t stride = 0;
  // sample (r, c) in absolute component coordinates, clamped to the real edge
  inline const uint8_t* row(int r) const {
    r = r < 0 ? 0 : r >= hgt ? hgt - 1 : r;
    return plane.data() + size_t(r - br0 * 8) * stride - size_t(bc0) * 8;
  }
};

struct Jpeg {
  int W = 0, H = 0, nf = 0, precision = 8, sof = -1;
  Comp comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  const uint8_t* scan = nullptr;  // the first entropy-coded byte
  int scan_order[3] = {0, 1, 2};  // frame component of each scan slot
};

// Parse markers up to the first scan's header (header_only: up to SOF).
int jpeg_parse(const uint8_t* buf, size_t len, Jpeg* j, bool header_only, char* msg) {
  size_t pos = 2;
  for (;;) {
    while (pos < len && buf[pos] != 0xFF) ++pos;  // garbage between markers
    while (pos < len && buf[pos] == 0xFF) ++pos;
    if (pos >= len) return fail(msg, DIO_CORRUPT, "JPEG ends before its first scan");
    const int m = buf[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
    if (m == 0xD9) return fail(msg, DIO_CORRUPT, "JPEG ends before its first scan");
    if (pos + 2 > len) return fail(msg, DIO_CORRUPT, "JPEG marker cut short");
    const size_t seglen = size_t(be16(buf + pos));
    if (seglen < 2 || pos + seglen > len)
      return fail(msg, DIO_CORRUPT, "JPEG marker 0x%02X cut short", m);
    const uint8_t* d = buf + pos + 2;
    const size_t n = seglen - 2;
    pos += seglen;
    if (m == 0xC0 || m == 0xC1) {
      if (j->sof >= 0) return fail(msg, DIO_CORRUPT, "JPEG has two frames");
      if (n < 6) return fail(msg, DIO_CORRUPT, "JPEG SOF cut short");
      j->sof = m;
      j->precision = d[0];
      j->H = be16(d + 1);
      j->W = be16(d + 3);
      j->nf = d[5];
      if (n < 6 + size_t(3) * j->nf) return fail(msg, DIO_CORRUPT, "JPEG SOF cut short");
      if (j->W == 0) return fail(msg, DIO_CORRUPT, "JPEG of width 0");
      if (int rc = too_large(j->W, j->H, msg)) return rc;
      if (header_only) {
        if (j->H == 0) return fail(msg, DIO_UNSUPPORTED, "JPEG height from a DNL marker");
        return 0;
      }
      if (j->precision != 8)
        return fail(msg, DIO_UNSUPPORTED, "%d-bit JPEG samples", j->precision);
      if (j->H == 0) return fail(msg, DIO_UNSUPPORTED, "JPEG height from a DNL marker");
      if (j->nf != 1 && j->nf != 3)
        return fail(msg, DIO_UNSUPPORTED, "JPEG with %d components", j->nf);
      for (int c = 0; c < j->nf; ++c) {
        Comp& cp = j->comp[c];
        cp.id = d[6 + 3 * c];
        cp.h = d[7 + 3 * c] >> 4;
        cp.v = d[7 + 3 * c] & 15;
        cp.tq = d[8 + 3 * c];
        if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3)
          return fail(msg, DIO_CORRUPT, "JPEG component %d: bad sampling or table", c);
        if (cp.h > 2 || cp.v > 2)
          return fail(msg, DIO_UNSUPPORTED, "JPEG sampling factor %dx%d", cp.h, cp.v);
      }
    } else if (m == 0xC2 || m == 0xC3 || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
               (m >= 0xCD && m <= 0xCF) || m == 0xCC) {
      if (header_only && m != 0xCC && n >= 6) {  // the size of any frame
        j->sof = m;
        j->H = be16(d + 1);
        j->W = be16(d + 3);
        j->nf = d[5];
        if (j->W == 0 || j->H == 0) return fail(msg, DIO_UNSUPPORTED, "JPEG of size 0");
        if (int rc = too_large(j->W, j->H, msg)) return rc;
        return 0;
      }
      return fail(msg, DIO_UNSUPPORTED, "JPEG marker 0x%02X (progressive, lossless, "
                  "hierarchical or arithmetic coding)", m);
    } else if (m == 0xC4) {
      size_t q = 0;
      while (q < n) {
        if (q + 17 > n) return fail(msg, DIO_CORRUPT, "JPEG DHT cut short");
        const int tc = d[q] >> 4, th = d[q] & 15;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += d[q + 1 + i];
        if (tc > 1 || th > 3 || total > 256 || q + 17 + size_t(total) > n)
          return fail(msg, DIO_CORRUPT, "JPEG DHT malformed");
        Huff* h = tc ? &j->ac[th] : &j->dc[th];
        if (!build_huff(h, d + q + 1, d + q + 17, total))
          return fail(msg, DIO_CORRUPT, "JPEG Huffman table is not a prefix code");
        q += 17 + size_t(total);
      }
    } else if (m == 0xDB) {
      size_t q = 0;
      while (q < n) {
        const int pq = d[q] >> 4, tq = d[q] & 15;
        const size_t need = 1 + 64 * size_t(pq ? 2 : 1);
        if (pq > 1 || tq > 3 || q + need > n) return fail(msg, DIO_CORRUPT, "JPEG DQT malformed");
        for (int k = 0; k < 64; ++k)
          j->qt[tq][kNatural[k]] = uint16_t(pq ? be16(d + q + 1 + 2 * k) : d[q + 1 + k]);
        j->qt_defined[tq] = true;
        q += need;
      }
    } else if (m == 0xDD) {
      if (n < 2) return fail(msg, DIO_CORRUPT, "JPEG DRI cut short");
      j->restart = be16(d);
    } else if (m == 0xE0) {
      if (n >= 14 && !memcmp(d, "JFIF\0", 5)) j->jfif = true;
    } else if (m == 0xEE) {
      if (n >= 12 && !memcmp(d, "Adobe", 5)) {
        j->adobe = true;
        j->adobe_transform = d[11];
      }
    } else if (m == 0xDA) {
      if (header_only || j->sof < 0) return fail(msg, DIO_CORRUPT, "JPEG scan before its frame");
      if (n < 1) return fail(msg, DIO_CORRUPT, "JPEG SOS cut short");
      const int ns = d[0];
      if (n < size_t(1 + 2 * ns + 3)) return fail(msg, DIO_CORRUPT, "JPEG SOS cut short");
      if (ns != j->nf)
        return fail(msg, DIO_UNSUPPORTED, "JPEG whose first scan holds %d of %d components", ns,
                    j->nf);
      for (int s = 0; s < ns; ++s) {
        const int id = d[1 + 2 * s], tables_ = d[2 + 2 * s];
        int c = 0;
        while (c < j->nf && j->comp[c].id != id) ++c;
        if (c == j->nf) return fail(msg, DIO_CORRUPT, "JPEG scan names no frame component");
        for (int t = 0; t < s; ++t)
          if (j->scan_order[t] == c) return fail(msg, DIO_CORRUPT, "JPEG scan repeats a component");
        j->scan_order[s] = c;
        j->comp[c].dc = tables_ >> 4;
        j->comp[c].ac = tables_ & 15;
        if (j->comp[c].dc > 3 || j->comp[c].ac > 3)
          return fail(msg, DIO_CORRUPT, "JPEG scan table out of range");
      }
      const int ss = d[1 + 2 * ns], se = d[2 + 2 * ns], a = d[3 + 2 * ns];
      if (ss != 0 || se != 63 || a != 0)
        return fail(msg, DIO_UNSUPPORTED, "JPEG scan with spectral selection %d-%d, "
                    "approximation %d", ss, se, a);
      j->scan = buf + pos;
      return 0;
    }
    // any other marker (APPn, COM, ...) is skipped
  }
}

int jpeg_probe(const uint8_t* buf, size_t len, int* w, int* h, int* c, char* msg) {
  Jpeg j;
  int rc = jpeg_parse(buf, len, &j, true, msg);
  if (rc) return rc;
  *w = j.W;
  *h = j.H;
  *c = j.nf >= 3 ? 3 : 1;
  return 0;
}

// One block's coefficients (natural order) into coef, or only walked past
// when coef is null. Returns false on an invalid code.
inline bool decode_block(Bits& b, const Huff& dc, const Huff& ac, int& pred, int16_t* coef) {
  int s = b.decode(dc);
  if (s < 0 || s > 15) return false;
  if (s) s = extend(b.get(s), s);
  pred += s;
  if (coef) coef[0] = int16_t(pred);
  for (int k = 1; k < 64; ++k) {
    int rs = b.decode(ac);
    if (rs < 0) return false;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) return false;
      int v = b.get(s);
      if (coef) coef[kNatural[k]] = int16_t(extend(v, s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

// Inclusive range [lo, hi] of a component's samples that output coordinates
// [a, b] read, with the fancy filter's one-sample context.
inline void need_range(int a, int b, int s, bool fancy, int n, int* lo, int* hi) {
  if (s == 1) {
    *lo = a;
    *hi = b;
  } else {
    *lo = a / 2 - (fancy ? 1 : 0);
    *hi = b / 2 + (fancy ? 1 : 0);
  }
  if (*lo < 0) *lo = 0;
  if (*hi > n - 1) *hi = n - 1;
}

// The triangle filter along a row: output 2i is (3 v(i) + v(i-1) + even) >>
// shift and 2i+1 is (3 v(i) + v(i+1) + odd) >> shift, v clamped to [0, last]
// (the replicated edge of jdsample.c's first and last columns), over output
// columns [x0, x0 + cw).
template <typename V>
inline void triangle(V v, int last, int x0, int cw, int even, int odd, int shift, uint8_t* out) {
  auto at = [&](int i) { return v(i < 0 ? 0 : i > last ? last : i); };
  int x = 0, i = x0 >> 1;
  int prev = at(i - 1), cur = at(i);
  if (x0 & 1) {
    out[x++] = uint8_t((3 * cur + at(i + 1) + odd) >> shift);
    prev = cur;
    cur = at(++i);
  }
  for (; x + 1 < cw; x += 2, ++i) {
    const int next = at(i + 1);
    out[x] = uint8_t((3 * cur + prev + even) >> shift);
    out[x + 1] = uint8_t((3 * cur + next + odd) >> shift);
    prev = cur;
    cur = next;
  }
  if (x < cw) out[x] = uint8_t((3 * cur + prev + even) >> shift);
}

// Component samples of output row y over output columns [x0, x0 + cw), on
// the output grid (jdsample.c: fullsize, h2v1, h1v2, h2v2; fancy or box).
void upsample_row(const Comp& c, int y, int x0, int cw, uint8_t* out) {
  if (c.sy == 1) {
    const uint8_t* in = c.row(y);
    if (c.sx == 1) {
      memcpy(out, in + x0, size_t(cw));
    } else if (!c.fancy) {
      for (int x = 0; x < cw; ++x) out[x] = in[(x0 + x) >> 1];
    } else {  // h2v1_fancy_upsample: rounding +1 to the left, +2 to the right
      triangle([in](int i) { return int(in[i]); }, c.w - 1, x0, cw, 1, 2, 2, out);
    }
    return;
  }
  const int r = y >> 1;
  if (!c.fancy) {  // h2v2_upsample (box)
    const uint8_t* in = c.row(r);
    for (int x = 0; x < cw; ++x) out[x] = in[(x0 + x) >> 1];
    return;
  }
  // the nearer input row weighs 3, the farther (above for an even output row)
  const uint8_t* near = c.row(r);
  const uint8_t* far = c.row((y & 1) ? r + 1 : r - 1);
  if (c.sx == 1) {  // h1v2_fancy_upsample: rounding +1 above, +2 below
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < cw; ++x)
      out[x] = uint8_t((near[x0 + x] * 3 + far[x0 + x] + bias) >> 2);
    return;
  }
  // h2v2_fancy_upsample on the column sums: rounding +8 to the left, +7 to the right
  triangle([near, far](int i) { return near[i] * 3 + far[i]; }, c.w - 1, x0, cw, 8, 7, 4, out);
}

int jpeg_decode_crop(const uint8_t* buf, size_t len, int x0, int y0, int cw, int ch,
                     uint8_t* out, char* msg) {
  Jpeg j;
  int rc = jpeg_parse(buf, len, &j, false, msg);
  if (rc) return rc;
  const int W = j.W, H = j.H, nf = j.nf;
  if (x0 < 0 || y0 < 0 || cw < 1 || ch < 1 || x0 > W - cw || y0 > H - ch)
    return fail(msg, DIO_WINDOW, "window (%d, %d, %d, %d) outside a %d x %d image", x0, y0,
                cw, ch, W, H);
  if (nf == 3) {
    // jdapimin.c default_decompress_parms: which 3-component files are YCbCr
    bool rgb = false;
    if (!j.jfif && j.adobe) {
      rgb = j.adobe_transform == 0;
    } else if (!j.jfif) {
      rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
    }
    if (rgb) return fail(msg, DIO_UNSUPPORTED, "JPEG stored as RGB (no YCbCr transform)");
  }
  if (nf == 1) {  // one component: its own grid, one block an MCU
    j.comp[0].h = j.comp[0].v = 1;
  }
  int hmax = 1, vmax = 1;
  for (int c = 0; c < nf; ++c) {
    hmax = j.comp[c].h > hmax ? j.comp[c].h : hmax;
    vmax = j.comp[c].v > vmax ? j.comp[c].v : vmax;
  }
  int blocks = 0;
  for (int c = 0; c < nf; ++c) {
    Comp& cp = j.comp[c];
    if (!j.qt_defined[cp.tq]) return fail(msg, DIO_CORRUPT, "JPEG quantisation table missing");
    if (!j.dc[cp.dc].defined || !j.ac[cp.ac].defined)
      return fail(msg, DIO_CORRUPT, "JPEG Huffman table missing");
    if (hmax % cp.h || vmax % cp.v)
      return fail(msg, DIO_UNSUPPORTED, "JPEG sampling %dx%d under %dx%d", cp.h, cp.v, hmax,
                  vmax);
    cp.sx = hmax / cp.h;
    cp.sy = vmax / cp.v;
    cp.w = int((int64_t(W) * cp.h + hmax - 1) / hmax);
    cp.hgt = int((int64_t(H) * cp.v + vmax - 1) / vmax);
    // jdsample.c: h2v1 / h2v2 are fancy above two samples across, h1v2 always
    cp.fancy = (cp.sx == 2 && cp.w > 2) || (cp.sx == 1 && cp.sy == 2);
    need_range(y0, y0 + ch - 1, cp.sy, cp.fancy, cp.hgt, &cp.r0, &cp.r1);
    need_range(x0, x0 + cw - 1, cp.sx, cp.fancy, cp.w, &cp.c0, &cp.c1);
    cp.br0 = cp.r0 / 8;
    cp.br1 = cp.r1 / 8;
    cp.bc0 = cp.c0 / 8;
    cp.bc1 = cp.c1 / 8;
    cp.stride = size_t(cp.bc1 - cp.bc0 + 1) * 8;
    blocks += cp.h * cp.v;
  }
  if (blocks > 10) return fail(msg, DIO_CORRUPT, "JPEG MCU of %d blocks", blocks);

  // MCU grid: one block an MCU for one component, else hmax x vmax blocks
  int mcus_x, mcus_y, last_my = 0, last_mx = 0;
  if (nf == 1) {
    mcus_x = (j.comp[0].w + 7) / 8;
    mcus_y = (j.comp[0].hgt + 7) / 8;
    last_my = j.comp[0].br1;
    last_mx = j.comp[0].bc1;
  } else {
    mcus_x = (W + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < nf; ++c) {
      const Comp& cp = j.comp[c];
      last_my = cp.br1 / cp.v > last_my ? cp.br1 / cp.v : last_my;
    }
    for (int c = 0; c < nf; ++c) {  // the last MCU of that row holding a needed block
      const Comp& cp = j.comp[c];
      if (cp.br1 / cp.v == last_my || cp.br1 >= last_my * cp.v)
        last_mx = cp.bc1 / cp.h > last_mx ? cp.bc1 / cp.h : last_mx;
    }
  }
  (void)mcus_y;
  // every block takes two bits at the least (a DC and an end-of-block code),
  // so data too short for the blocks to decode is refused before the planes
  // are allocated for them
  const uint64_t mcus = uint64_t(last_my) * mcus_x + last_mx + 1;
  if (2 * mcus * uint64_t(nf == 1 ? 1 : blocks) > 8 * uint64_t(buf + len - j.scan))
    return fail(msg, DIO_CORRUPT, "JPEG entropy-coded data too short for %d x %d", W, H);
  for (int c = 0; c < nf; ++c) {
    Comp& cp = j.comp[c];
    cp.plane.assign(cp.stride * size_t(cp.br1 - cp.br0 + 1) * 8, 0);
  }

  Bits bits{j.scan, buf + len};
  int16_t coef[64];
  int mcu = 0, next_rst = 0;
  for (int my = 0; my <= last_my; ++my) {
    const int mx_end = my == last_my ? last_mx : mcus_x - 1;
    for (int mx = 0; mx <= mx_end; ++mx, ++mcu) {
      if (j.restart && mcu && mcu % j.restart == 0) {
        if (!bits.restart(next_rst))
          return fail(msg, DIO_CORRUPT, "JPEG restart marker missing or out of order");
        next_rst = (next_rst + 1) & 7;
        for (int c = 0; c < nf; ++c) j.comp[c].pred = 0;
      }
      for (int s = 0; s < nf; ++s) {
        Comp& cp = j.comp[j.scan_order[s]];
        const Huff& dct = j.dc[cp.dc];
        const Huff& act = j.ac[cp.ac];
        for (int v = 0; v < cp.v; ++v) {
          for (int h = 0; h < cp.h; ++h) {
            const int by = my * cp.v + v, bx = mx * cp.h + h;
            const bool want = by >= cp.br0 && by <= cp.br1 && bx >= cp.bc0 && bx <= cp.bc1;
            if (want) memset(coef, 0, sizeof coef);
            if (!decode_block(bits, dct, act, cp.pred, want ? coef : nullptr))
              return fail(msg, DIO_CORRUPT, "JPEG entropy-coded data is invalid");
            if (want)
              idct_islow(coef, j.qt[cp.tq],
                         cp.plane.data() + size_t(by - cp.br0) * 8 * cp.stride +
                             size_t(bx - cp.bc0) * 8,
                         cp.stride);
          }
        }
      }
      if (bits.short_data)
        return fail(msg, DIO_CORRUPT, "JPEG entropy-coded data ends early");
    }
  }

  const Tables& t = tables();
  if (nf == 1) {
    for (int y = 0; y < ch; ++y) upsample_row(j.comp[0], y0 + y, x0, cw, out + size_t(y) * cw);
    return 1;
  }
  std::vector<uint8_t> rows(size_t(cw) * 3);
  uint8_t *yr = rows.data(), *cbr = yr + cw, *crr = cbr + cw;
  for (int y = 0; y < ch; ++y) {
    upsample_row(j.comp[0], y0 + y, x0, cw, yr);
    upsample_row(j.comp[1], y0 + y, x0, cw, cbr);
    upsample_row(j.comp[2], y0 + y, x0, cw, crr);
    uint8_t* o = out + size_t(y) * cw * 3;
    for (int x = 0; x < cw; ++x) {  // jdcolor.c ycc_rgb_convert, written as BGR
      const int Y = yr[x], cb = cbr[x], cr = crr[x];
      o[3 * x + 2] = clamp255(Y + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(Y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x] = clamp255(Y + t.cb_b[cb]);
    }
  }
  return 3;
}

// ================================================================== batch ===

struct Task {
  const uint8_t* buf;
  size_t len;
  int x0, y0, cw, ch;
  uint8_t* out;
  char* msg;
  int rc;
};

struct Queue {
  Task* tasks;
  int n, next;
  pthread_mutex_t mu;
};

}  // namespace

extern "C" {

// (w, h, channels) from the header alone; 0 or a negative DIO_* code.
int dio_probe(const uint8_t* buf, size_t len, int* w, int* h, int* c, char* msg) {
  if (is_jpeg(buf, len)) return jpeg_probe(buf, len, w, h, c, msg);
  if (is_png(buf, len)) {
    Png p;
    int rc = png_parse(buf, len, &p, true, msg);
    if (rc) return rc;
    *w = int(p.W);
    *h = int(p.H);
    *c = (p.ctype == 2 || p.ctype == 3 || p.ctype == 6) ? 3 : 1;
    return 0;
  }
  return fail(msg, DIO_NOT_IMAGE, "neither a JPEG nor a PNG signature");
}

// Decode the window [x0, x0+cw) x [y0, y0+ch) into out (ch*cw*channels bytes,
// row-major, BGR or gray). Returns the channels, or a negative DIO_* code
// with a message in msg (kMsgLen bytes, may be null).
int dio_decode_crop(const uint8_t* buf, size_t len, int x0, int y0, int cw, int ch,
                    uint8_t* out, char* msg) {
  try {  // an allocation a header asks for may fail; no exception leaves C
    if (is_jpeg(buf, len)) return jpeg_decode_crop(buf, len, x0, y0, cw, ch, out, msg);
    if (is_png(buf, len)) return png_decode_crop(buf, len, x0, y0, cw, ch, out, msg);
  } catch (const std::bad_alloc&) {
    return fail(msg, DIO_MEMORY, "out of memory");
  }
  return fail(msg, DIO_NOT_IMAGE, "neither a JPEG nor a PNG signature");
}

static void* dio_worker(void* arg) {
  Queue* q = static_cast<Queue*>(arg);
  for (;;) {
    pthread_mutex_lock(&q->mu);
    int i = q->next < q->n ? q->next++ : -1;
    pthread_mutex_unlock(&q->mu);
    if (i < 0) return nullptr;
    Task& t = q->tasks[i];
    t.rc = dio_decode_crop(t.buf, t.len, t.x0, t.y0, t.cw, t.ch, t.out, t.msg);
  }
}

// Decode n windows over a pool of `threads` pthreads. params is n x 4 ints
// (x0, y0, cw, ch); rcs gets each item's channels or DIO_* code, msgs
// n * kMsgLen bytes of messages.
void dio_batch_decode_crop(int n, const uint8_t** bufs, const size_t* lens, const int* params,
                           uint8_t** outs, int* rcs, char* msgs, int threads) {
  std::vector<Task> tasks(size_t(n > 0 ? n : 0));
  for (int i = 0; i < n; ++i)
    tasks[i] = Task{bufs[i],       lens[i], params[4 * i], params[4 * i + 1], params[4 * i + 2],
                    params[4 * i + 3], outs[i], msgs + size_t(i) * kMsgLen, 0};
  if (threads > n) threads = n;
  if (threads < 1) threads = 1;
  Queue q{tasks.data(), n, 0, PTHREAD_MUTEX_INITIALIZER};
  if (threads == 1) {
    dio_worker(&q);
  } else {
    std::vector<pthread_t> tids;
    tids.resize(size_t(threads));
    int started = 0;
    for (; started < threads; ++started)
      if (pthread_create(&tids[started], nullptr, dio_worker, &q)) break;
    if (started == 0) dio_worker(&q);
    for (int t = 0; t < started; ++t) pthread_join(tids[t], nullptr);
  }
  for (int i = 0; i < n; ++i) rcs[i] = tasks[i].rc;
}

// Undo the PNG row filters of h rows of `stride` bytes (filter type byte
// first) into out (h rows of stride - 1 bytes); bpp is the left neighbour's
// distance in bytes. Returns 0, or -(1 + y) for row y's unknown filter type.
int dio_png_unfilter(const uint8_t* rows, int h, int stride, int bpp, uint8_t* out) {
  const size_t n = size_t(stride) - 1;
  std::vector<uint8_t> zero(n, 0);  // the row above the first
  const uint8_t* prev = zero.data();
  for (int y = 0; y < h; ++y) {
    uint8_t* cur = out + size_t(y) * n;
    memcpy(cur, rows + size_t(y) * stride + 1, n);
    if (!unfilter_row(cur, prev, n, bpp, rows[size_t(y) * stride])) return -(1 + y);
    prev = cur;
  }
  return 0;
}

int dio_msg_len(void) { return kMsgLen; }

}  // extern "C"
