// The native half of the port's data path: for data/tfrecord.py,
// CRC32-Castagnoli (slicing-by-8) and a single-pass shard scan, a copy of
// vit_unet_tpu/data/_native.cc; for data/image_io.py, the reversal of PNG's
// row filters and a JPEG decoder (marker parser, Huffman entropy decode,
// IDCT, upsampling and colour conversion).  A plain C interface instead of CPython entry points, so it
// needs no Python headers: data/_native.py builds it at first use with the
// host's C++ compiler and loads it with ctypes.
//
// Record framing (little-endian):
//     uint64 length | masked_crc32c(length) | payload | masked_crc32c(payload)
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ (0x82F63B78u & (0u - (crc & 1u)));
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables& tables() {
  static const Tables tab;  // built once, thread-safe
  return tab;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  const auto& g = tables().t;
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    chunk ^= crc;  // little-endian host (x86-64, arm64)
    crc = g[7][chunk & 0xFF] ^ g[6][(chunk >> 8) & 0xFF] ^
          g[5][(chunk >> 16) & 0xFF] ^ g[4][(chunk >> 24) & 0xFF] ^
          g[3][(chunk >> 32) & 0xFF] ^ g[2][(chunk >> 40) & 0xFF] ^
          g[1][(chunk >> 48) & 0xFF] ^ g[0][(chunk >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t masked(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

// --------------------------------------------------------------------------
// JPEG: a baseline / progressive Huffman decoder whose output is libjpeg-
// turbo's (3.1, as bundled in OpenCV 5.0) with its defaults: the integer
// ISLOW IDCT (jidctint.c), "fancy" triangle upsampling for h2v1, h1v2 and
// h2v2 (jdsample.c; plain replication for every other integer factor) and
// the fixed-point YCbCr -> RGB tables (jdcolor.c).  The whole coefficient
// image is decoded before the output stage, as libjpeg does for multi-scan
// files.  libjpeg block-smooths a progressive image whose scans leave low
// AC coefficients inexact (jdcoefct.c decompress_smooth_data); that is not
// copied here, and such a file is refused (kSmoothed).  Entropy data that runs into a marker or the end of the file is
// read as zero bits, and the rest of that restart interval is skipped, as
// libjpeg does after its "premature end of data segment" warning; data that
// ends before EOI reads as if EOI followed, as libjpeg's file source makes
// it (so a truncated file's missing blocks come out mid-gray).
// --------------------------------------------------------------------------
namespace jpeg {

enum Status {
  kOk = 0,
  kNotJpeg = -1,
  kCorrupt = -2,
  kArithmetic = -3,
  kLossless = -4,
  kHierarchical = -5,
  kPrecision = -6,
  kFourComponents = -7,
  kComponents = -8,
  kSampling = -9,
  kNoFrame = -10,
  kSmoothed = -11,
  kRgbCoded = -12,
};

// zig-zag index -> natural (row-major) index, with libjpeg's 16 guard
// entries so that a corrupt run past 63 stays inside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool present = false;
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer code
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
};

bool build_huff(Huff& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(h.look, 0, sizeof(h.look));
  std::memcpy(h.vals, vals, static_cast<size_t>(nvals));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valoff[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= kLookBits) {
        const int shift = kLookBits - len;
        for (int s = 0; s < (1 << shift); ++s)
          h.look[(code << shift) | s] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) return false;  // over-subscribed code lengths
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  h.present = true;
  return true;
}

// The entropy-coded bits of a scan: 0xFF00 stuffing removed, zero bits
// supplied past a marker or the end of the data.  `insufficient` is set
// when a read takes bits that are not in the data.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;   // bits in buf, MSB first
  int real = 0;  // of them, bits taken from the data
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (cnt <= 56) {
      int byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && *q == 0) {
            p = q + 1;
          } else {
            at_marker = true;
            p = q - 1;  // the 0xFF just before the marker code
            byte = 0;
          }
        } else {
          ++p;
        }
        if (!at_marker) real += 8;
      } else {
        at_marker = true;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int n) {
    buf <<= n;
    cnt -= n;
    real -= n;
    if (real < 0) {
      insufficient = true;
      real = 0;
    }
  }
  int get(int n) {  // n <= 16
    if (n == 0) return 0;
    if (cnt < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    consume(n);
    return v;
  }
  int decode(const Huff& h) {
    if (cnt < 16) fill();
    const uint16_t e = h.look[buf >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(buf >> (64 - len));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.vals[(h.valoff[len] + code) & 0xFF];
      }
    }
    consume(16);  // a code no table holds: libjpeg warns and takes 0
    return 0;
  }
  // after a restart interval: drop the buffered bits and step over RSTn
  void restart() {
    buf = 0;
    cnt = real = 0;
    if (!at_marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) ++p;
      while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    }
    if (p + 1 < end && p[0] == 0xFF && (p[1] & 0xF8) == 0xD0) {
      p += 2;
      at_marker = false;
    } else {
      at_marker = true;  // no RSTn where one belongs: zeros from here on
    }
    insufficient = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;   // downsampled size (libjpeg's downsampled_*)
  int bw = 0, bh = 0;          // blocks allocated: MCU-padded
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
  bool latched = false;        // quant table copied at its first scan
  int coef_bits[10];           // libjpeg's coef_bits: Al of the last scan
                               // of zig-zag 0..9, -1 before any
  int16_t quant[64];           // natural order, as libjpeg's ISLOW_MULT_TYPE
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool progressive = false;
  bool frame = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[4];
  int adobe_transform = -1;
  bool jfif = false;
  int orientation = 1;
  bool seen_app1 = false;
  bool header_only = false;   // parse to the first SOS, allocate nothing

  int u16(const uint8_t* q) { return (q[0] << 8) | q[1]; }

  // The first APP1's data from byte 6 on, read as a TIFF header and IFD0,
  // as OpenCV's ExifReader reads it; only the Orientation tag (0x0112).
  void parse_exif(const uint8_t* seg, int len) {
    if (len <= 6) return;
    const uint8_t* t = seg + 6;
    const int n = len - 6;
    if (n < 8) return;
    const bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
    auto r16 = [&](int o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](int o) -> uint32_t {
      return le ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                   (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24))
                : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                   (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
    };
    if (r16(2) != 42) return;
    const uint32_t ifd = r32(4);
    if (ifd + 2 > static_cast<uint32_t>(n)) return;
    const int entries = r16(static_cast<int>(ifd));
    for (int i = 0; i < entries; ++i) {
      const uint32_t e = ifd + 2 + 12u * static_cast<uint32_t>(i);
      if (e + 12 > static_cast<uint32_t>(n)) return;
      if (r16(static_cast<int>(e)) == 0x0112) {
        const int value = r16(static_cast<int>(e) + 8);
        if (value >= 1 && value <= 8) orientation = value;
        return;
      }
    }
  }

  int read_sof(const uint8_t* s, int len, int marker) {
    if (marker == 0xC3) return kLossless;
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7) return kHierarchical;
    if (marker >= 0xC9) return kArithmetic;
    if (frame || len < 6) return kCorrupt;
    if (s[0] != 8) return kPrecision;
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = s[5];
    if (ncomp == 4) return kFourComponents;
    if (ncomp != 1 && ncomp != 3) return kComponents;
    if (len < 6 + 3 * ncomp || width == 0 || height == 0) return kCorrupt;
    progressive = marker == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return kSampling;
      c.width = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (!header_only) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 10; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
    return kOk;
  }

  int read_dqt(const uint8_t* s, int len) {
    int o = 0;
    while (o < len) {
      const int pq = s[o] >> 4, tq = s[o] & 3;
      ++o;
      if (o + 64 * (pq + 1) > len) return kCorrupt;
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16(s + o + 2 * i) : s[o + i]);
      qt_present[tq] = true;
      o += 64 * (pq + 1);
    }
    return kOk;
  }

  int read_dht(const uint8_t* s, int len) {
    int o = 0;
    while (o < len) {
      if (o + 17 > len) return kCorrupt;
      const int tc = s[o] >> 4, th = s[o] & 3;
      const uint8_t* counts = s + o + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || o + 17 + total > len) return kCorrupt;
      if (!build_huff(tc ? ac[th] : dc[th], counts, s + o + 17, total)) return kCorrupt;
      o += 17 + total;
    }
    return kOk;
  }

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
  }

  // One scan's entropy-coded segment, from p on; leaves p at the marker
  // that ends it.
  int read_scan(const uint8_t* s, int len) {
    if (!frame) return kNoFrame;
    if (len < 1) return kCorrupt;
    const int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return kCorrupt;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (!sc[i]) return kCorrupt;
      sc[i]->dc_tbl = s[2 + 2 * i] >> 4 & 3;
      sc[i]->ac_tbl = s[2 + 2 * i] & 3;
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return kCorrupt;
    } else if (ss != 0 || se != 63 || ah || al) {
      return kCorrupt;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!qt_present[c.tq]) return kCorrupt;
        for (int i = 0; i < 64; ++i) c.quant[i] = static_cast<int16_t>(qt[c.tq][i]);
        c.latched = true;
      }
      const bool dc_needed = !progressive || (ss == 0 && ah == 0);
      const bool ac_needed = !progressive || ss > 0;
      if ((dc_needed && !dc[c.dc_tbl].present) || (ac_needed && !ac[c.ac_tbl].present))
        return kCorrupt;
      c.dc_pred = 0;
      for (int k = ss; k <= se && k < 10; ++k) c.coef_bits[k] = al;
    }
    Bits br{p, end};
    int eobrun = 0;
    auto decode_block = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        int t = br.decode(dc[c.dc_tbl]);
        int diff = t ? extend(br.get(t), t) : 0;
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huff& h = ac[c.ac_tbl];
        for (int k = 1; k < 64; ++k) {
          int rs = br.decode(h);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {  // DC scans
        if (ah == 0) {
          int t = br.decode(dc[c.dc_tbl]);
          int diff = t ? extend(br.get(t), t) : 0;
          c.dc_pred += diff;
          blk[0] = static_cast<int16_t>(c.dc_pred * (1 << al));
        } else if (br.get(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {  // AC first
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        const Huff& h = ac[c.ac_tbl];
        for (int k = ss; k <= se; ++k) {
          int rs = br.decode(h);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            --eobrun;
            break;
          }
        }
      } else {  // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huff& h = ac[c.ac_tbl];
        int k = ss;
        auto refine = [&](int16_t& coef) {
          if (br.get(1) && (coef & p1) == 0)
            coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
        };
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int rs = br.decode(h);
            int r = rs >> 4, sz = rs & 15;
            int val = 0;
            if (sz) {
              val = br.get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += br.get(r);
              break;
            }
            do {
              int16_t& coef = blk[kNatural[k]];
              if (coef != 0) {
                refine(coef);
              } else {
                if (--r < 0) break;
              }
              ++k;
            } while (k <= se);
            if (val) blk[kNatural[k]] = static_cast<int16_t>(val);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t& coef = blk[kNatural[k]];
            if (coef != 0) refine(coef);
          }
          --eobrun;
        }
      }
    };
    int todo = restart_interval;
    auto next_mcu = [&]() {
      if (restart_interval && todo == 0) {
        br.restart();
        eobrun = 0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        todo = restart_interval;
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      const int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          next_mcu();
          if (!br.insufficient) decode_block(c, block(c, by, bx));
          if (restart_interval) --todo;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          next_mcu();
          if (!br.insufficient)
            for (int i = 0; i < ns; ++i) {
              Component& c = *sc[i];
              for (int v = 0; v < c.v; ++v)
                for (int h = 0; h < c.h; ++h)
                  decode_block(c, block(c, my * c.v + v, mx * c.h + h));
            }
          if (restart_interval) --todo;
        }
    }
    // the marker that ends the scan
    const uint8_t* q = br.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF &&
                            (q[1] & 0xF8) != 0xD0))
      ++q;
    p = q;
    return kOk;
  }

  // Markers up to the first SOS (header = true) or to EOI.
  int parse() {
    p = data;
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return kNotJpeg;
    p += 2;
    for (;;) {
      while (p < end && *p != 0xFF) ++p;     // stray bytes between segments
      while (p < end && *p == 0xFF) ++p;     // fill bytes
      if (p >= end) return frame ? kOk : kNoFrame;   // no EOI: libjpeg's fake one
      const int marker = *p++;
      if (marker == 0xD9) return frame ? kOk : kNoFrame;
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (end - p < 2) return kCorrupt;
      const int len = u16(p) - 2;
      const uint8_t* seg = p + 2;
      if (len < 0 || end - seg < len) return kCorrupt;
      p = seg + len;
      int rc = kOk;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        rc = read_sof(seg, len, marker);
      } else if (marker == 0xCC) {
        rc = kArithmetic;
      } else if (marker == 0xC4) {
        rc = read_dht(seg, len);
      } else if (marker == 0xDB) {
        rc = read_dqt(seg, len);
      } else if (marker == 0xDD) {
        if (len < 2) return kCorrupt;
        restart_interval = u16(seg);
      } else if (marker == 0xE0) {
        if (len >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xE1) {
        if (!seen_app1) parse_exif(seg, len);
        seen_app1 = true;
      } else if (marker == 0xEE) {
        if (len >= 12 && std::memcmp(seg, "Adobe", 5) == 0) adobe_transform = seg[11];
      } else if (marker == 0xDA) {
        if (header_only) return frame ? kOk : kNoFrame;
        rc = read_scan(seg, len);  // from p, the data after the header, to the next marker
      }
      if (rc != kOk) return rc;
    }
  }

  // libjpeg's smoothing_ok: after the last scan, it block-smooths a
  // progressive image whose DC is known in every component but one of
  // whose first nine AC coefficients is not yet exact in some component
  // (a file cut short, or a scan script that stops early)
  bool smoothed() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int k = 0; k < 10; ++k)
        if (c.quant[kNatural[k]] == 0) return false;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // libjpeg's default_decompress_parms: is a 3-component frame RGB-coded?
  bool rgb_coded() const {
    if (jfif) return false;
    if (adobe_transform >= 0) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
};

// jidctint.c's jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2), output
// through libjpeg's post-IDCT range-limit table.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = static_cast<uint8_t>(i < 128 ? 128 + i : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

constexpr int kConstBits = 13, kPass1Bits = 2;
#define VIT_DESCALE(x, n) (((x) + (int64_t(1) << ((n) - 1))) >> (n))

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = range_limit().t;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(VIT_DESCALE(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(VIT_DESCALE(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(VIT_DESCALE(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(VIT_DESCALE(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(VIT_DESCALE(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(VIT_DESCALE(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(VIT_DESCALE(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(VIT_DESCALE(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    constexpr int n = kConstBits + kPass1Bits + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = rl[static_cast<int>(VIT_DESCALE(int64_t(wp[0]), kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = rl[static_cast<int>(VIT_DESCALE(tmp10 + tmp3, n)) & 1023];
    op[7] = rl[static_cast<int>(VIT_DESCALE(tmp10 - tmp3, n)) & 1023];
    op[1] = rl[static_cast<int>(VIT_DESCALE(tmp11 + tmp2, n)) & 1023];
    op[6] = rl[static_cast<int>(VIT_DESCALE(tmp11 - tmp2, n)) & 1023];
    op[2] = rl[static_cast<int>(VIT_DESCALE(tmp12 + tmp1, n)) & 1023];
    op[5] = rl[static_cast<int>(VIT_DESCALE(tmp12 - tmp1, n)) & 1023];
    op[3] = rl[static_cast<int>(VIT_DESCALE(tmp13 + tmp0, n)) & 1023];
    op[4] = rl[static_cast<int>(VIT_DESCALE(tmp13 - tmp0, n)) & 1023];
  }
}
#undef VIT_DESCALE

// A component's samples at full size (width x height of the image), from
// its downsampled plane src (c.width x c.height, row stride sstride), as
// jdsample.c upsamples it.
void upsample(const Component& c, const uint8_t* src, int sstride, int hmax,
              int vmax, int width, int height, uint8_t* dst) {
  const int fh = hmax / c.h, fv = vmax / c.v;
  const int cw = c.width, ch = c.height;
  auto at = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
    x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
    return src[static_cast<size_t>(y) * sstride + x];
  };
  const bool fancy_h = cw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* out = dst + static_cast<size_t>(y) * width;
    if (fh == 1 && fv == 1) {
      std::memcpy(out, src + static_cast<size_t>(y) * sstride, static_cast<size_t>(width));
    } else if (fh == 2 && fv == 1 && fancy_h) {          // h2v1_fancy_upsample
      for (int x = 0; x < width; ++x) {
        const int i = x >> 1;
        const int near = at(y, i) * 3;
        out[x] = static_cast<uint8_t>(x & 1 ? (near + at(y, i + 1) + 2) >> 2
                                            : (near + at(y, i - 1) + 1) >> 2);
      }
    } else if (fh == 1 && fv == 2) {                     // h1v2_fancy_upsample
      const int j = y >> 1;
      const int other = y & 1 ? j + 1 : j - 1, bias = y & 1 ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = static_cast<uint8_t>((at(j, x) * 3 + at(other, x) + bias) >> 2);
    } else if (fh == 2 && fv == 2 && fancy_h) {          // h2v2_fancy_upsample
      const int j = y >> 1;
      const int other = y & 1 ? j + 1 : j - 1;
      auto colsum = [&](int i) { return at(j, i) * 3 + at(other, i); };
      for (int x = 0; x < width; ++x) {
        const int i = x >> 1;
        const int here = colsum(i) * 3;
        out[x] = static_cast<uint8_t>(x & 1 ? (here + colsum(i + 1) + 7) >> 4
                                            : (here + colsum(i - 1) + 8) >> 4);
      }
    } else {                                             // int_upsample
      const uint8_t* row = src + static_cast<size_t>(y / fv) * sstride;
      for (int x = 0; x < width; ++x) out[x] = row[x / fh];
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp8(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Decode every scan, then run the output stage into out: (height, width, 3)
// RGB, or (height, width) gray when gray is set (the luma plane of a
// YCbCr file, as libjpeg's JCS_GRAYSCALE output gives it).  A 3-component
// file libjpeg takes for RGB-coded is refused (kRgbCoded).
int decode(const uint8_t* data, int64_t n, bool gray, uint8_t* out) {
  auto d = std::make_unique<Decoder>();
  d->data = data;
  d->end = data + n;
  int rc = d->parse();
  if (rc != kOk) return rc;
  if (d->smoothed()) return kSmoothed;
  if (d->ncomp == 3 && d->rgb_coded()) return kRgbCoded;
  const int w = d->width, h = d->height;
  const size_t npix = static_cast<size_t>(w) * h;
  const int planes = gray ? 1 : d->ncomp;
  std::vector<uint8_t> full(static_cast<size_t>(planes) * npix);
  std::vector<uint8_t> down;
  for (int ci = 0; ci < planes; ++ci) {
    Component& c = d->comp[ci];
    const int stride = c.bw * 8;
    down.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(d->block(c, by, bx), c.quant,
                   down.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    upsample(c, down.data(), stride, d->hmax, d->vmax, w, h, full.data() + ci * npix);
  }
  const ColorTables& t = color_tables();
  const uint8_t* p0 = full.data();
  if (planes == 1) {
    if (gray) {
      std::memcpy(out, p0, npix);
    } else {
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p0[i];
    }
    return kOk;
  }
  const uint8_t* p1 = p0 + npix;
  const uint8_t* p2 = p1 + npix;
  for (size_t i = 0; i < npix; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp8(y + t.cr_r[cr]);
    out[3 * i + 1] = clamp8(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp8(y + t.cb_b[cb]);
  }
  return kOk;
}

}  // namespace jpeg

extern "C" {

uint32_t vit_crc32c(const uint8_t* data, uint64_t n) {
  return crc32c(data, static_cast<size_t>(n));
}

// Scan the records of buf[0, n) from byte *pos on, writing each record's
// (payload offset, payload length) into spans[2 i], spans[2 i + 1] for at
// most max_spans records.  On return *count holds the records written and
// *pos the offset of the first record not taken (the faulty record's on an
// error).  Returns 0 at the end of the buffer, 1 when spans is full, and on
// a fault: -1 a header cut short (fewer than 16 bytes left), -2 a length
// running past the end, -3 a corrupt header CRC, -4 a corrupt payload CRC.
int vit_scan_records(const uint8_t* buf, uint64_t n, int verify,
                     uint64_t* spans, int64_t max_spans, int64_t* count,
                     uint64_t* pos) {
  uint64_t p = *pos;
  int64_t k = 0;
  int rc = 0;
  while (p < n) {
    if (k == max_spans) {
      rc = 1;
      break;
    }
    if (n - p < 16) {
      rc = -1;
      break;
    }
    uint64_t length;
    std::memcpy(&length, buf + p, 8);
    // overflow-safe: p + 16 + length can wrap for a length near 2^64
    if (length > n - p - 16) {
      rc = -2;
      break;
    }
    if (verify) {
      uint32_t hcrc, pcrc;
      std::memcpy(&hcrc, buf + p + 8, 4);
      std::memcpy(&pcrc, buf + p + 12 + length, 4);
      if (masked(crc32c(buf + p, 8)) != hcrc) {
        rc = -3;
        break;
      }
      if (masked(crc32c(buf + p + 12, static_cast<size_t>(length))) != pcrc) {
        rc = -4;
        break;
      }
    }
    spans[2 * k] = p + 12;
    spans[2 * k + 1] = length;
    ++k;
    p += 16 + length;
  }
  *count = k;
  *pos = p;
  return rc;
}

// Reverse PNG's per-row filters (ISO 15948, section 9): src holds height
// rows of 1 + rowbytes bytes, each a filter type byte (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth) and the filtered row; dst receives height rows of
// rowbytes unfiltered bytes.  bpp is the bytes per complete pixel, at least
// 1.  Sub, Average and Paeth read the row's own unfiltered bytes bpp to the
// left, so each row is one sequential pass.  Returns 0, or -(r + 1) for the
// first row r whose filter type is unknown.
int64_t vit_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                         int64_t rowbytes, int64_t bpp) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* in = src + r * (rowbytes + 1);
    const uint8_t type = *in++;
    uint8_t* out = dst + r * rowbytes;
    const uint8_t* up = r ? out - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, static_cast<size_t>(rowbytes));
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

// The header of the JPEG data[0, n): info[0..4] = height, width, component
// count, EXIF orientation (1-8; 1 without the tag) and whether it is
// progressive.  Returns 0 or a negative jpeg::Status.
int64_t vit_jpeg_info(const uint8_t* data, int64_t n, int64_t* info) {
  auto d = std::make_unique<jpeg::Decoder>();
  d->data = data;
  d->end = data + n;
  d->header_only = true;
  const int rc = d->parse();
  if (rc != jpeg::kOk) return rc;
  info[0] = d->height;
  info[1] = d->width;
  info[2] = d->ncomp;
  info[3] = d->orientation;
  info[4] = d->progressive;
  return 0;
}

// Decode the JPEG data[0, n) into out: height x width x 3 RGB bytes, or
// height x width gray bytes when gray is nonzero, as stored (the EXIF
// orientation is the caller's).  Returns 0 or a negative jpeg::Status.
int64_t vit_jpeg_decode(const uint8_t* data, int64_t n, int64_t gray, uint8_t* out) {
  return jpeg::decode(data, n, gray != 0, out);
}

}  // extern "C"
