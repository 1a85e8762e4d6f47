// The native half of the port's data path: for data/tfrecord.py,
// CRC32-Castagnoli (slicing-by-8) and a single-pass shard scan, a copy of
// vit_unet_tpu/data/_native.cc; for data/image_io.py, the reversal of PNG's
// row filters.  A plain C interface instead of CPython entry points, so it
// needs no Python headers: data/_native.py builds it at first use with the
// host's C++ compiler and loads it with ctypes.
//
// Record framing (little-endian):
//     uint64 length | masked_crc32c(length) | payload | masked_crc32c(payload)
#include <cstddef>
#include <cstdint>
#include <cstring>

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

}  // extern "C"
