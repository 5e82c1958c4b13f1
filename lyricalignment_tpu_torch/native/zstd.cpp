// A Zstandard frame decoder (RFC 8878), host C++ with no library, for the
// checkpoint reader (data/zstd.py, train/orbax.py).
//
// It decodes every frame of a buffer into one caller-owned output buffer:
// raw, RLE and compressed blocks; literals that are raw, RLE, Huffman-coded
// with one or four streams, or treeless (the previous block's Huffman
// table); FSE sequence tables in predefined, RLE, compressed and repeat
// modes; repeat offsets; frames with or without a content size, single
// segment or windowed; skippable frames; the XXH64 content checksum, checked
// when the frame carries one. Dictionaries are refused. Since the whole
// output is one buffer, the window is never copied: a match reads the bytes
// the frame already wrote.
//
// Every read is bounds-checked against the input and every write against the
// output's capacity; bad input raises an error that the C entry points turn
// into a return code and a message. Nothing here holds the GIL (ctypes
// releases it), so independent buffers decode in parallel on threads.
//
// Also here: CRC-32C (Castagnoli), the checksum of OCDBT manifests and nodes.

#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct OutputFull : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Corrupt(buf);
}

inline int highest_bit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts (x86-64, aarch64)
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(load_le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bit readers

// Backward bitstream (Huffman streams, FSE streams): the last byte holds a
// marker bit above the final bits; reading goes from the end to the start.
// Bits asked for before the start read as zeros and leave `off` negative,
// which the callers check.
struct BackBits {
  const uint8_t* src = nullptr;
  size_t len = 0;
  int64_t off = 0;  // bits not yet read

  void init(const uint8_t* s, size_t n) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = s[n - 1];
    if (last == 0) fail("bitstream has no end marker");
    src = s;
    len = n;
    off = int64_t(n) * 8 - (8 - highest_bit(last));
  }

  uint64_t read(int nbits) {
    if (nbits == 0) return 0;
    off -= nbits;
    int64_t at = off;
    int n = nbits;
    if (at < 0) {
      n += int(at);
      if (n <= 0) return 0;
      at = 0;
    }
    size_t byte = size_t(at) >> 3;
    int shift = int(at & 7);
    uint64_t v;
    if (byte + 8 <= len) {
      v = load64(src + byte);
    } else {
      v = load_le(src + byte, int(len - byte));
    }
    v = (v >> shift) & ((uint64_t(1) << n) - 1);
    if (off < 0) v <<= -off;
    return v;
  }
};

// Forward little-endian bit reader (FSE table descriptions). Bits past the
// end read as zeros; the caller checks the bytes used against the size.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;

  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; i++, pos++) {
      size_t byte = pos >> 3;
      if (byte < n) v |= uint32_t((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// ---------------------------------------------------------------- FSE

struct FSETable {
  int log = -1;  // -1: no table yet
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FSETable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  uint16_t next[256];
  uint32_t high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table spread does not close");
  for (uint32_t i = 0; i < size; i++) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - highest_bit(d);
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((uint32_t(d) << nb) - size);
  }
}

void fse_rle(FSETable& t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// Reads an FSE table description at p[0..n); returns the bytes it used.
size_t fse_read(FSETable& t, const uint8_t* p, size_t n, int max_log, int max_sym) {
  if (n == 0) fail("FSE table description is missing");
  FwdBits in{p, n};
  int log = 5 + int(in.read(4));
  if (log > max_log) fail("FSE accuracy log %d above %d", log, max_log);
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int nsym = 0;
  while (remaining > 0) {
    if (nsym > max_sym) fail("FSE table has too many symbols");
    int bits = highest_bit(uint64_t(remaining) + 1) + 1;
    uint32_t val = in.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - (uint32_t(remaining) + 1);
    if ((val & lower) < threshold) {
      in.pos -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = int16_t(proba);
    if (proba == 0) {
      uint32_t repeat;
      do {
        repeat = in.read(2);
        for (uint32_t i = 0; i < repeat; i++) {
          if (nsym > max_sym) fail("FSE table has too many symbols");
          norm[nsym++] = 0;
        }
      } while (repeat == 3);
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  size_t used = in.bytes_used();
  if (used > n) fail("FSE table description overruns its block");
  fse_build(t, norm, nsym, log);
  return used;
}

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint16_t> entry;  // symbol | code length << 8, by the next max_bits bits
};

constexpr int HUF_MAX_BITS = 11;

void huf_build(HufTable& t, const uint8_t* weights, int nw) {
  uint32_t sum = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > HUF_MAX_BITS + 1) fail("Huffman weight %d too large", weights[i]);
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) fail("Huffman weights are all zero");
  int max_bits = highest_bit(sum) + 1;
  uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail("Huffman weights do not complete a tree");
  if (max_bits > HUF_MAX_BITS) fail("Huffman code longer than %d bits", HUF_MAX_BITS);
  int nsym = nw + 1;
  if (nsym > 256) fail("Huffman table has too many symbols");
  uint8_t bits[256];
  for (int i = 0; i < nw; i++) bits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
  bits[nw] = uint8_t(max_bits + 1 - (highest_bit(left) + 1));

  // codes of the longest length take the lowest table ranges; within a
  // length, symbols in increasing order
  const uint32_t size = 1u << max_bits;
  t.max_bits = max_bits;
  t.entry.assign(size, 0);
  uint32_t count[HUF_MAX_BITS + 1] = {0};
  for (int i = 0; i < nsym; i++) count[bits[i]]++;
  uint32_t idx[HUF_MAX_BITS + 2];
  idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; b--) {
    idx[b - 1] = idx[b] + count[b] * (1u << (max_bits - b));
    if (idx[b - 1] > size) fail("Huffman code space overflows");
  }
  if (idx[0] != size) fail("Huffman code space is not filled");
  for (int i = 0; i < nsym; i++) {
    if (!bits[i]) continue;
    uint32_t len = 1u << (max_bits - bits[i]);
    uint16_t e = uint16_t(i | bits[i] << 8);
    for (uint32_t j = 0; j < len; j++) t.entry[idx[bits[i]] + j] = e;
    idx[bits[i]] += len;
  }
}

// Reads a Huffman tree description; returns the bytes it used.
size_t huf_read(HufTable& t, const uint8_t* p, size_t n) {
  if (n == 0) fail("Huffman tree description is missing");
  uint8_t weights[256];
  int nw = 0;
  size_t h = p[0];
  if (h >= 128) {
    nw = int(h) - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail("Huffman weights overrun their block");
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    huf_build(t, weights, nw);
    return 1 + bytes;
  }
  if (1 + h > n) fail("Huffman weights overrun their block");
  FSETable ft;
  size_t used = fse_read(ft, p + 1, h, 6, 12);
  if (used >= h) fail("Huffman weights have no bitstream");
  BackBits br;
  br.init(p + 1 + used, h - used);
  uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
  // two interleaved states; the stream ends when an update overruns it
  while (true) {
    if (nw >= 255) fail("too many Huffman weights");
    weights[nw++] = ft.sym[s1];
    s1 = ft.base[s1] + uint32_t(br.read(ft.nbits[s1]));
    if (br.off < 0) {
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = ft.sym[s2];
      break;
    }
    if (nw >= 255) fail("too many Huffman weights");
    weights[nw++] = ft.sym[s2];
    s2 = ft.base[s2] + uint32_t(br.read(ft.nbits[s2]));
    if (br.off < 0) {
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = ft.sym[s1];
      break;
    }
  }
  huf_build(t, weights, nw);
  return 1 + h;
}

// One Huffman stream: its bits and its state (the next max_bits bits).
struct HufCursor {
  BackBits br;
  uint32_t state = 0;

  void init(const HufTable& t, const uint8_t* src, size_t n) {
    br.init(src, n);
    state = uint32_t(br.read(t.max_bits));
  }
  inline uint8_t next(const uint16_t* entry, uint32_t mask) {
    uint16_t e = entry[state];
    int nb = e >> 8;
    state = ((state << nb) | uint32_t(br.read(nb))) & mask;
    return uint8_t(e);
  }
  // k symbols from one 64-bit load: needs 57 bits left (br.off >= 57) and
  // k * max_bits <= 57; the load then ends within the stream.
  inline void group(const uint16_t* entry, uint32_t mask, uint8_t* out, int k) {
    const int64_t lo = br.off - 57;
    const uint64_t w = load64(br.src + (lo >> 3)) >> (lo & 7);
    int64_t off = br.off;
    uint32_t st = state;
    for (int j = 0; j < k; j++) {
      uint16_t e = entry[st];
      int nb = e >> 8;
      off -= nb;
      st = ((st << nb) | uint32_t((w >> (off - lo)) & ((uint64_t(1) << nb) - 1))) & mask;
      out[j] = uint8_t(e);
    }
    br.off = off;
    state = st;
  }
  void finish(const HufTable& t) const {
    if (br.off != -int64_t(t.max_bits)) fail("Huffman stream not consumed exactly");
  }
};

void huf_stream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  HufCursor c;
  c.init(t, src, n);
  const uint16_t* entry = t.entry.data();
  const uint32_t mask = (1u << t.max_bits) - 1;
  const int k = 57 / t.max_bits;
  size_t i = 0;
  for (; i + k <= count && c.br.off >= 57; i += k) c.group(entry, mask, out + i, k);
  for (; i < count; i++) out[i] = c.next(entry, mask);
  c.finish(t);
}

// Four streams of `seg`, `seg`, `seg` and `last` symbols, decoded in
// step: their chains of table and bit reads are independent, so they
// overlap in the core. The streams' states live in locals (a byte store
// may alias any memory, so fields would be reloaded after each store).
void huf_streams4(const HufTable& t, const uint8_t* const src[4], const size_t n[4],
                  uint8_t* out, size_t seg, size_t last) {
  HufCursor c[4];
  for (int j = 0; j < 4; j++) c[j].init(t, src[j], n[j]);
  const uint16_t* entry = t.entry.data();
  const uint32_t mask = (1u << t.max_bits) - 1;
  const int k = 57 / t.max_bits;
  uint8_t* o[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
  int64_t off[4] = {c[0].br.off, c[1].br.off, c[2].br.off, c[3].br.off};
  uint32_t st[4] = {c[0].state, c[1].state, c[2].state, c[3].state};
  size_t i = 0;
  for (; i + k <= last && off[0] >= 57 && off[1] >= 57 && off[2] >= 57 && off[3] >= 57;
       i += k) {
    int64_t lo[4];
    uint64_t w[4];
    for (int j = 0; j < 4; j++) {
      lo[j] = off[j] - 57;
      w[j] = load64(src[j] + (lo[j] >> 3)) >> (lo[j] & 7);
    }
    for (int m = 0; m < k; m++) {
      for (int j = 0; j < 4; j++) {
        uint16_t e = entry[st[j]];
        int nb = e >> 8;
        off[j] -= nb;
        st[j] = ((st[j] << nb) | uint32_t((w[j] >> (off[j] - lo[j])) & ((uint64_t(1) << nb) - 1))) &
                mask;
        o[j][i + m] = uint8_t(e);
      }
    }
  }
  for (int j = 0; j < 4; j++) {
    c[j].br.off = off[j];
    c[j].state = st[j];
    size_t count = j < 3 ? seg : last;
    for (size_t m = i; m < count; m++) o[j][m] = c[j].next(entry, mask);
    c[j].finish(t);
  }
}

// ---------------------------------------------------------------- sequences

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FSETable ll, ml, of;
  Defaults() {
    fse_build(ll, LL_DEFAULT, 36, 6);
    fse_build(ml, ML_DEFAULT, 53, 6);
    fse_build(of, OF_DEFAULT, 29, 5);
  }
};

const Defaults& defaults() {
  static const Defaults d;  // thread-safe initialisation
  return d;
}

// ---------------------------------------------------------------- frames

constexpr size_t BLOCK_MAX = 128 * 1024;

struct Output {
  uint8_t* base;
  size_t cap;
  size_t pos;

  void room(size_t n) {
    if (n > cap - pos) throw OutputFull("output buffer too small");
  }
};

// Entropy state carried from block to block within one frame.
struct FrameState {
  HufTable huf;
  FSETable ll, ml, of;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
  FrameState() : lit(BLOCK_MAX) {}
};

// Literals section; returns the bytes it used and sets *nlit.
size_t read_literals(FrameState& st, const uint8_t* p, size_t n, size_t* nlit) {
  if (n == 0) fail("literals section is missing");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (type == 0 || type == 1) {  // raw, RLE
    size_t hdr, size;
    if (fmt == 0 || fmt == 2) {
      hdr = 1;
      size = p[0] >> 3;
    } else if (fmt == 1) {
      if (n < 2) fail("literals header truncated");
      hdr = 2;
      size = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      if (n < 3) fail("literals header truncated");
      hdr = 3;
      size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    if (size > BLOCK_MAX) fail("literals larger than a block");
    if (type == 0) {
      if (hdr + size > n) fail("raw literals overrun their block");
      memcpy(st.lit.data(), p + hdr, size);
      *nlit = size;
      return hdr + size;
    }
    if (hdr + 1 > n) fail("RLE literals overrun their block");
    memset(st.lit.data(), p[hdr], size);
    *nlit = size;
    return hdr + 1;
  }
  // Huffman-coded (2) or treeless (3)
  size_t hdr, regen, comp;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    if (n < 3) fail("literals header truncated");
    uint32_t c = uint32_t(load_le(p, 3));
    hdr = 3;
    regen = (c >> 4) & 0x3FF;
    comp = (c >> 14) & 0x3FF;
  } else if (fmt == 2) {
    if (n < 4) fail("literals header truncated");
    uint32_t c = load_le32(p);
    hdr = 4;
    regen = (c >> 4) & 0x3FFF;
    comp = (c >> 18) & 0x3FFF;
  } else {
    if (n < 5) fail("literals header truncated");
    uint64_t c = load_le(p, 5);
    hdr = 5;
    regen = size_t((c >> 4) & 0x3FFFF);
    comp = size_t((c >> 22) & 0x3FFFF);
  }
  if (regen > BLOCK_MAX) fail("literals larger than a block");
  if (hdr + comp > n) fail("compressed literals overrun their block");
  const uint8_t* q = p + hdr;
  size_t qn = comp;
  if (type == 2) {
    size_t used = huf_read(st.huf, q, qn);
    q += used;
    qn -= used;
  } else if (st.huf.max_bits == 0) {
    fail("treeless literals with no previous Huffman table");
  }
  uint8_t* out = st.lit.data();
  if (streams == 1) {
    huf_stream(st.huf, q, qn, out, regen);
  } else {
    if (qn < 6) fail("literals jump table truncated");
    size_t s1 = q[0] | size_t(q[1]) << 8, s2 = q[2] | size_t(q[3]) << 8,
           s3 = q[4] | size_t(q[5]) << 8;
    if (6 + s1 + s2 + s3 > qn) fail("literal streams overrun their section");
    size_t s4 = qn - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams");
    const uint8_t* s = q + 6;
    const uint8_t* src[4] = {s, s + s1, s + s1 + s2, s + s1 + s2 + s3};
    const size_t n[4] = {s1, s2, s3, s4};
    huf_streams4(st.huf, src, n, out, seg, regen - 3 * seg);
  }
  *nlit = regen;
  return hdr + comp;
}

size_t read_table(FSETable& t, int mode, const FSETable& def, const uint8_t* p, size_t n,
                  int max_log, int max_sym, const char* what) {
  switch (mode) {
    case 0:
      t = def;
      return 0;
    case 1:
      if (n < 1) fail("%s RLE symbol missing", what);
      if (p[0] > max_sym) fail("%s RLE symbol %d out of range", what, p[0]);
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_sym);
    default:
      if (t.log < 0) fail("%s repeat mode with no previous table", what);
      return 0;
  }
}

// A match of `len` bytes from `off` bytes back, which may overlap what it
// writes. Once `done` bytes are written, everything from dst - off on
// repeats with period off, so a chunk may copy from any whole number of
// periods back that does not reach into itself: the spans grow as the
// output does, and a short period costs O(log len) memcpy calls.
inline void copy_match(uint8_t* dst, size_t off, size_t len) {
  size_t done = 0;
  while (done < len) {
    size_t span = (off + done) / off * off;
    size_t k = len - done < span ? len - done : span;
    memcpy(dst + done, dst + done - span, k);
    done += k;
  }
}

void compressed_block(FrameState& st, const uint8_t* p, size_t n, Output& out,
                      size_t frame_start, size_t block_max) {
  size_t nlit = 0;
  size_t pos = read_literals(st, p, n, &nlit);
  if (pos >= n) fail("sequences section is missing");
  size_t nseq = p[pos];
  if (nseq == 0) {
    pos += 1;
  } else if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("sequence count truncated");
    nseq = p[pos + 1] + (size_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t block_start = out.pos;
  if (nseq == 0) {
    if (pos != n) fail("bytes after a block with no sequences");
    out.room(nlit);
    memcpy(out.base + out.pos, st.lit.data(), nlit);
    out.pos += nlit;
    return;
  }
  if (pos >= n) fail("sequence table modes missing");
  uint8_t modes = p[pos++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  const Defaults& d = defaults();
  pos += read_table(st.ll, modes >> 6, d.ll, p + pos, n - pos, 9, 35, "literal-length");
  pos += read_table(st.of, (modes >> 4) & 3, d.of, p + pos, n - pos, 8, 31, "offset");
  pos += read_table(st.ml, (modes >> 2) & 3, d.ml, p + pos, n - pos, 9, 52, "match-length");
  if (pos >= n) fail("sequence bitstream is missing");

  BackBits br;
  br.init(p + pos, n - pos);
  const FSETable &ll = st.ll, &of = st.of, &ml = st.ml;
  uint32_t sll = uint32_t(br.read(ll.log));
  uint32_t sof = uint32_t(br.read(of.log));
  uint32_t sml = uint32_t(br.read(ml.log));
  size_t lit_pos = 0;
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < nseq; i++) {
    uint32_t of_code = of.sym[sof], ll_code = ll.sym[sll], ml_code = ml.sym[sml];
    if (ll_code > 35 || ml_code > 52 || of_code > 31) fail("sequence code out of range");
    uint64_t ofv = (uint64_t(1) << of_code) + br.read(int(of_code));
    size_t mlen = ML_BASE[ml_code] + size_t(br.read(ML_BITS[ml_code]));
    size_t llen = LL_BASE[ll_code] + size_t(br.read(LL_BITS[ll_code]));
    if (i + 1 < nseq) {
      sll = ll.base[sll] + uint32_t(br.read(ll.nbits[sll]));
      sml = ml.base[sml] + uint32_t(br.read(ml.nbits[sml]));
      sof = of.base[sof] + uint32_t(br.read(of.nbits[sof]));
    }
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      uint32_t idx = uint32_t(ofv) - 1 + (llen == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx < 3 ? rep[idx] : rep[0] - 1;
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (llen > nlit - lit_pos) fail("sequence reads past the literals");
    out.room(llen);
    memcpy(out.base + out.pos, st.lit.data() + lit_pos, llen);
    out.pos += llen;
    lit_pos += llen;
    if (offset == 0 || offset > out.pos - frame_start) fail("match offset before the frame start");
    out.room(mlen);
    copy_match(out.base + out.pos, size_t(offset), mlen);
    out.pos += mlen;
    if (out.pos - block_start > block_max) fail("block larger than its maximum size");
  }
  if (br.off != 0) fail("sequence bitstream not consumed exactly");
  size_t rest = nlit - lit_pos;
  out.room(rest);
  memcpy(out.base + out.pos, st.lit.data() + lit_pos, rest);
  out.pos += rest;
  if (out.pos - block_start > block_max) fail("block larger than its maximum size");
}

struct FrameHeader {
  size_t size;  // header bytes, magic included
  bool has_fcs, checksum;
  uint64_t fcs, window;
};

FrameHeader frame_header(const uint8_t* p, size_t n) {
  if (n < 5) fail("frame header truncated");
  FrameHeader h{};
  uint8_t fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  h.checksum = (fhd >> 2) & 1;
  size_t pos = 5;
  if (!single) {
    if (pos >= n) fail("frame header truncated");
    uint8_t wd = p[pos++];
    int wlog = 10 + (wd >> 3);
    uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * (wd & 7);
  }
  static const int did_bytes[4] = {0, 1, 2, 4};
  if (pos + did_bytes[did_flag] > n) fail("frame header truncated");
  if (did_flag && load_le(p + pos, did_bytes[did_flag]) != 0) fail("frame needs a dictionary");
  pos += did_bytes[did_flag];
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 && single ? 1 : fcs_bytes[fcs_flag];
  if (pos + fb > n) fail("frame header truncated");
  h.has_fcs = fb > 0;
  if (fb) {
    h.fcs = load_le(p + pos, fb) + (fb == 2 ? 256 : 0);
    pos += fb;
  }
  if (single) h.window = h.fcs;
  h.size = pos;
  return h;
}

constexpr uint32_t MAGIC = 0xFD2FB528u;

inline bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Decodes the frame at p[0..n) into out; returns the input bytes it used.
size_t decode_frame(const uint8_t* p, size_t n, Output& out) {
  if (n < 4) fail("truncated frame magic");
  uint32_t magic = load_le32(p);
  if (skippable(magic)) {
    if (n < 8) fail("skippable frame truncated");
    uint64_t size = load_le32(p + 4);
    if (8 + size > n) fail("skippable frame truncated");
    return size_t(8 + size);
  }
  if (magic != MAGIC) fail("not a zstd frame (magic %08x)", magic);
  FrameHeader h = frame_header(p, n);
  size_t block_max = h.window < BLOCK_MAX ? size_t(h.window) : BLOCK_MAX;
  size_t frame_start = out.pos;
  FrameState st;
  size_t pos = h.size;
  while (true) {
    if (pos + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(load_le(p + pos, 3));
    pos += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (size > block_max) fail("block larger than its maximum size");
    if (type == 0) {
      if (pos + size > n) fail("raw block truncated");
      out.room(size);
      memcpy(out.base + out.pos, p + pos, size);
      out.pos += size;
      pos += size;
    } else if (type == 1) {
      if (pos + 1 > n) fail("RLE block truncated");
      out.room(size);
      memset(out.base + out.pos, p[pos], size);
      out.pos += size;
      pos += 1;
    } else if (type == 2) {
      if (pos + size > n) fail("compressed block truncated");
      compressed_block(st, p + pos, size, out, frame_start, block_max);
      pos += size;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  size_t produced = out.pos - frame_start;
  if (h.has_fcs && produced != h.fcs) fail("frame content size does not match its header");
  if (h.checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    uint32_t want = load_le32(p + pos);
    pos += 4;
    if (uint32_t(xxh64(out.base + frame_start, produced)) != want)
      fail("content checksum mismatch");
  }
  return pos;
}

// Input bytes of the frame at p[0..n) without decoding it; adds its declared
// content size to *total or sets *known to false.
size_t skip_frame(const uint8_t* p, size_t n, uint64_t* total, bool* known) {
  if (n < 4) fail("truncated frame magic");
  uint32_t magic = load_le32(p);
  if (skippable(magic)) {
    if (n < 8) fail("skippable frame truncated");
    uint64_t size = load_le32(p + 4);
    if (8 + size > n) fail("skippable frame truncated");
    return size_t(8 + size);
  }
  if (magic != MAGIC) fail("not a zstd frame (magic %08x)", magic);
  FrameHeader h = frame_header(p, n);
  if (h.has_fcs)
    *total += h.fcs;
  else
    *known = false;
  size_t pos = h.size;
  while (true) {
    if (pos + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(load_le(p + pos, 3));
    pos += 3;
    int type = (bh >> 1) & 3;
    size_t size = type == 1 ? 1 : bh >> 3;
    if (type == 3) fail("reserved block type");
    if (pos + size > n) fail("block truncated");
    pos += size;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    pos += 4;
  }
  return pos;
}

void set_error(char* err, size_t errcap, const char* msg) {
  if (err && errcap) snprintf(err, errcap, "%s", msg);
}

uint32_t CRC_TABLE[8][256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      CRC_TABLE[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int t = 1; t < 8; t++)
        CRC_TABLE[t][i] = (CRC_TABLE[t - 1][i] >> 8) ^ CRC_TABLE[0][CRC_TABLE[t - 1][i] & 0xFF];
  }
} crc_init;

}  // namespace

extern "C" {

// Bytes decoded by every frame of src[0..n) when each declares its content
// size; -1 when one does not, -2 (message in err) when the input is malformed.
long long la_zstd_content_size(const uint8_t* src, size_t n, char* err, size_t errcap) {
  try {
    uint64_t total = 0;
    bool known = true;
    size_t pos = 0;
    if (n == 0) fail("empty input");
    while (pos < n) pos += skip_frame(src + pos, n - pos, &total, &known);
    return known ? (long long)total : -1;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -2;
  }
}

// Decodes every frame of src[0..n) into dst[0..cap); returns the bytes
// written, -1 (message in err) for corrupt or truncated input, -2 when the
// output does not fit in cap.
long long la_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err,
                             size_t errcap) {
  try {
    Output out{dst, cap, 0};
    size_t pos = 0;
    if (n == 0) fail("empty input");
    while (pos < n) pos += decode_frame(src + pos, n - pos, out);
    return (long long)out.pos;
  } catch (const OutputFull& e) {
    set_error(err, errcap, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
}

// CRC-32C (Castagnoli) of p[0..n), slicing by 8.
uint32_t la_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    c ^= load_le32(p);
    uint32_t hi = load_le32(p + 4);
    c = CRC_TABLE[7][c & 0xFF] ^ CRC_TABLE[6][(c >> 8) & 0xFF] ^ CRC_TABLE[5][(c >> 16) & 0xFF] ^
        CRC_TABLE[4][c >> 24] ^ CRC_TABLE[3][hi & 0xFF] ^ CRC_TABLE[2][(hi >> 8) & 0xFF] ^
        CRC_TABLE[1][(hi >> 16) & 0xFF] ^ CRC_TABLE[0][hi >> 24];
  }
  for (; n; n--, p++) c = CRC_TABLE[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
