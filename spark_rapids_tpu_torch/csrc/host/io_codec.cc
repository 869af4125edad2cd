// Host byte loops of the port's Parquet reader and writer (io/parquet.py).
//
// A plain C interface, built with g++ at first use and loaded with ctypes
// (kernels.py::host_library). It is the port's counterpart of what pyarrow
// does in C++ for the JAX package (spark_rapids_tpu/io/files.py, writer.py):
//
// * snappy decompress and compress (the raw snappy format: a varint length,
//   then literal and copy elements); the compressor is the usual greedy
//   4-byte-hash LZ77 over 64 KiB blocks;
// * the RLE/bit-packed hybrid (definition levels, dictionary indices and v2
//   booleans) into int32, and the writer's encoder of it;
// * the PLAIN BYTE_ARRAY scan (4-byte length prefixes to Arrow offsets and a
//   byte buffer) and its reverse;
// * bit-packed booleans both ways;
// * the min and max of a string column by unsigned bytes;
// * the LZ4 frame format (lz4_Frame_format.md: magic, frame descriptor with
//   its xxHash32 header checksum, sized blocks, end mark, optional block
//   and content checksums) both ways, for the shuffle codec
//   (shuffle/compression.py). The compressor writes independent 4 MiB
//   blocks of greedy 4-byte-hash LZ77 sequences with a content checksum;
//   the decompressor reads any frame without a dictionary, linked blocks
//   included.
//
// Every function checks its bounds and returns a negative number on
// malformed input; the Python side turns that into an error naming the
// column.
#include <cstdint>
#include <cstring>

extern "C" {

int32_t srt_io_version() { return 1; }

// ── snappy ──────────────────────────────────────────────────────────────

static inline int64_t read_varint32(const uint8_t* p, int64_t n, uint32_t* out) {
  uint32_t v = 0;
  for (int64_t i = 0; i < n && i < 5; i++) {
    v |= uint32_t(p[i] & 0x7f) << (7 * i);
    if (!(p[i] & 0x80)) {
      *out = v;
      return i + 1;
    }
  }
  return -1;
}

// The uncompressed length a snappy stream declares, or -1.
int64_t srt_snappy_uncompressed_length(const uint8_t* in, int64_t n) {
  uint32_t len;
  if (read_varint32(in, n, &len) < 0) return -1;
  return len;
}

// Decompress ``in[0:n]`` into ``out`` (capacity ``cap``). Returns the bytes
// written, or a negative number on a malformed stream.
int64_t srt_snappy_decompress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  uint32_t len;
  int64_t ip = read_varint32(in, n, &len);
  if (ip < 0) return -1;
  if (int64_t(len) > cap) return -2;
  int64_t op = 0;
  while (ip < n) {
    uint8_t tag = in[ip++];
    int kind = tag & 3;
    if (kind == 0) {  // literal
      int64_t lit = (tag >> 2) + 1;
      if (lit > 60) {
        int extra = int(lit - 60);
        if (ip + extra > n) return -3;
        lit = 0;
        for (int i = 0; i < extra; i++) lit |= int64_t(in[ip + i]) << (8 * i);
        lit += 1;
        ip += extra;
      }
      if (ip + lit > n || op + lit > int64_t(len)) return -4;
      std::memcpy(out + op, in + ip, size_t(lit));
      ip += lit;
      op += lit;
      continue;
    }
    int64_t length, offset;
    if (kind == 1) {
      if (ip + 1 > n) return -5;
      length = ((tag >> 2) & 7) + 4;
      offset = (int64_t(tag >> 5) << 8) | in[ip];
      ip += 1;
    } else if (kind == 2) {
      if (ip + 2 > n) return -5;
      length = (tag >> 2) + 1;
      offset = int64_t(in[ip]) | (int64_t(in[ip + 1]) << 8);
      ip += 2;
    } else {
      if (ip + 4 > n) return -5;
      length = (tag >> 2) + 1;
      offset = int64_t(in[ip]) | (int64_t(in[ip + 1]) << 8) | (int64_t(in[ip + 2]) << 16) |
               (int64_t(in[ip + 3]) << 24);
      ip += 4;
    }
    if (offset <= 0 || offset > op || op + length > int64_t(len)) return -6;
    uint8_t* dst = out + op;
    const uint8_t* src = dst - offset;
    if (offset >= length) {
      std::memcpy(dst, src, size_t(length));
    } else {
      // an overlapping run: each step reads bytes written offset back
      int64_t i = 0;
      if (offset >= 8)
        for (; i + 8 <= length; i += 8) std::memcpy(dst + i, src + i, 8);
      for (; i < length; i++) dst[i] = src[i];
    }
    op += length;
  }
  return op == int64_t(len) ? op : -7;
}

// Worst-case compressed size of ``n`` bytes (snappy's MaxCompressedLength).
int64_t srt_snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

static inline uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *op++ = uint8_t(n << 2);
  } else {
    int bytes = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
    *op++ = uint8_t((59 + bytes) << 2);
    for (int i = 0; i < bytes; i++) *op++ = uint8_t(n >> (8 * i));
  }
  std::memcpy(op, lit, size_t(len));
  return op + len;
}

static inline uint8_t* emit_copy_upto64(uint8_t* op, int64_t offset, int64_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = uint8_t(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = uint8_t(offset & 0xff);
  } else {
    *op++ = uint8_t(2 | ((len - 1) << 2));
    *op++ = uint8_t(offset & 0xff);
    *op++ = uint8_t(offset >> 8);
  }
  return op;
}

static inline uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
  while (len >= 68) {
    op = emit_copy_upto64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, offset, len);
}

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint32_t hash32(uint32_t v, int shift) { return (v * 0x1e35a7bdu) >> shift; }

static const int64_t kBlock = 1 << 16;
static const int kHashBits = 14;

// One block of at most 64 KiB: greedy matching of 4-byte sequences through
// a hash table of their last positions, skipping faster over bytes that do
// not match (snappy's heuristic, so incompressible input stays cheap).
static uint8_t* compress_block(const uint8_t* base, int64_t n, uint8_t* op, uint16_t* table) {
  const int shift = 32 - kHashBits;
  std::memset(table, 0, sizeof(uint16_t) << kHashBits);
  int64_t lit_start = 0;
  if (n >= 15) {
    const int64_t limit = n - 15;  // room to load 4 bytes past any match start
    int64_t ip = 1;
    uint32_t skip = 32;
    while (ip <= limit) {
      uint32_t cur = load32(base + ip);
      uint32_t h = hash32(cur, shift);
      int64_t cand = table[h];
      table[h] = uint16_t(ip);
      if (cand < ip && load32(base + cand) == cur) {
        if (ip > lit_start) op = emit_literal(op, base + lit_start, ip - lit_start);
        int64_t len = 4;
        while (ip + len < n && base[cand + len] == base[ip + len]) len++;
        op = emit_copy(op, ip - cand, len);
        ip += len;
        lit_start = ip;
        skip = 32;
        if (ip <= limit) table[hash32(load32(base + ip - 1), shift)] = uint16_t(ip - 1);
        continue;
      }
      ip += skip++ >> 5;
    }
  }
  if (lit_start < n) op = emit_literal(op, base + lit_start, n - lit_start);
  return op;
}

// Compress ``in[0:n]`` into ``out`` (at least srt_snappy_max_compressed(n)
// bytes). Returns the compressed size.
int64_t srt_snappy_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  uint8_t* op = out;
  uint64_t v = uint64_t(n);
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    *op++ = v ? (b | 0x80) : b;
  } while (v);
  static thread_local uint16_t table[1 << kHashBits];
  for (int64_t start = 0; start < n; start += kBlock) {
    int64_t len = n - start < kBlock ? n - start : kBlock;
    op = compress_block(in + start, len, op, table);
  }
  return op - out;
}

// ── RLE / bit-packed hybrid ─────────────────────────────────────────────

static inline int64_t read_uleb(const uint8_t* p, int64_t n, int64_t* pos, uint64_t* out) {
  uint64_t v = 0;
  int s = 0;
  while (*pos < n && s < 64) {
    uint8_t b = p[(*pos)++];
    v |= uint64_t(b & 0x7f) << s;
    if (!(b & 0x80)) {
      *out = v;
      return 0;
    }
    s += 7;
  }
  return -1;
}

// Decode ``count`` values of bit width ``bw`` (0..32) from the hybrid
// stream ``in[0:n]`` into ``out``. Returns the bytes consumed, or a
// negative number when the stream ends early or is malformed.
int64_t srt_rle_decode(const uint8_t* in, int64_t n, int32_t bw, int32_t* out, int64_t count) {
  if (bw < 0 || bw > 32) return -1;
  int64_t pos = 0, got = 0;
  const int vbytes = (bw + 7) / 8;
  const uint64_t mask = bw == 32 ? 0xffffffffull : ((1ull << bw) - 1);
  while (got < count) {
    uint64_t header;
    if (read_uleb(in, n, &pos, &header) < 0) return -2;
    if (header & 1) {  // bit-packed groups of 8
      int64_t values = int64_t(header >> 1) * 8;
      int64_t bytes = int64_t(header >> 1) * bw;
      if (pos + bytes > n) {
        // the last group may be cut short by the page end
        bytes = n - pos;
      }
      const uint8_t* p = in + pos;
      int64_t take = values < count - got ? values : count - got;
      if (take * bw > bytes * 8) return -3;
      for (int64_t i = 0; i < take; i++) {
        int64_t bit = i * bw;
        int64_t byte = bit >> 3;
        int sh = int(bit & 7);
        uint64_t word = 0;
        int need = (sh + bw + 7) / 8;
        for (int k = 0; k < need; k++) word |= uint64_t(p[byte + k]) << (8 * k);
        out[got + i] = int32_t((word >> sh) & mask);
      }
      got += take;
      pos += bytes;
    } else {  // a run of one repeated value
      int64_t run = int64_t(header >> 1);
      if (pos + vbytes > n) return -4;
      uint64_t v = 0;
      for (int k = 0; k < vbytes; k++) v |= uint64_t(in[pos + k]) << (8 * k);
      pos += vbytes;
      int64_t take = run < count - got ? run : count - got;
      for (int64_t i = 0; i < take; i++) out[got + i] = int32_t(v & mask);
      got += take;
    }
  }
  return pos;
}

static inline uint8_t* write_uleb(uint8_t* op, uint64_t v) {
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    *op++ = v ? (b | 0x80) : b;
  } while (v);
  return op;
}

// Encode ``count`` values of bit width ``bw`` (1..32) as the hybrid: runs of
// at least 8 equal values as RLE runs, the rest as bit-packed groups of 8
// (the last group padded with zeros). ``out`` holds at least
// srt_rle_max_encoded(count, bw) bytes. Returns the bytes written.
int64_t srt_rle_max_encoded(int64_t count, int32_t bw) {
  return (count / 8 + 2) * (int64_t(bw) + 10) + 16;
}

int64_t srt_rle_encode(const int32_t* vals, int64_t count, int32_t bw, uint8_t* out) {
  uint8_t* op = out;
  const int vbytes = (bw + 7) / 8;
  int64_t i = 0;
  // pending bit-packed values start at ``pack_start`` (a multiple of 8 away
  // from i while packing)
  while (i < count) {
    int64_t run = 1;
    while (i + run < count && vals[i + run] == vals[i]) run++;
    if (run >= 8) {
      op = write_uleb(op, uint64_t(run) << 1);
      for (int k = 0; k < vbytes; k++) *op++ = uint8_t(uint32_t(vals[i]) >> (8 * k));
      i += run;
      continue;
    }
    // bit-pack groups of 8 until a run of 8 equal values starts on a group
    // boundary or the values end
    int64_t start = i;
    int64_t end = i;
    while (end < count) {
      int64_t r = 1;
      while (end + r < count && vals[end + r] == vals[end] && r < 8) r++;
      if (r >= 8 && end > start) break;
      end += 8;
    }
    if (end > count) end = count;
    int64_t groups = (end - start + 7) / 8;
    op = write_uleb(op, (uint64_t(groups) << 1) | 1);
    int64_t nbytes = groups * bw;
    std::memset(op, 0, size_t(nbytes));
    for (int64_t j = 0; j < end - start; j++) {
      uint64_t v = uint32_t(vals[start + j]);
      int64_t bit = j * bw;
      for (int b = 0; b < bw; b++, bit++)
        if ((v >> b) & 1) op[bit >> 3] |= uint8_t(1u << (bit & 7));
    }
    op += nbytes;
    i = end;
  }
  return op - out;
}

// ── PLAIN BYTE_ARRAY ────────────────────────────────────────────────────

// Scan ``count`` length-prefixed values of ``in[0:n]``: ``offsets`` gets
// count + 1 Arrow offsets starting at 0, ``data`` (capacity n) the bytes.
// Returns the bytes consumed, or a negative number on a value that runs
// past the end.
int64_t srt_byte_array_scan(const uint8_t* in, int64_t n, int64_t count, int32_t* offsets,
                            uint8_t* data) {
  int64_t pos = 0, op = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < count; i++) {
    if (pos + 4 > n) return -1;
    uint32_t len;
    std::memcpy(&len, in + pos, 4);
    pos += 4;
    if (int64_t(len) > n - pos) return -2;
    std::memcpy(data + op, in + pos, len);
    pos += len;
    op += len;
    if (op > 0x7fffffff) return -3;
    offsets[i + 1] = int32_t(op);
  }
  return pos;
}

// The reverse: the rows whose ``valid`` byte is set (all rows when
// ``valid`` is null) as length-prefixed values into ``out`` (capacity
// 4 * count + the bytes). Returns the bytes written.
int64_t srt_byte_array_encode(const int32_t* offsets, const uint8_t* data, const uint8_t* valid,
                              int64_t count, uint8_t* out) {
  uint8_t* op = out;
  for (int64_t i = 0; i < count; i++) {
    if (valid && !valid[i]) continue;
    uint32_t len = uint32_t(offsets[i + 1] - offsets[i]);
    std::memcpy(op, &len, 4);
    op += 4;
    std::memcpy(op, data + offsets[i], len);
    op += len;
  }
  return op - out;
}

// ── booleans ────────────────────────────────────────────────────────────

// ``count`` LSB-first bits of ``in`` (at least (count + 7) / 8 bytes) into
// one byte each.
void srt_unpack_bools(const uint8_t* in, int64_t count, uint8_t* out) {
  for (int64_t i = 0; i < count; i++) out[i] = (in[i >> 3] >> (i & 7)) & 1;
}

// The reverse; ``out`` holds (count + 7) / 8 bytes.
void srt_pack_bools(const uint8_t* in, int64_t count, uint8_t* out) {
  std::memset(out, 0, size_t((count + 7) / 8));
  for (int64_t i = 0; i < count; i++)
    if (in[i]) out[i >> 3] |= uint8_t(1u << (i & 7));
}

// ── string statistics ───────────────────────────────────────────────────

static inline int cmp_bytes(const uint8_t* a, int32_t la, const uint8_t* b, int32_t lb) {
  int32_t m = la < lb ? la : lb;
  int c = std::memcmp(a, b, size_t(m));  // memcmp compares unsigned bytes
  if (c) return c;
  return la < lb ? -1 : la > lb ? 1 : 0;
}

// The row indices of the least and greatest valid string by unsigned
// bytes into ``minmax[0..1]``; both -1 when no row is valid.
void srt_string_minmax(const int32_t* offsets, const uint8_t* data, const uint8_t* valid,
                       int64_t count, int64_t* minmax) {
  int64_t lo = -1, hi = -1;
  for (int64_t i = 0; i < count; i++) {
    if (valid && !valid[i]) continue;
    const uint8_t* s = data + offsets[i];
    int32_t len = offsets[i + 1] - offsets[i];
    if (lo < 0) {
      lo = hi = i;
      continue;
    }
    if (cmp_bytes(s, len, data + offsets[lo], offsets[lo + 1] - offsets[lo]) < 0) lo = i;
    if (cmp_bytes(s, len, data + offsets[hi], offsets[hi + 1] - offsets[hi]) > 0) hi = i;
  }
  minmax[0] = lo;
  minmax[1] = hi;
}

// ── LZ4 frame ───────────────────────────────────────────────────────────────

static const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                      P4 = 668265263u, P5 = 374761393u;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline void wr32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }

uint32_t srt_xxh32(const uint8_t* p, int64_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32(p) * P2, 13) * P1; p += 4;
      v2 = rotl32(v2 + rd32(p) * P2, 13) * P1; p += 4;
      v3 = rotl32(v3 + rd32(p) * P2, 13) * P1; p += 4;
      v4 = rotl32(v4 + rd32(p) * P2, 13) * P1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P5;
  }
  h += (uint32_t)n;
  while (p + 4 <= end) {
    h = rotl32(h + rd32(p) * P3, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P5, 11) * P1;
    p++;
  }
  h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
  return h;
}

static const int64_t kLz4Block = 4 << 20;  // BD code 7: 4 MiB blocks
static const int kLz4HashBits = 16;

// Worst-case frame size: header, per block its size word and the block
// stored raw, the end mark and the content checksum.
int64_t srt_lz4f_max_compressed(int64_t n) {
  int64_t blocks = n / kLz4Block + 1;
  return 7 + blocks * 4 + n + 4 + 4;
}

static inline uint8_t* lz4_len(uint8_t* op, int64_t len) {
  while (len >= 255) { *op++ = 255; len -= 255; }
  *op++ = (uint8_t)len;
  return op;
}

// One LZ4 block (the raw block format) of src[0:n] into op; the end of the
// written block. Matches stay at least 12 bytes from the end and the last
// 5 bytes are literals, as the format requires.
static uint8_t* lz4_block(const uint8_t* src, int64_t n, uint8_t* op, int32_t* table) {
  const int64_t mflimit = n - 12, matchlimit = n - 5;
  int64_t anchor = 0, ip = 0;
  if (n >= 13) {
    for (int i = 0; i < (1 << kLz4HashBits); i++) table[i] = -1;
    while (ip < mflimit) {
      uint32_t seq = rd32(src + ip);
      uint32_t h = (seq * 2654435761u) >> (32 - kLz4HashBits);
      int64_t ref = table[h];
      table[h] = (int32_t)ip;
      if (ref < 0 || ip - ref > 65535 || rd32(src + ref) != seq) {
        ip++;
        continue;
      }
      int64_t mlen = 4;
      while (ip + mlen < matchlimit && src[ref + mlen] == src[ip + mlen]) mlen++;
      int64_t lit = ip - anchor;
      uint8_t* token = op++;
      uint8_t t = (uint8_t)((lit >= 15 ? 15 : lit) << 4);
      if (lit >= 15) op = lz4_len(op, lit - 15);
      memcpy(op, src + anchor, lit);
      op += lit;
      uint16_t off = (uint16_t)(ip - ref);
      *op++ = (uint8_t)off;
      *op++ = (uint8_t)(off >> 8);
      int64_t ml = mlen - 4;
      t |= (uint8_t)(ml >= 15 ? 15 : ml);
      if (ml >= 15) op = lz4_len(op, ml - 15);
      *token = t;
      ip += mlen;
      anchor = ip;
    }
  }
  int64_t lit = n - anchor;
  *op++ = (uint8_t)((lit >= 15 ? 15 : lit) << 4);
  if (lit >= 15) op = lz4_len(op, lit - 15);
  memcpy(op, src + anchor, lit);
  return op + lit;
}

// Compress ``in[0:n]`` into one LZ4 frame in ``out`` (at least
// srt_lz4f_max_compressed(n) bytes); returns the frame's size.
int64_t srt_lz4f_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  uint8_t* op = out;
  wr32(op, 0x184D2204u);
  op += 4;
  op[0] = 0x64;  // version 01, independent blocks, content checksum
  op[1] = 0x70;  // 4 MiB block maximum
  op[2] = (uint8_t)(srt_xxh32(op, 2, 0) >> 8);
  op += 3;
  int32_t* table = new int32_t[1 << kLz4HashBits];
  uint8_t* tmp = new uint8_t[kLz4Block + kLz4Block / 255 + 64];
  for (int64_t pos = 0; pos < n; pos += kLz4Block) {
    int64_t len = n - pos < kLz4Block ? n - pos : kLz4Block;
    int64_t clen = lz4_block(in + pos, len, tmp, table) - tmp;
    if (clen < len) {
      wr32(op, (uint32_t)clen);
      memcpy(op + 4, tmp, clen);
      op += 4 + clen;
    } else {  // incompressible: stored raw, the high bit set
      wr32(op, (uint32_t)len | 0x80000000u);
      memcpy(op + 4, in + pos, len);
      op += 4 + len;
    }
  }
  delete[] table;
  delete[] tmp;
  wr32(op, 0);
  wr32(op + 4, srt_xxh32(in, n, 0));
  return op + 8 - out;
}

// Decode one raw LZ4 block into out[pos:cap]; back-references may reach
// earlier output (linked blocks). The new output position, or -1.
static int64_t lz4_unblock(const uint8_t* ip, int64_t n, uint8_t* out, int64_t pos, int64_t cap) {
  const uint8_t* end = ip + n;
  while (ip < end) {
    uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= end) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > end - ip || lit > cap - pos) return -1;
    memcpy(out + pos, ip, lit);
    ip += lit;
    pos += lit;
    if (ip == end) break;  // the last sequence holds literals only
    if (end - ip < 2) return -1;
    int64_t off = ip[0] | (ip[1] << 8);
    ip += 2;
    if (off == 0 || off > pos) return -1;
    int64_t ml = (token & 15);
    if (ml == 15) {
      uint8_t b;
      do {
        if (ip >= end) return -1;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (ml > cap - pos) return -1;
    const uint8_t* ref = out + pos - off;
    for (int64_t k = 0; k < ml; k++) out[pos + k] = ref[k];  // may overlap
    pos += ml;
  }
  return pos;
}

// Decompress one LZ4 frame into out[0:cap]; the bytes written, or a
// negative number on malformed input (-2: a dictionary id, -3: a checksum
// mismatch).
int64_t srt_lz4f_decompress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  if (n < 7 || rd32(in) != 0x184D2204u) return -1;
  const uint8_t* ip = in + 4;
  uint8_t flg = ip[0];
  if ((flg >> 6) != 1) return -1;
  bool block_ck = flg & 0x10, content_size = flg & 0x08, content_ck = flg & 0x04;
  if (flg & 0x01) return -2;
  int64_t desc = 2 + (content_size ? 8 : 0);
  if (n < 4 + desc + 1) return -1;
  if ((uint8_t)(srt_xxh32(ip, desc, 0) >> 8) != ip[desc]) return -3;
  ip += desc + 1;
  const uint8_t* end = in + n;
  int64_t pos = 0;
  while (true) {
    if (end - ip < 4) return -1;
    uint32_t word = rd32(ip);
    ip += 4;
    if (word == 0) break;
    int64_t len = word & 0x7FFFFFFFu;
    if (len > end - ip) return -1;
    if (block_ck) {
      if (end - ip < len + 4) return -1;
      if (srt_xxh32(ip, len, 0) != rd32(ip + len)) return -3;
    }
    if (word & 0x80000000u) {
      if (len > cap - pos) return -1;
      memcpy(out + pos, ip, len);
      pos += len;
    } else {
      pos = lz4_unblock(ip, len, out, pos, cap);
      if (pos < 0) return -1;
    }
    ip += len + (block_ck ? 4 : 0);
  }
  if (content_ck) {
    if (end - ip < 4) return -1;
    if (srt_xxh32(out, pos, 0) != rd32(ip)) return -3;
  }
  return pos;
}

}  // extern "C"
