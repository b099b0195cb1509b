// shifu_parser — native columnar parser for gzip pipe-delimited tabular data.
//
// The port's own copy of the JAX package's parser source, built by g++ at
// first use (shifu_tpu_torch/runtime/nativelib.py); host code, no CUDA.
//
// The input-format successor of the reference's per-line Python loader
// (reference: resources/ssgd_monitor.py:348-454 — gzip.readline + split('|')
// + float() per cell) and of its row counter
// (yarn/util/HdfsUtils.java:143-175 getFileLineCount).  That loader is the
// documented throughput anti-pattern (SURVEY.md §7.3 #1): reaching
// 10M samples/sec needs a C-speed parse, which this provides:
//
//   - zlib inflate for gzip (multi-member / concatenated files supported,
//     matching `gzip -c a >> f; gzip -c b >> f` HDFS part files),
//   - std::from_chars float parse (locale-free, no strtod malloc churn),
//   - optional multi-threaded parse: the buffer splits at newline boundaries,
//     threads write disjoint row ranges of one contiguous output.
//
// Semantics (bit-parity with shifu_tpu_torch/data/reader.py:parse_rows):
//   - column count = delimiter count in the first non-empty line + 1
//   - non-numeric / missing cells -> NaN (imputed downstream)
//   - extra cells beyond the column count are ignored
//   - empty lines are skipped; trailing '\r' is tolerated
//
// C ABI (ctypes from Python; JNA/JNI from Java):
//   shifu_parse_file / shifu_parse_buffer -> malloc'd [rows x cols] float32
//   shifu_parser_free, shifu_count_rows, shifu_parser_version

#include <dlfcn.h>
#include <zlib.h>

#include <atomic>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kVersion = 2;

// ---------------------------------------------------------------- file I/O

bool read_whole_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(size));
  bool ok = size == 0 ||
            std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) ==
                static_cast<size_t>(size);
  std::fclose(f);
  return ok;
}

bool is_gzip(const std::string& raw) {
  return raw.size() >= 2 && static_cast<unsigned char>(raw[0]) == 0x1f &&
         static_cast<unsigned char>(raw[1]) == 0x8b;
}

// ---------------------------------------------------------- libdeflate tier
// libdeflate decompresses gzip 2-3x faster than zlib's inflate but only
// works whole-buffer.  It is loaded lazily via dlopen so the parser builds
// and runs (on the zlib path below) when the library is absent.

struct LibDeflateApi {
  void* (*alloc_decompressor)();
  void (*free_decompressor)(void*);
  // libdeflate_gzip_decompress_ex: one gzip member per call; reports how many
  // input/output bytes it consumed/produced so members can be looped.
  int (*gzip_decompress_ex)(void*, const void*, size_t, void*, size_t,
                            size_t*, size_t*);
};

const LibDeflateApi* libdeflate_api() {
  static const LibDeflateApi* api = []() -> const LibDeflateApi* {
    void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return nullptr;
    static LibDeflateApi a;
    a.alloc_decompressor = reinterpret_cast<void* (*)()>(
        dlsym(h, "libdeflate_alloc_decompressor"));
    a.free_decompressor = reinterpret_cast<void (*)(void*)>(
        dlsym(h, "libdeflate_free_decompressor"));
    a.gzip_decompress_ex =
        reinterpret_cast<int (*)(void*, const void*, size_t, void*, size_t,
                                 size_t*, size_t*)>(
            dlsym(h, "libdeflate_gzip_decompress_ex"));
    if (!a.alloc_decompressor || !a.free_decompressor ||
        !a.gzip_decompress_ex) {
      dlclose(h);
      return nullptr;
    }
    return &a;
  }();
  return api;
}

// Whole-buffer gzip decompress via libdeflate, looping concatenated members.
// Same semantics as the zlib path: all-zero trailing padding is EOF, any
// other trailing junk or a truncated member is an error.
bool gunzip_libdeflate(const LibDeflateApi* api, const std::string& raw,
                       std::string* out) {
  void* d = api->alloc_decompressor();
  if (!d) return false;
  // Seed capacity from the gzip ISIZE trailer (last member's uncompressed
  // size mod 2^32) — exact for the common single-member file, so no
  // re-decompression retries; the 4x heuristic covers multi-member files
  // and zero-padded trailers (whose last 4 bytes are 0).
  size_t cap = raw.size() * 4 + (1 << 20);
  if (raw.size() >= 18) {
    const unsigned char* t =
        reinterpret_cast<const unsigned char*>(raw.data()) + raw.size() - 4;
    const size_t isize = static_cast<size_t>(t[0]) | (size_t{t[1]} << 8) |
                         (size_t{t[2]} << 16) | (size_t{t[3]} << 24);
    if (isize + (1 << 12) > cap) cap = isize + (1 << 12);
  }
  out->resize(cap);
  size_t written = 0, pos = 0;
  bool ok = true;
  while (pos < raw.size()) {
    if (raw[pos] == 0) {  // block-aligned writers pad with NULs: EOF if all 0
      bool all_zero = true;
      for (size_t i = pos; i < raw.size(); ++i)
        if (raw[i] != 0) { all_zero = false; break; }
      ok = all_zero;
      break;
    }
    if (raw.size() - pos < 2 ||
        static_cast<unsigned char>(raw[pos]) != 0x1f ||
        static_cast<unsigned char>(raw[pos + 1]) != 0x8b) {
      ok = false;  // trailing junk that is neither padding nor a member
      break;
    }
    size_t in_used = 0, out_used = 0;
    int rc = api->gzip_decompress_ex(d, raw.data() + pos, raw.size() - pos,
                                     &(*out)[written], cap - written,
                                     &in_used, &out_used);
    if (rc == 3) {  // LIBDEFLATE_INSUFFICIENT_SPACE: grow and retry member
      cap = cap * 4 + (1 << 20);
      out->resize(cap);
      continue;
    }
    if (rc != 0) {  // BAD_DATA / SHORT_OUTPUT: corrupt or truncated
      ok = false;
      break;
    }
    written += out_used;
    pos += in_used;
  }
  api->free_decompressor(d);
  if (!ok) return false;
  out->resize(written);
  return true;
}

// Inflate a (possibly multi-member) gzip buffer.  Uses libdeflate when the
// shared library is present, else zlib (inflateReset after each Z_STREAM_END
// continues into the next concatenated member).
bool gunzip(const std::string& raw, std::string* out) {
  if (const LibDeflateApi* api = libdeflate_api())
    return gunzip_libdeflate(api, raw, out);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
  out->clear();
  out->reserve(raw.size() * 4);
  std::vector<char> buf(1 << 20);
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(raw.data()));
  zs.avail_in = static_cast<uInt>(raw.size());
  int rc = Z_OK;
  bool complete = false;  // last member must end in Z_STREAM_END: a stream
                          // cut mid-member is corrupt, not "done" (parity
                          // with gzip.open's EOFError on truncation)
  while (zs.avail_in > 0) {
    zs.next_out = reinterpret_cast<Bytef*>(buf.data());
    zs.avail_out = static_cast<uInt>(buf.size());
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) break;
    out->append(buf.data(), buf.size() - zs.avail_out);
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) {
        complete = true;                    // clean end of last member
        break;
      }
      // gzip.GzipFile parity for bytes after a member: all-zero padding is
      // EOF (block-aligned writers), a new magic is a concatenated member,
      // anything else is corruption.
      const Bytef* rest = zs.next_in;
      if (zs.avail_in < 2 || !(rest[0] == 0x1f && rest[1] == 0x8b)) {
        bool all_zero = true;
        for (uInt i = 0; i < zs.avail_in; ++i)
          if (rest[i] != 0) { all_zero = false; break; }
        complete = all_zero;
        if (!all_zero) rc = Z_DATA_ERROR;
        break;
      }
      if (inflateReset(&zs) != Z_OK) {      // next concatenated member
        rc = Z_DATA_ERROR;
        break;
      }
      rc = Z_OK;
    } else if (zs.avail_in == 0) {
      break;  // input exhausted mid-member: truncated
    }
  }
  inflateEnd(&zs);
  return complete;
}

// ------------------------------------------------------------------ parsing

// Slow/general cell parse via from_chars (handles exponents, inf/nan,
// long-digit strings).  parse_cell below fast-paths the dominant shape of
// normalized tabular data — [-]digits[.digits] with few significant digits —
// at ~3x the speed.  BOTH paths parse to a correctly-rounded double first and
// narrow to float, exactly like the numpy/pandas fallback tier (float64
// strtod narrowed to float32) — one rounding rule everywhere keeps the
// tested bit-parity between the native and Python readers even on decimal
// strings that land on float halfway points.
inline float parse_cell_slow(const char* begin, const char* end) {
  if (begin < end && *begin == '+') ++begin;  // from_chars rejects leading '+'
  double v;
  auto res = std::from_chars(begin, end, v);
  if (res.ptr != end) return std::numeric_limits<float>::quiet_NaN();
  if (res.ec == std::errc::result_out_of_range) {
    // float() semantics: overflow -> +/-inf, underflow -> +/-0 (a double
    // strtod then narrowed to float does exactly that)
    std::string cell(begin, end);
    return static_cast<float>(std::strtod(cell.c_str(), nullptr));
  }
  if (res.ec != std::errc())
    return std::numeric_limits<float>::quiet_NaN();
  return static_cast<float>(v);
}

// exact positive powers of ten for the <=15-significant-digit fast path
// (shared by parse_cell and the fused parse_span scanner)
const double kPow10[16] = {1e0, 1e1, 1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                           1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};

inline float parse_cell(const char* begin, const char* end) {
  // trim spaces/CR the way float(str) tolerates them
  while (begin < end && (*begin == ' ' || *begin == '\t')) ++begin;
  while (end > begin &&
         (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r'))
    --end;
  // fast path: [-]digits[.digits], <= 15 significant digits.  mant is exact
  // in double (< 2^53) and 10^frac is exact for frac <= 15 (positive powers
  // of ten are exact through 1e22), so mant / 10^frac incurs exactly one
  // rounding — i.e. the correctly-rounded double, identical to strtod /
  // from_chars<double> — then the same double->float narrow as the slow
  // path and the Python tier.  (A multiply by the inexact 1e-frac would
  // double-round and diverge on float halfway points.)
  const char* p = begin;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool dot = false, fast = (p < end);
  for (; p < end; ++p) {
    const char c = *p;
    if (c >= '0' && c <= '9') {
      if (++digits > 15) { fast = false; break; }
      mant = mant * 10 + static_cast<uint64_t>(c - '0');
      if (dot) ++frac;
    } else if (c == '.' && !dot) {
      dot = true;
    } else {
      fast = false;  // exponent, inf/nan text, junk -> general parser
      break;
    }
  }
  if (fast && digits > 0) {
    const double v = static_cast<double>(mant) / kPow10[frac];
    return static_cast<float>(neg ? -v : v);
  }
  return parse_cell_slow(begin, end);
}

// A line is "blank" (skipped, parity with the Python tier's strip() checks)
// when it contains only spaces/tabs/CR.
inline bool is_blank_line(const char* p, const char* end) {
  for (; p < end; ++p)
    if (*p != ' ' && *p != '\t' && *p != '\r') return false;
  return true;
}

// Reference formulation: memchr-delimited cells, one line at a time.  Kept
// as the path for WHITESPACE delimiters (tab is first-class via Shifu's
// "\\t" dataDelimiter): the fused scanner below skips spaces/tabs as cell
// padding, which would swallow a whitespace delimiter and misalign columns.
int64_t parse_span_bycell(const char* begin, const char* end, char delim,
                          int64_t ncols, float* out) {
  const float nanv = std::numeric_limits<float>::quiet_NaN();
  int64_t row = 0;
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (!is_blank_line(p, line_end)) {
      float* dst = out + row * ncols;
      int64_t col = 0;
      const char* cell = p;
      while (col < ncols) {
        const char* cell_end = static_cast<const char*>(
            std::memchr(cell, delim, static_cast<size_t>(line_end - cell)));
        const char* ce = cell_end ? cell_end : line_end;
        dst[col++] = parse_cell(cell, ce);
        if (!cell_end) break;  // line exhausted
        cell = cell_end + 1;
      }
      for (; col < ncols; ++col) dst[col] = nanv;  // short row -> NaN-pad
      ++row;
    }
    if (!nl) break;
    p = nl + 1;
  }
  return row;
}

// Parse lines in [begin, end) into out rows of `ncols`, return rows written.
// Fused single pass: delimiter/newline detection and the digit fast-path
// share one character walk (a memchr-per-cell formulation re-reads every
// byte twice — measured 18% slower on 31-col %.6g rows).  Junk cells fall
// back to parse_cell on the [cell, delim/newline) span, so per-cell
// semantics (and float bit-parity with the Python tier) are unchanged.
// Whitespace delimiters route to parse_span_bycell: the padding skips here
// would consume them.
int64_t parse_span(const char* begin, const char* end, char delim,
                   int64_t ncols, float* out) {
  if (delim == ' ' || delim == '\t' || delim == '\r')
    return parse_span_bycell(begin, end, delim, ncols, out);
  const float nanv = std::numeric_limits<float>::quiet_NaN();
  int64_t row = 0;
  const char* p = begin;
  while (p < end) {
    // blank-line skip (parity with the Python tier's strip() checks)
    const char* q = p;
    while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q >= end) break;
    if (*q == '\n') {
      p = q + 1;
      continue;
    }

    float* dst = out + row * ncols;
    int64_t col = 0;
    const char* cell = p;
    bool line_done = false;
    while (!line_done && col < ncols) {
      const char* c = cell;
      while (c < end && (*c == ' ' || *c == '\t')) ++c;
      bool neg = false;
      if (c < end && (*c == '-' || *c == '+')) {
        neg = (*c == '-');
        ++c;
      }
      uint64_t mant = 0;
      int digits = 0, frac = 0;
      bool dot = false, fast = true;
      while (c < end) {
        const char ch = *c;
        if (ch >= '0' && ch <= '9') {
          if (++digits > 15) {
            fast = false;
            break;
          }
          mant = mant * 10 + static_cast<uint64_t>(ch - '0');
          if (dot) ++frac;
          ++c;
        } else if (ch == '.' && !dot) {
          dot = true;
          ++c;
        } else {
          break;
        }
      }
      const char* after = c;
      while (after < end &&
             (*after == ' ' || *after == '\t' || *after == '\r'))
        ++after;
      if (fast && digits > 0 &&
          (after >= end || *after == delim || *after == '\n')) {
        // same single-rounding arithmetic as parse_cell's fast path
        const double v = static_cast<double>(mant) / kPow10[frac];
        dst[col++] = static_cast<float>(neg ? -v : v);
        if (after >= end || *after == '\n') {
          line_done = true;
          cell = after;
        } else {
          cell = after + 1;
        }
      } else {
        // junk / exponent / long-digit cell: delimit it, use the general
        // per-cell parser on the exact same span the old code saw
        const char* e2 = cell;
        while (e2 < end && *e2 != delim && *e2 != '\n') ++e2;
        dst[col++] = parse_cell(cell, e2);
        if (e2 >= end || *e2 == '\n') {
          line_done = true;
          cell = e2;
        } else {
          cell = e2 + 1;
        }
      }
    }
    for (; col < ncols; ++col) dst[col] = nanv;  // short row -> NaN-pad
    ++row;
    if (!line_done && cell < end && *cell != '\n') {
      // extra cells beyond ncols are ignored: skip to end of line
      const char* nl = static_cast<const char*>(
          std::memchr(cell, '\n', static_cast<size_t>(end - cell)));
      cell = nl ? nl : end;
    }
    p = (cell < end) ? cell + 1 : end;
  }
  return row;
}

int64_t count_nonempty_lines(const char* begin, const char* end) {
  int64_t n = 0;
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (!is_blank_line(p, line_end)) ++n;
    if (!nl) break;
    p = nl + 1;
  }
  return n;
}

int parse_text(const char* data, size_t len, char delim, int num_threads,
               float** out, int64_t* out_rows, int64_t* out_cols) {
  const char* begin = data;
  const char* end = data + len;
  // determine column count from the first non-empty line
  const char* p = begin;
  const char* first_line_end = nullptr;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* le = nl ? nl : end;
    if (!is_blank_line(p, le)) {
      first_line_end = le;
      break;
    }
    if (!nl) break;
    p = nl + 1;
  }
  if (!first_line_end) {  // empty input
    *out = nullptr;
    *out_rows = 0;
    *out_cols = 0;
    return 0;
  }
  int64_t ncols = 1;
  for (const char* c = p; c < first_line_end; ++c)
    if (*c == delim) ++ncols;

  // choose thread count and chunk boundaries (newline-aligned)
  unsigned hw = std::thread::hardware_concurrency();
  if (num_threads <= 0) num_threads = hw ? static_cast<int>(hw) : 1;
  size_t min_chunk = 4 << 20;  // threads only pay off on multi-MB inputs
  int t = static_cast<int>(std::min<size_t>(
      static_cast<size_t>(num_threads), len / min_chunk + 1));
  std::vector<const char*> bounds;
  bounds.push_back(begin);
  for (int i = 1; i < t; ++i) {
    const char* target = begin + len * static_cast<size_t>(i) / t;
    if (target <= bounds.back()) continue;
    const char* nl = static_cast<const char*>(
        std::memchr(target, '\n', static_cast<size_t>(end - target)));
    const char* b = nl ? nl + 1 : end;
    if (b > bounds.back() && b < end) bounds.push_back(b);
  }
  bounds.push_back(end);
  const int chunks = static_cast<int>(bounds.size()) - 1;

  // pass 1: rows per chunk (parallel), prefix-sum into offsets
  std::vector<int64_t> chunk_rows(chunks, 0);
  {
    std::vector<std::thread> ths;
    for (int i = 0; i < chunks; ++i)
      ths.emplace_back([&, i] {
        chunk_rows[i] = count_nonempty_lines(bounds[i], bounds[i + 1]);
      });
    for (auto& th : ths) th.join();
  }
  int64_t total = 0;
  std::vector<int64_t> offsets(chunks, 0);
  for (int i = 0; i < chunks; ++i) {
    offsets[i] = total;
    total += chunk_rows[i];
  }
  float* buf = static_cast<float*>(
      std::malloc(static_cast<size_t>(total) * ncols * sizeof(float)));
  if (!buf && total > 0) return 2;  // OOM

  // pass 2: parse (parallel, disjoint output ranges)
  std::atomic<int> bad{0};
  {
    std::vector<std::thread> ths;
    for (int i = 0; i < chunks; ++i)
      ths.emplace_back([&, i] {
        int64_t n = parse_span(bounds[i], bounds[i + 1], delim, ncols,
                               buf + offsets[i] * ncols);
        if (n != chunk_rows[i]) bad.fetch_add(1);
      });
    for (auto& th : ths) th.join();
  }
  if (bad.load() != 0) {
    std::free(buf);
    return 3;  // count/parse mismatch (should not happen)
  }
  *out = buf;
  *out_rows = total;
  *out_cols = ncols;
  return 0;
}

}  // namespace

extern "C" {

int shifu_parser_version() { return kVersion; }

void shifu_parser_free(float* p) { std::free(p); }

// Parse an in-memory text buffer. Returns 0 on success; *out is malloc'd
// [rows x cols] row-major float32, freed with shifu_parser_free.
int shifu_parse_buffer(const char* data, int64_t len, char delim,
                       int num_threads, float** out, int64_t* rows,
                       int64_t* cols) {
  if (!data || len < 0 || !out || !rows || !cols) return 1;
  return parse_text(data, static_cast<size_t>(len), delim, num_threads, out,
                    rows, cols);
}

// Read a file (gunzip by magic number), then parse.  Same contract as
// shifu_parse_buffer.
int shifu_parse_file(const char* path, char delim, int num_threads,
                     float** out, int64_t* rows, int64_t* cols) {
  if (!path || !out || !rows || !cols) return 1;
  std::string raw;
  if (!read_whole_file(path, &raw)) return 4;  // unreadable
  if (is_gzip(raw)) {
    std::string text;
    if (!gunzip(raw, &text)) return 5;  // corrupt gzip
    raw.swap(text);
  }
  return parse_text(raw.data(), raw.size(), delim, num_threads, out, rows,
                    cols);
}

// Count data lines in a (possibly gzipped) file; -1 on error.  Successor of
// HdfsUtils.getFileLineCount (yarn/util/HdfsUtils.java:143-175) — but counts
// non-blank lines, matching what the parsers above will actually yield.
// Streams in fixed-size chunks (constant memory regardless of file size).
int64_t shifu_count_rows(const char* path) {
  if (!path) return -1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  // Carry-over state for line counting across chunk boundaries.
  int64_t n = 0;
  bool line_has_content = false;
  auto feed = [&](const char* p, size_t len) {
    for (size_t i = 0; i < len; ++i) {
      const char c = p[i];
      if (c == '\n') {
        if (line_has_content) ++n;
        line_has_content = false;
      } else if (c != ' ' && c != '\t' && c != '\r') {
        line_has_content = true;
      }
    }
  };

  std::vector<char> in(1 << 20);
  size_t got = std::fread(in.data(), 1, in.size(), f);
  const bool gz = got >= 2 && static_cast<unsigned char>(in[0]) == 0x1f &&
                  static_cast<unsigned char>(in[1]) == 0x8b;
  bool ok = true;
  if (!gz) {
    while (got > 0) {
      feed(in.data(), got);
      got = std::fread(in.data(), 1, in.size(), f);
    }
  } else {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) {
      std::fclose(f);
      return -1;
    }
    std::vector<char> outbuf(1 << 20);
    bool complete = false;
    int rc = Z_OK;
    while (ok && got > 0) {
      zs.next_in = reinterpret_cast<Bytef*>(in.data());
      zs.avail_in = static_cast<uInt>(got);
      while (zs.avail_in > 0) {
        zs.next_out = reinterpret_cast<Bytef*>(outbuf.data());
        zs.avail_out = static_cast<uInt>(outbuf.size());
        rc = inflate(&zs, Z_NO_FLUSH);
        if (rc != Z_OK && rc != Z_STREAM_END) {
          ok = false;
          break;
        }
        feed(outbuf.data(), outbuf.size() - zs.avail_out);
        if (rc == Z_STREAM_END) {
          // refill so member-boundary logic sees the next bytes
          if (zs.avail_in < 2) {
            std::memmove(in.data(), zs.next_in, zs.avail_in);
            size_t more = std::fread(in.data() + zs.avail_in, 1,
                                     in.size() - zs.avail_in, f);
            zs.next_in = reinterpret_cast<Bytef*>(in.data());
            zs.avail_in += static_cast<uInt>(more);
          }
          if (zs.avail_in == 0) {
            complete = true;
            break;
          }
          const Bytef* rest = zs.next_in;
          if (zs.avail_in < 2 || !(rest[0] == 0x1f && rest[1] == 0x8b)) {
            // all-zero padding (incl. any remaining file bytes) is EOF
            bool all_zero = true;
            for (uInt i = 0; all_zero && i < zs.avail_in; ++i)
              if (rest[i] != 0) all_zero = false;
            while (all_zero) {
              size_t more = std::fread(in.data(), 1, in.size(), f);
              if (more == 0) break;
              for (size_t i = 0; all_zero && i < more; ++i)
                if (in[i] != 0) all_zero = false;
            }
            complete = all_zero;
            ok = all_zero;
            zs.avail_in = 0;
            break;
          }
          if (inflateReset(&zs) != Z_OK) {
            ok = false;
            break;
          }
        }
      }
      if (complete || !ok) break;
      got = std::fread(in.data(), 1, in.size(), f);
      if (got == 0 && rc != Z_STREAM_END) ok = false;  // truncated mid-member
    }
    if (!complete && rc != Z_STREAM_END) ok = false;
    inflateEnd(&zs);
  }
  std::fclose(f);
  if (!ok) return -1;
  if (line_has_content) ++n;  // final line without trailing newline
  return n;
}

}  // extern "C"

#ifdef SHIFU_SELFTEST_MAIN
// Sanitizer self-test entry: built as an executable with
// -fsanitize=address,undefined by tests/test_torch_sanitizers.py (through
// runtime/nativelib.build_selftest) and run directly
// — memory/UB coverage the reference never had (SURVEY.md §5.2: none).
// Exercises the multithreaded chunked parse, the ragged fallback, blank
// lines, bad cells, and the free path.
#include <cstdio>
int main(int argc, char** argv) {
  float* out = nullptr;
  int64_t rows = 0, cols = 0;
  const char text[] = "1|2|3\n4|bad|6\n\n  \n7|8|9\n-1.5e3|.5|nan";
  if (shifu_parse_buffer(text, sizeof(text) - 1, '|', 3, &out, &rows, &cols)
          != 0 || rows != 4 || cols != 3) {
    std::fprintf(stderr, "selftest: buffer parse failed (%lld x %lld)\n",
                 (long long)rows, (long long)cols);
    return 1;
  }
  shifu_parser_free(out);
  out = nullptr;
  // large synthetic buffer: parse_text only splits into multiple chunks
  // above min_chunk (4 MiB) per thread, so build >8 MiB to genuinely cover
  // the chunk-boundary alignment / offset prefix-sum / disjoint-write paths
  const int64_t kBigRows = 600000;  // ~17 B/line -> ~10 MiB -> 3 chunks
  std::string big;
  big.reserve((size_t)kBigRows * 20);
  char linebuf[64];
  for (int64_t i = 0; i < kBigRows; ++i) {
    std::snprintf(linebuf, sizeof(linebuf), "%lld|-1|3.5|4e-2\n",
                  (long long)(i % 97));
    big += linebuf;
  }
  if (shifu_parse_buffer(big.data(), (int64_t)big.size(), '|', 4, &out, &rows,
                         &cols) != 0 || rows != kBigRows || cols != 4) {
    std::fprintf(stderr, "selftest: big parse failed\n");
    return 2;
  }
  // stitching check: a row deep in the last chunk kept its own values
  const int64_t probe = kBigRows - 7;
  if (out[probe * 4 + 0] != (float)(probe % 97) || out[probe * 4 + 1] != -1.0f
      || out[probe * 4 + 3] != 4e-2f) {
    std::fprintf(stderr, "selftest: chunk stitching mismatch\n");
    return 5;
  }
  shifu_parser_free(out);
  if (argc > 1) {  // optional: a real (possibly gzipped) file
    out = nullptr;
    if (shifu_parse_file(argv[1], '|', 2, &out, &rows, &cols) != 0) {
      std::fprintf(stderr, "selftest: file parse failed\n");
      return 3;
    }
    shifu_parser_free(out);
    if (shifu_count_rows(argv[1]) != rows) {
      std::fprintf(stderr, "selftest: count != parsed rows\n");
      return 4;
    }
  }
  std::puts("parser selftest ok");
  return 0;
}
#endif  // SHIFU_SELFTEST_MAIN
