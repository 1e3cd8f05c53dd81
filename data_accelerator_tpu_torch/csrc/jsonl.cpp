// JSON-lines text straight from a landed table's columns: the blob
// sink's encode of a flat dataset (runtime/sinks.py FileSink.write_landed),
// byte for byte what
//     "\n".join(json.dumps(row, default=str) for row in rows) + "\n"
// gives for the rows runtime/materialize.py builds from the same columns.
//
// Each row is a sequence of (prefix, value) pairs and "}\n": the caller
// renders the prefixes ('{"key": ' for the first column, ', "key": ' for
// the others) with json.dumps, so keys need no escaping here. Values:
//   INT     int64 plus a per-column offset (the batch base for timestamps),
//           summed in 128 bits as Python's unbounded ints would;
//   BOOL    uint8, "true" or "false";
//   DOUBLE  float64 laid out as Python's float repr (shortest round-trip
//           digits, fixed notation for exponents -4..15 with ".0" on
//           integral values, scientific beyond), NaN / Infinity /
//           -Infinity as json.dumps writes them;
//   STRING  int64 index into pieces the caller escaped with json.dumps
//           ("null" for a null id), spliced in as they are.
//
// Plain C interface for ctypes (native/jsonl.py). No Python API is
// touched, so the ctypes call runs without the interpreter lock.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

enum Kind : int32_t { K_INT = 0, K_BOOL = 1, K_DOUBLE = 2, K_STRING = 3 };

inline char* put(char* p, const char* s, int64_t n) {
  std::memcpy(p, s, static_cast<size_t>(n));
  return p + n;
}

inline char* put_int128(char* p, __int128 v) {
  if (v >= INT64_MIN && v <= INT64_MAX) {
    return std::to_chars(p, p + 24, static_cast<int64_t>(v)).ptr;
  }
  unsigned __int128 u;
  if (v < 0) {
    *p++ = '-';
    u = static_cast<unsigned __int128>(-(v + 1)) + 1;
  } else {
    u = static_cast<unsigned __int128>(v);
  }
  char rev[40];
  int n = 0;
  while (u != 0) {
    rev[n++] = static_cast<char>('0' + static_cast<int>(u % 10));
    u /= 10;
  }
  while (n > 0) *p++ = rev[--n];
  return p;
}

// Python's float.__repr__ (format code 'r': Py_DTSF_ADD_DOT_0), and
// json.dumps's words for the non-finite values
char* put_double(char* p, double x) {
  if (std::isnan(x)) return put(p, "NaN", 3);
  if (std::isinf(x)) return x < 0 ? put(p, "-Infinity", 9) : put(p, "Infinity", 8);
  char buf[40];
  // the shortest digits that round-trip, as d[.ddd]e(+|-)XX
  const char* end = std::to_chars(buf, buf + sizeof buf, x,
                                  std::chars_format::scientific).ptr;
  const char* s = buf;
  if (*s == '-') {
    *p++ = '-';
    ++s;
  }
  char digits[24];
  int nd = 0;
  while (s < end && *s != 'e') {
    if (*s != '.') digits[nd++] = *s;
    ++s;
  }
  ++s;  // 'e'
  bool eneg = *s == '-';
  if (*s == '-' || *s == '+') ++s;
  int e = 0;
  while (s < end) e = e * 10 + (*s++ - '0');
  if (eneg) e = -e;
  if (e < -4 || e >= 16) {
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      p = put(p, digits + 1, nd - 1);
    }
    *p++ = 'e';
    *p++ = e < 0 ? '-' : '+';
    int ae = e < 0 ? -e : e;
    if (ae < 10) *p++ = '0';
    return std::to_chars(p, p + 4, ae).ptr;
  }
  int decpt = e + 1;  // digits before the point
  if (decpt <= 0) {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -decpt; ++i) *p++ = '0';
    return put(p, digits, nd);
  }
  if (decpt >= nd) {
    p = put(p, digits, nd);
    for (int i = nd; i < decpt; ++i) *p++ = '0';
    return put(p, ".0", 2);
  }
  p = put(p, digits, decpt);
  *p++ = '.';
  return put(p, digits + decpt, nd - decpt);
}

}  // namespace

extern "C" {

// Renders n_rows rows of n_cols columns into out (capacity cap bytes);
// returns the bytes written, or -1 if a row would pass cap.
int64_t dx_render_jsonl(int64_t n_rows, int32_t n_cols, const int32_t* kinds,
                        const void* const* data, const int64_t* offsets,
                        const char* const* pieces,
                        const int64_t* const* piece_offsets,
                        const char* const* prefixes,
                        const int64_t* prefix_lens, int64_t row_bound,
                        char* out, int64_t cap) {
  char* p = out;
  char* const limit = out + cap;
  for (int64_t i = 0; i < n_rows; ++i) {
    if (limit - p < row_bound) return -1;
    for (int32_t c = 0; c < n_cols; ++c) {
      p = put(p, prefixes[c], prefix_lens[c]);
      switch (kinds[c]) {
        case K_INT:
          p = put_int128(p, static_cast<__int128>(
                                static_cast<const int64_t*>(data[c])[i]) +
                                offsets[c]);
          break;
        case K_BOOL:
          p = static_cast<const uint8_t*>(data[c])[i] ? put(p, "true", 4)
                                                       : put(p, "false", 5);
          break;
        case K_DOUBLE:
          p = put_double(p, static_cast<const double*>(data[c])[i]);
          break;
        default: {
          int64_t k = static_cast<const int64_t*>(data[c])[i];
          const int64_t* off = piece_offsets[c];
          p = put(p, pieces[c] + off[k], off[k + 1] - off[k]);
        }
      }
    }
    p = put(p, "}\n", 2);
  }
  return p - out;
}

}  // extern "C"
