// Quote-aware CSV row scanner — the native half of agent_tpu_torch.data.csv_index
// (a copy of agent_tpu/data/native/csv_scan.cpp; host code, not a device kernel).
//
// One streaming pass over the file: record the byte offset after every
// newline that falls OUTSIDE RFC-4180 double quotes (a doubled "" toggles the
// state twice, net no-op, so no special case is needed). This is the hot loop
// that lets shard reads become seek+read; the Python fallback implements the
// identical semantics (csv_index._scan_row_offsets_py); both are held to the
// reference's scanners in tests/test_torch_csv_index.py.
//
// Built lazily by agent_tpu_torch/data/native/build.py:
//   g++ -O3 -shared -fPIC csv_scan.cpp -o csv_scan.so
// and called through ctypes — no pybind11 dependency.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Scans `path`; on success mallocs an int64 offsets array (first element 0 =
// start of row 0), stores it in *out, and returns the element count. Returns
// -1 when the file cannot be opened. Caller must csv_scan_free(*out).
int64_t csv_scan_offsets(const char *path, int64_t **out);
void csv_scan_free(int64_t *p);

}  // extern "C"

namespace {
constexpr size_t kBufSize = 4 << 20;  // 4 MiB read chunks

// The loop is memchr-driven rather than byte-at-a-time: glibc's memchr is
// vectorized (AVX2 where the CPU has it), so hopping newline→newline scans at
// memory bandwidth instead of ~1 byte/cycle. Quote handling keeps the same
// RFC-4180 semantics as the scalar version (every '"' toggles state; a
// doubled "" toggles twice, net no-op): inside quotes we hop '"'→'"'; outside
// we cache the position of the next '"' in the chunk so quote-free data — the
// common case — costs one extra memchr per 4 MiB, not one per row.
}  // namespace

int64_t csv_scan_offsets(const char *path, int64_t **out) {
  FILE *f = std::fopen(path, "rb");
  if (f == nullptr) return -1;

  size_t cap = 1 << 16;
  int64_t *offs = static_cast<int64_t *>(std::malloc(cap * sizeof(int64_t)));
  unsigned char *buf = static_cast<unsigned char *>(std::malloc(kBufSize));
  if (offs == nullptr || buf == nullptr) {
    std::free(offs);
    std::free(buf);
    std::fclose(f);
    return -1;
  }

  size_t n = 0;
  offs[n++] = 0;
  int64_t pos = 0;
  bool in_quote = false;

  size_t got;
  while ((got = std::fread(buf, 1, kBufSize, f)) > 0) {
    size_t i = 0;
    // Positions of the next '"' / '\n' at or after i, or `got` if none remain
    // in this chunk. Each is valid only while it is >= i and refreshed lazily
    // once i passes it, so every byte of the chunk is memchr-scanned at most
    // once per character class — quote-dense rows stay linear.
    size_t next_q = 0, next_nl = 0;
    bool next_q_valid = false, next_nl_valid = false;
    while (i < got) {
      if (in_quote) {
        const void *q = std::memchr(buf + i, '"', got - i);
        if (q == nullptr) {
          i = got;  // rest of chunk is inside the quoted field
          break;
        }
        i = static_cast<size_t>(static_cast<const unsigned char *>(q) - buf) + 1;
        in_quote = false;
        continue;  // i moved past any cached quote; the < i check refreshes

      }
      if (!next_q_valid || next_q < i) {
        const void *q = std::memchr(buf + i, '"', got - i);
        next_q = q == nullptr
                     ? got
                     : static_cast<size_t>(
                           static_cast<const unsigned char *>(q) - buf);
        next_q_valid = true;
      }
      if (!next_nl_valid || next_nl < i) {
        const void *nl = std::memchr(buf + i, '\n', got - i);
        next_nl = nl == nullptr
                      ? got
                      : static_cast<size_t>(
                            static_cast<const unsigned char *>(nl) - buf);
        next_nl_valid = true;
      }
      const size_t nl_pos = next_nl;
      if (next_q < nl_pos) {
        i = next_q + 1;  // now i > next_q, so the staleness check refreshes
        in_quote = true;
      } else if (nl_pos < got) {
        if (n == cap) {
          cap *= 2;
          int64_t *grown =
              static_cast<int64_t *>(std::realloc(offs, cap * sizeof(int64_t)));
          if (grown == nullptr) {
            std::free(offs);
            std::free(buf);
            std::fclose(f);
            return -1;
          }
          offs = grown;
        }
        offs[n++] = pos + static_cast<int64_t>(nl_pos) + 1;
        i = nl_pos + 1;
      } else {
        i = got;  // no newline and no quote left in this chunk
      }
    }
    pos += static_cast<int64_t>(got);
  }

  std::fclose(f);
  std::free(buf);
  // A file ending in '\n' leaves a trailing offset at EOF — not a row start.
  if (n > 1 && offs[n - 1] >= pos) --n;
  *out = offs;
  return static_cast<int64_t>(n);
}

void csv_scan_free(int64_t *p) { std::free(p); }
