// Fast SVM-light data-file parser.
//
// Native counterpart of the reference CLI's two-pass C++ parser
// (CClctrl::readSvmlDataFile, reference CClctrl.cpp:55-171): `label idx:val`
// per line, 1-based feature indices, `#` comments, CR tolerated.  Two passes
// over an mmapped buffer: pass 1 counts rows and the max feature index, pass 2
// fills caller-allocated dense arrays.  A copy of gpc_tpu's reader; read by
// gpc_tpu_torch.io.svml through native/svml_native.py.
//
// Built by native/build.py: g++ -O3 -shared -fPIC into gpc_tpu_torch/_build/.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Buffer {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool heap = false;   // page-multiple files are heap-copied (NUL guard)
  bool ok() const { return data != nullptr; }
};

Buffer map_file(const char* path) {
  Buffer b;
  b.fd = open(path, O_RDONLY);
  if (b.fd < 0) return b;
  struct stat sb;
  if (fstat(b.fd, &sb) != 0 || sb.st_size == 0) {
    close(b.fd);
    b.fd = -1;
    return b;
  }
  // strtod/strtol in the scan can read one byte past the last token when
  // the file ends mid-number.  For sizes that are NOT a page multiple the
  // mmap page slack is zero-filled so the scan stops at '\0'; for EXACT
  // page multiples that byte is an unmapped page (SIGSEGV) — fall back to
  // a heap copy with an explicit trailing NUL in that case.
  const long pagesz = sysconf(_SC_PAGESIZE);
  if (pagesz > 0 && sb.st_size % pagesz == 0) {
    char* heap = static_cast<char*>(malloc(sb.st_size + 1));
    if (!heap) { close(b.fd); b.fd = -1; return b; }
    ssize_t got = 0;
    while (got < sb.st_size) {
      ssize_t r = pread(b.fd, heap + got, sb.st_size - got, got);
      if (r <= 0) { free(heap); close(b.fd); b.fd = -1; return b; }
      got += r;
    }
    heap[sb.st_size] = '\0';
    b.data = heap;
    b.size = sb.st_size;
    b.heap = true;
    return b;
  }
  void* p = mmap(nullptr, sb.st_size, PROT_READ, MAP_PRIVATE, b.fd, 0);
  if (p == MAP_FAILED) {
    close(b.fd);
    b.fd = -1;
    return b;
  }
  b.data = static_cast<const char*>(p);
  b.size = sb.st_size;
  return b;
}

void unmap(Buffer& b) {
  if (b.data) {
    if (b.heap) free(const_cast<char*>(b.data));
    else munmap(const_cast<char*>(b.data), b.size);
  }
  if (b.fd >= 0) close(b.fd);
}

inline const char* line_end(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  return nl ? nl : end;
}

// Effective content end of a line: strip comment and CR.
inline const char* content_end(const char* p, const char* eol) {
  const char* hash = static_cast<const char*>(memchr(p, '#', eol - p));
  const char* e = hash ? hash : eol;
  while (e > p && (e[-1] == '\r' || e[-1] == ' ' || e[-1] == '\t')) --e;
  return e;
}

inline bool blank(const char* p, const char* e) {
  for (; p < e; ++p)
    if (*p != ' ' && *p != '\t') return false;
  return true;
}

}  // namespace

extern "C" {

// Pass 1: returns 0 on success; fills n_rows and max_index.
int svml_scan(const char* path, long* n_rows, long* max_index) {
  Buffer b = map_file(path);
  if (!b.ok()) return -1;
  const char* p = b.data;
  const char* end = b.data + b.size;
  long rows = 0, maxidx = 0;
  while (p < end) {
    const char* eol = line_end(p, end);
    const char* e = content_end(p, eol);
    if (!blank(p, e)) {
      ++rows;
      // scan for idx: tokens
      const char* q = p;
      while (q < e) {
        const char* colon = static_cast<const char*>(memchr(q, ':', e - q));
        if (!colon) break;
        // walk back from colon to token start
        const char* ts = colon;
        while (ts > p && ts[-1] != ' ' && ts[-1] != '\t') --ts;
        long idx = strtol(ts, nullptr, 10);
        if (idx > maxidx) maxidx = idx;
        q = colon + 1;
      }
    }
    p = eol + 1;
  }
  unmap(b);
  *n_rows = rows;
  *max_index = maxidx;
  return 0;
}

// Pass 2: fills X (n_rows × max_index, row-major, pre-zeroed by caller) and
// y (n_rows).  Returns number of rows parsed or -1 on error.
long svml_fill(const char* path, double* X, double* y, long n_rows,
               long max_index) {
  Buffer b = map_file(path);
  if (!b.ok()) return -1;
  const char* p = b.data;
  const char* end = b.data + b.size;
  long row = 0;
  while (p < end && row < n_rows) {
    const char* eol = line_end(p, end);
    const char* e = content_end(p, eol);
    if (!blank(p, e)) {
      char* q;
      y[row] = strtod(p, &q);
      while (q < e) {
        while (q < e && (*q == ' ' || *q == '\t')) ++q;
        if (q >= e) break;
        char* after;
        long idx = strtol(q, &after, 10);
        if (after >= e || *after != ':') break;
        double val = strtod(after + 1, &after);
        if (idx >= 1 && idx <= max_index) X[row * max_index + (idx - 1)] = val;
        q = after;
      }
      ++row;
    }
    p = eol + 1;
  }
  unmap(b);
  return row;
}

}  // extern "C"
