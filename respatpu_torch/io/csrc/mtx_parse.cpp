// Matrix Market header and coordinate-entry parsers for respatpu_torch's
// host layer (C ABI, loaded with ctypes by respatpu_torch/io/native.py).
//
// The port's own copy of the Matrix Market part of
// respatpu/io/_native/host_ops.cpp (mtx_read_header, mtx_parse_entries), so
// that the port builds and loads nothing from the JAX package's tree. It
// replaces mm_io.cpp:54-430 and loadMatrixMarket.cpp:47-253 of the
// reference. Host code only: nothing on the device depends on it.
//
// Built at first use with the host C++ compiler:
//   c++ -O2 -std=c++17 -shared -fPIC -pthread -o librespa_mtx.so mtx_parse.cpp

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct MtxInfo {
  int64_t nrows, ncols, nnz;
  int32_t field;     // 0 real, 1 integer, 2 pattern, 3 complex
  int32_t symmetry;  // 0 general, 1 symmetric, 2 skew, 3 hermitian
  int32_t fmt;       // 0 coordinate, 1 array
  int64_t data_offset;  // byte offset where entries begin
};

static int parse_banner(const char* line, MtxInfo* info) {
  char obj[64], fmt[64], field[64], sym[64];
  if (sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s", obj, fmt, field, sym) != 4)
    return -1;
  for (char* p = fmt; *p; ++p) *p = (char)tolower(*p);
  for (char* p = field; *p; ++p) *p = (char)tolower(*p);
  for (char* p = sym; *p; ++p) *p = (char)tolower(*p);
  if (strcmp(fmt, "coordinate") == 0) info->fmt = 0;
  else if (strcmp(fmt, "array") == 0) info->fmt = 1;
  else return -2;
  if (strcmp(field, "real") == 0) info->field = 0;
  else if (strcmp(field, "integer") == 0) info->field = 1;
  else if (strcmp(field, "pattern") == 0) info->field = 2;
  else if (strcmp(field, "complex") == 0) info->field = 3;
  else return -3;
  if (strcmp(sym, "general") == 0) info->symmetry = 0;
  else if (strcmp(sym, "symmetric") == 0) info->symmetry = 1;
  else if (strcmp(sym, "skew-symmetric") == 0) info->symmetry = 2;
  else if (strcmp(sym, "hermitian") == 0) info->symmetry = 3;
  else return -4;
  return 0;
}

// Read header: fills MtxInfo. Returns 0 on success.
int mtx_read_header(const char* path, MtxInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  char line[4096];
  if (!fgets(line, sizeof line, f)) { fclose(f); return -11; }
  int rc = parse_banner(line, info);
  if (rc) { fclose(f); return rc; }
  // skip comments/blank
  while (fgets(line, sizeof line, f)) {
    const char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '%' || *p == '\n' || *p == '\r') continue;
    break;
  }
  if (info->fmt == 0) {
    long long m, n, nz;
    if (sscanf(line, "%lld %lld %lld", &m, &n, &nz) != 3) { fclose(f); return -12; }
    info->nrows = m; info->ncols = n; info->nnz = nz;
  } else {
    long long m, n;
    if (sscanf(line, "%lld %lld", &m, &n) != 2) { fclose(f); return -13; }
    info->nrows = m; info->ncols = n; info->nnz = m * n;
  }
  info->data_offset = ftell(f);
  fclose(f);
  return 0;
}

// Parse coordinate entries in parallel into row/col/val (caller-allocated,
// length = info->nnz). Values for pattern files are set to 1.0; for complex
// files the real part is taken. Indices returned as stored (typically 1-based).
// Returns number of entries parsed, or negative error.
int64_t mtx_parse_entries(const char* path, int64_t data_offset, int64_t nnz,
                          int32_t field, int32_t* row, int32_t* col, double* val,
                          int32_t nthreads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  int64_t fsize = ftell(f);
  int64_t dsize = fsize - data_offset;
  if (dsize <= 0) { fclose(f); return nnz == 0 ? 0 : -14; }
  std::vector<char> buf((size_t)dsize + 1);
  fseek(f, data_offset, SEEK_SET);
  size_t got = fread(buf.data(), 1, (size_t)dsize, f);
  fclose(f);
  buf[got] = '\0';

  if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nnz < 100000) nthreads = 1;

  // chunk boundaries snapped to newline
  std::vector<int64_t> starts(nthreads + 1);
  starts[0] = 0;
  for (int t = 1; t < nthreads; ++t) {
    int64_t s = (int64_t)got * t / nthreads;
    while (s < (int64_t)got && buf[(size_t)s] != '\n') ++s;
    starts[t] = s < (int64_t)got ? s + 1 : (int64_t)got;
  }
  starts[nthreads] = (int64_t)got;

  // pass 1: count entry lines per chunk
  std::vector<int64_t> counts(nthreads, 0);
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([&, t]() {
        int64_t c = 0;
        const char* p = buf.data() + starts[t];
        const char* end = buf.data() + starts[t + 1];
        while (p < end) {
          while (p < end && (*p == ' ' || *p == '\t')) ++p;
          bool entry = p < end && (isdigit((unsigned char)*p) || *p == '-' || *p == '+');
          if (entry) ++c;
          while (p < end && *p != '\n') ++p;
          if (p < end) ++p;
        }
        counts[t] = c;
      });
    for (auto& th : threads) th.join();
  }
  std::vector<int64_t> offs(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t) offs[t + 1] = offs[t] + counts[t];
  if (offs[nthreads] < nnz) return -15;  // truncated file

  // pass 2: parse
  std::atomic<int> err{0};
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([&, t]() {
        int64_t k = offs[t];
        char* p = buf.data() + starts[t];
        char* end = buf.data() + starts[t + 1];
        while (p < end && k < nnz + offs[0] + offs[nthreads]) {
          while (p < end && (*p == ' ' || *p == '\t')) ++p;
          if (p >= end) break;
          if (!(isdigit((unsigned char)*p) || *p == '-' || *p == '+')) {
            while (p < end && *p != '\n') ++p;
            if (p < end) ++p;
            continue;
          }
          char* q;
          long long i = strtoll(p, &q, 10);
          if (q == p) { err = 1; break; }
          p = q;
          long long j = strtoll(p, &q, 10);
          if (q == p) { err = 2; break; }
          p = q;
          double v = 1.0;
          if (field == 0 || field == 1 || field == 3) {
            v = strtod(p, &q);
            p = q;
            if (field == 3) { strtod(p, &q); p = q; }  // skip imaginary part
          }
          if (k < nnz) {
            row[k] = (int32_t)i;
            col[k] = (int32_t)j;
            val[k] = v;
          }
          ++k;
          while (p < end && *p != '\n') ++p;
          if (p < end) ++p;
        }
      });
    for (auto& th : threads) th.join();
  }
  if (err.load()) return -16;
  return offs[nthreads] < nnz ? offs[nthreads] : nnz;
}

}  // extern "C"
