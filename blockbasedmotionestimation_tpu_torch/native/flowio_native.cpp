// Native I/O runtime: fast Middlebury .flo + PGM codecs, batch loading, EPE.
//
// The reference ships a C++ image library (middlebury/flow-code/imageLib/,
// ~2.3 kLoC: CImage containers, PNG/PGM/Targa I/O) and C++ .flo codecs
// (flowIO.cpp:46-133, rw_flow.cpp:50-200).  This is the port's native
// equivalent: a small C++17 shared library doing the byte-level work
// (validation, decode, encode, threaded batch reads for the data-loading
// path) behind a ctypes boundary; PyTorch never touches it on the compute
// path.
//
// Error contract: every function returns 0 on success or a negative errno-ish
// code; no exceptions cross the C ABI.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kTagFloat = 202021.25f;  // "PIEH" (rw_flow.cpp:25-26)
constexpr int kMaxDim = 99999;           // sanity bound (rw_flow.cpp:88-92)
constexpr float kUnknownThresh = 1e9f;   // UNKNOWN_FLOW_THRESH (rw_flow.cpp:30)

enum ErrorCode : int {
  kOk = 0,
  kOpenFailed = -1,
  kBadMagic = -2,
  kBadDims = -3,
  kShortRead = -4,
  kLongFile = -5,
  kWriteFailed = -6,
  kBadArg = -7,
};

struct File {
  std::FILE* f;
  explicit File(const char* path, const char* mode) : f(std::fopen(path, mode)) {}
  ~File() { if (f) std::fclose(f); }
};

int read_flo_header(std::FILE* f, int* w, int* h) {
  float tag;
  std::int32_t ww, hh;
  if (std::fread(&tag, 4, 1, f) != 1) return kShortRead;
  if (tag != kTagFloat) return kBadMagic;
  if (std::fread(&ww, 4, 1, f) != 1 || std::fread(&hh, 4, 1, f) != 1)
    return kShortRead;
  if (ww < 1 || ww > kMaxDim || hh < 1 || hh > kMaxDim) return kBadDims;
  *w = ww;
  *h = hh;
  return kOk;
}

}  // namespace

extern "C" {

// ---- .flo ------------------------------------------------------------------

int bbme_flo_dims(const char* path, int* w, int* h) {
  File fp(path, "rb");
  if (!fp.f) return kOpenFailed;
  return read_flo_header(fp.f, w, h);
}

// out must hold w*h*2 floats (interleaved u,v row-major, rw_flow.cpp:104-125).
int bbme_flo_read(const char* path, float* out, int w, int h) {
  File fp(path, "rb");
  if (!fp.f) return kOpenFailed;
  int fw, fh;
  if (int rc = read_flo_header(fp.f, &fw, &fh)) return rc;
  if (fw != w || fh != h) return kBadDims;
  const size_t n = static_cast<size_t>(w) * h * 2;
  if (std::fread(out, 4, n, fp.f) != n) return kShortRead;
  // exact-length check (rw_flow.cpp:127-132)
  char extra;
  if (std::fread(&extra, 1, 1, fp.f) == 1) return kLongFile;
  return kOk;
}

int bbme_flo_write(const char* path, const float* data, int w, int h) {
  if (w < 1 || w > kMaxDim || h < 1 || h > kMaxDim) return kBadArg;
  File fp(path, "wb");
  if (!fp.f) return kOpenFailed;
  std::int32_t ww = w, hh = h;
  if (std::fwrite(&kTagFloat, 4, 1, fp.f) != 1 ||
      std::fwrite(&ww, 4, 1, fp.f) != 1 || std::fwrite(&hh, 4, 1, fp.f) != 1)
    return kWriteFailed;
  const size_t n = static_cast<size_t>(w) * h * 2;
  if (std::fwrite(data, 4, n, fp.f) != n) return kWriteFailed;
  return kOk;
}

// Threaded batch read of same-sized .flo files into one contiguous buffer
// (count, h, w, 2); rc_out[i] receives the per-file code.
int bbme_flo_read_batch(const char** paths, int count, float* out, int w,
                        int h, int nthreads, int* rc_out) {
  if (count < 0 || nthreads < 1) return kBadArg;
  const size_t stride = static_cast<size_t>(w) * h * 2;
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  const int t = std::min(nthreads, std::max(count, 1));
  std::vector<int> codes(count, kOk);
  for (int ti = 0; ti < t; ++ti) {
    pool.emplace_back([&, ti]() {
      for (int i = ti; i < count; i += t)
        codes[i] = bbme_flo_read(paths[i], out + stride * i, w, h);
    });
  }
  for (auto& th : pool) th.join();
  int rc = kOk;
  for (int i = 0; i < count; ++i) {
    if (rc_out) rc_out[i] = codes[i];
    if (codes[i] != kOk) rc = codes[i];
  }
  return rc;
}

// ---- PGM (P5/P2 grayscale, the imageLib ReadImage analogue) -----------------

namespace {
int pgm_header(std::FILE* f, int* w, int* h, int* maxval, int* binary) {
  char magic[3] = {0, 0, 0};
  if (std::fscanf(f, "%2s", magic) != 1) return kShortRead;
  if (magic[0] != 'P' || (magic[1] != '5' && magic[1] != '2')) return kBadMagic;
  *binary = magic[1] == '5';
  int vals[3], got = 0, c;
  while (got < 3) {
    c = std::fgetc(f);
    if (c == '#') {  // comment line
      while ((c = std::fgetc(f)) != '\n' && c != EOF) {}
    } else if (c == EOF) {
      return kShortRead;
    } else if (c >= '0' && c <= '9') {
      std::ungetc(c, f);
      if (std::fscanf(f, "%d", &vals[got]) != 1) return kShortRead;
      ++got;
    }
  }
  std::fgetc(f);  // single whitespace after maxval
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  if (*w < 1 || *w > kMaxDim || *h < 1 || *h > kMaxDim || *maxval > 255)
    return kBadDims;
  return kOk;
}
}  // namespace

int bbme_pgm_dims(const char* path, int* w, int* h) {
  File fp(path, "rb");
  if (!fp.f) return kOpenFailed;
  int maxval, binary;
  return pgm_header(fp.f, w, h, &maxval, &binary);
}

int bbme_pgm_read(const char* path, unsigned char* out, int w, int h) {
  File fp(path, "rb");
  if (!fp.f) return kOpenFailed;
  int fw, fh, maxval, binary;
  if (int rc = pgm_header(fp.f, &fw, &fh, &maxval, &binary)) return rc;
  if (fw != w || fh != h) return kBadDims;
  const size_t n = static_cast<size_t>(w) * h;
  if (binary) {
    if (std::fread(out, 1, n, fp.f) != n) return kShortRead;
  } else {
    for (size_t i = 0; i < n; ++i) {
      int v;
      if (std::fscanf(fp.f, "%d", &v) != 1) return kShortRead;
      out[i] = static_cast<unsigned char>(v);
    }
  }
  return kOk;
}

int bbme_pgm_write(const char* path, const unsigned char* data, int w, int h) {
  File fp(path, "wb");
  if (!fp.f) return kOpenFailed;
  std::fprintf(fp.f, "P5\n%d %d\n255\n", w, h);
  const size_t n = static_cast<size_t>(w) * h;
  if (std::fwrite(data, 1, n, fp.f) != n) return kWriteFailed;
  return kOk;
}

// ---- metrics ----------------------------------------------------------------

// Average endpoint error over known-GT pixels (rw_flow.cpp:309-332; the
// reference names it MSE).  gt/flow: interleaved (h*w*2) float.
double bbme_average_epe(const float* gt, const float* flow, long long npix) {
  double total = 0.0;
  long long known = 0;
  for (long long i = 0; i < npix; ++i) {
    const float ug = gt[2 * i], vg = gt[2 * i + 1];
    if (std::fabs(ug) > kUnknownThresh || std::fabs(vg) > kUnknownThresh ||
        std::isnan(ug) || std::isnan(vg))
      continue;
    const double du = ug - flow[2 * i], dv = vg - flow[2 * i + 1];
    total += std::sqrt(du * du + dv * dv);
    ++known;
  }
  return known ? total / static_cast<double>(known) : 0.0;
}

}  // extern "C"
