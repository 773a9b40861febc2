// Native scene-IO runtime: fast COLMAP binary model parsing.
//
// The reference's host-side data layer is Python (scene/colmap_loader.py);
// at real scene scale (1M+ SfM points, thousands of images) per-record
// Python struct unpacking takes tens of seconds. This C++ reader streams the
// COLMAP binary files in one pass each. Exposed over a plain C ABI consumed
// via ctypes (gof_tpu_torch/native/__init__.py), which builds it with
// g++ -O3 -shared -fPIC at first use; the pure-Python parser remains as the
// fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct File {
  FILE* f;
  explicit File(const char* path) { f = fopen(path, "rb"); }
  ~File() {
    if (f) fclose(f);
  }
  bool ok() const { return f != nullptr; }
  template <typename T>
  bool read(T* out, size_t n = 1) {
    return fread(out, sizeof(T), n, f) == n;
  }
  bool skip(long n) { return fseek(f, n, SEEK_CUR) == 0; }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// points3D.bin: u64 count, then per point:
//   u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len, track_len x (i32, i32)
// ---------------------------------------------------------------------------

long long colmap_count_points3d(const char* path) {
  File file(path);
  if (!file.ok()) return -1;
  uint64_t n = 0;
  if (!file.read(&n)) return -1;
  return (long long)n;
}

// xyz: [n*3] f64, rgb: [n*3] u8, err: [n] f64. Returns read count or -1.
long long colmap_read_points3d(const char* path, double* xyz, uint8_t* rgb,
                               double* err, long long cap) {
  File file(path);
  if (!file.ok()) return -1;
  uint64_t n = 0;
  if (!file.read(&n)) return -1;
  if ((long long)n > cap) n = (uint64_t)cap;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t id;
    if (!file.read(&id)) return -1;
    if (!file.read(xyz + 3 * i, 3)) return -1;
    if (!file.read(rgb + 3 * i, 3)) return -1;
    if (!file.read(err + i)) return -1;
    uint64_t track = 0;
    if (!file.read(&track)) return -1;
    if (!file.skip((long)(track * 8))) return -1;
  }
  return (long long)n;
}

// ---------------------------------------------------------------------------
// images.bin: u64 count, then per image:
//   i32 id, 4x f64 qvec, 3x f64 tvec, i32 camera_id, name\0,
//   u64 n2d, n2d x (f64, f64, i64)
// ---------------------------------------------------------------------------

long long colmap_count_images(const char* path) {
  File file(path);
  if (!file.ok()) return -1;
  uint64_t n = 0;
  if (!file.read(&n)) return -1;
  return (long long)n;
}

// qvec: [n*4], tvec: [n*3], ids/cam_ids: [n] i32, names: [n*name_stride] char
long long colmap_read_images(const char* path, int32_t* ids, double* qvec,
                             double* tvec, int32_t* cam_ids, char* names,
                             long long name_stride, long long cap) {
  File file(path);
  if (!file.ok()) return -1;
  uint64_t n = 0;
  if (!file.read(&n)) return -1;
  if ((long long)n > cap) n = (uint64_t)cap;
  for (uint64_t i = 0; i < n; i++) {
    if (!file.read(ids + i)) return -1;
    if (!file.read(qvec + 4 * i, 4)) return -1;
    if (!file.read(tvec + 3 * i, 3)) return -1;
    if (!file.read(cam_ids + i)) return -1;
    long long pos = 0;
    char* dst = names + i * name_stride;
    for (;;) {
      char c;
      if (!file.read(&c)) return -1;
      if (c == '\0') break;
      if (pos < name_stride - 1) dst[pos++] = c;
    }
    dst[pos] = '\0';
    uint64_t n2d = 0;
    if (!file.read(&n2d)) return -1;
    if (!file.skip((long)(n2d * 24))) return -1;
  }
  return (long long)n;
}

// ---------------------------------------------------------------------------
// cameras.bin: u64 count, then per camera:
//   i32 id, i32 model, u64 width, u64 height, num_params(model) x f64
// ---------------------------------------------------------------------------

static const int kNumParams[] = {3, 4, 4, 5, 8, 8, 12, 5, 4, 5, 12};

long long colmap_read_cameras(const char* path, int32_t* ids, int32_t* models,
                              int64_t* wh, double* params /* [n*12] */,
                              long long cap) {
  File file(path);
  if (!file.ok()) return -1;
  uint64_t n = 0;
  if (!file.read(&n)) return -1;
  if ((long long)n > cap) n = (uint64_t)cap;
  for (uint64_t i = 0; i < n; i++) {
    int32_t model;
    uint64_t w, h;
    if (!file.read(ids + i)) return -1;
    if (!file.read(&model)) return -1;
    if (!file.read(&w) || !file.read(&h)) return -1;
    models[i] = model;
    wh[2 * i] = (int64_t)w;
    wh[2 * i + 1] = (int64_t)h;
    int np = (model >= 0 && model <= 10) ? kNumParams[model] : 0;
    memset(params + 12 * i, 0, 12 * sizeof(double));
    if (np > 0 && !file.read(params + 12 * i, np)) return -1;
  }
  return (long long)n;
}

}  // extern "C"
