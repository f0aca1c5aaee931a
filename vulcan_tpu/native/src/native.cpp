// vulcan-tpu native runtime: dataset decode/prefetch + mesh export.
//
// Counterpart of the reference's C++ app-side runtime (SURVEY.md
// component #21: dataset IO in apps/, component #19 Exporter): the
// accelerator owns all compute, but frame decode and mesh serialization
// are host work, implemented here so they overlap with device execution:
//
//   * PNG decode (libpng): TUM 16-bit depth -> float32 meters, 8-bit RGB
//     -> float32 [0,1].
//   * Prefetching loader: worker threads decode ahead into a bounded ring
//     buffer while the device runs the previous step (the reference's
//     synchronous cv::imread per frame is a pipeline bubble).
//   * PLY writer with O(n) hash-based vertex welding (replaces the numpy
//     sort-based weld for large meshes).
//
// C ABI only (ctypes-friendly; no pybind11 in this image).

#include <png.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

struct Image {
  int width = 0, height = 0, channels = 0, bit_depth = 0;
  std::vector<uint8_t> data;  // row-major, native libpng layout (big-endian
                              // 16-bit swapped to little below)
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && out->bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (out->bit_depth == 16) png_set_swap(png);  // little-endian uint16
  png_read_update_info(png, info);

  out->channels = png_get_channels(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; y++)
    rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

// ---------------------------------------------------------------------------
// Frame loader with prefetch
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> depth;   // H*W meters
  std::vector<float> color;   // H*W*3 in [0,1]
  int index = -1;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> rgb_paths;  // may be empty strings
  int height = 0, width = 0;
  float depth_scale = 5000.0f;

  std::vector<Frame> ring;
  size_t capacity = 0;
  std::atomic<int> next_to_decode{0};
  int next_to_serve = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::vector<uint8_t> slot_ready;  // guarded by mu

  int n_frames() const { return (int)depth_paths.size(); }
};

bool decode_frame(Loader* L, int idx, Frame* f) {
  f->index = idx;
  f->ok = false;
  Image dimg;
  if (!decode_png(L->depth_paths[idx].c_str(), &dimg)) return false;
  if (dimg.width != L->width || dimg.height != L->height) return false;
  size_t n = (size_t)L->width * L->height;
  f->depth.resize(n);
  if (dimg.bit_depth == 16 && dimg.channels == 1) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(dimg.data.data());
    const float inv = 1.0f / L->depth_scale;
    for (size_t i = 0; i < n; i++) f->depth[i] = p[i] * inv;
  } else if (dimg.bit_depth == 8 && dimg.channels == 1) {
    const float inv = 1.0f / L->depth_scale;
    for (size_t i = 0; i < n; i++) f->depth[i] = dimg.data[i] * inv;
  } else {
    return false;
  }
  f->color.assign(n * 3, 0.0f);
  if (!L->rgb_paths[idx].empty()) {
    Image cimg;
    if (decode_png(L->rgb_paths[idx].c_str(), &cimg) &&
        cimg.width == L->width && cimg.height == L->height &&
        cimg.channels == 3 && cimg.bit_depth == 8) {
      const float inv = 1.0f / 255.0f;
      for (size_t i = 0; i < n * 3; i++) f->color[i] = cimg.data[i] * inv;
    }
  }
  f->ok = true;
  return true;
}

void worker_main(Loader* L) {
  while (!L->stop.load()) {
    int idx = L->next_to_decode.fetch_add(1);
    if (idx >= L->n_frames()) return;
    size_t slot = idx % L->capacity;
    {
      // Wait until the slot is free (consumer has advanced far enough).
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(lk, [&] {
        return L->stop.load() || idx - L->next_to_serve < (int)L->capacity;
      });
      if (L->stop.load()) return;
    }
    Frame f;
    decode_frame(L, idx, &f);
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->ring[slot] = std::move(f);
      L->slot_ready[slot] = 1;
    }
    L->cv_ready.notify_all();
  }
}

// ---------------------------------------------------------------------------
// PLY writer with hash welding
// ---------------------------------------------------------------------------

struct VKey {
  int32_t x, y, z;
  bool operator==(const VKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};
struct VKeyHash {
  size_t operator()(const VKey& k) const {
    // Same prime mix as the voxel hash; fine for weld buckets.
    return ((size_t)(uint32_t)k.x * 73856093u) ^
           ((size_t)(uint32_t)k.y * 19349669u) ^
           ((size_t)(uint32_t)k.z * 83492791u);
  }
};

}  // namespace

extern "C" {

// --- one-shot decode (also used by tests) ---
// Returns 0 on success; fills width/height. Caller passes buffers sized
// w*h (depth, meters) and w*h*3 (rgb in [0,1]) obtained from a prior
// probe call with buffers=null.
int vt_png_probe(const char* path, int* width, int* height) {
  Image img;
  if (!decode_png(path, &img)) return 1;
  *width = img.width;
  *height = img.height;
  return 0;
}

int vt_decode_depth(const char* path, float depth_scale, float* out,
                    int expect_w, int expect_h) {
  Image img;
  if (!decode_png(path, &img)) return 1;
  if (img.width != expect_w || img.height != expect_h || img.channels != 1)
    return 2;
  size_t n = (size_t)img.width * img.height;
  float inv = 1.0f / depth_scale;
  if (img.bit_depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.data.data());
    for (size_t i = 0; i < n; i++) out[i] = p[i] * inv;
  } else if (img.bit_depth == 8) {
    for (size_t i = 0; i < n; i++) out[i] = img.data[i] * inv;
  } else {
    return 3;
  }
  return 0;
}

int vt_decode_rgb(const char* path, float* out, int expect_w, int expect_h) {
  Image img;
  if (!decode_png(path, &img)) return 1;
  if (img.width != expect_w || img.height != expect_h || img.channels != 3 ||
      img.bit_depth != 8)
    return 2;
  size_t n = (size_t)img.width * img.height * 3;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < n; i++) out[i] = img.data[i] * inv;
  return 0;
}

// --- prefetching loader ---
void* vt_loader_create(const char** depth_paths, const char** rgb_paths,
                       int n, int width, int height, float depth_scale,
                       int capacity, int n_threads) {
  Loader* L = new Loader();
  L->depth_paths.assign(depth_paths, depth_paths + n);
  L->rgb_paths.resize(n);
  for (int i = 0; i < n; i++)
    L->rgb_paths[i] = rgb_paths && rgb_paths[i] ? rgb_paths[i] : "";
  L->width = width;
  L->height = height;
  L->depth_scale = depth_scale;
  L->capacity = capacity > 0 ? capacity : 4;
  L->ring.resize(L->capacity);
  L->slot_ready.assign(L->capacity, 0);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++) L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocks until frame `next_to_serve` is decoded; returns 0 ok, 1 end,
// 2 decode error.
int vt_loader_next(void* handle, float* out_depth, float* out_color) {
  Loader* L = static_cast<Loader*>(handle);
  int idx = L->next_to_serve;
  if (idx >= L->n_frames()) return 1;
  size_t slot = idx % L->capacity;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return L->slot_ready[slot] && L->ring[slot].index == idx;
  });
  Frame& f = L->ring[slot];
  int rc = f.ok ? 0 : 2;
  if (f.ok) {
    memcpy(out_depth, f.depth.data(), f.depth.size() * sizeof(float));
    memcpy(out_color, f.color.data(), f.color.size() * sizeof(float));
  }
  L->slot_ready[slot] = 0;
  L->next_to_serve = idx + 1;
  lk.unlock();
  L->cv_space.notify_all();
  return rc;
}

void vt_loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// --- PLY export ---
// positions/colors: n_tris * 9 floats.  Returns number of welded vertices,
// or -1 on IO error.
long vt_ply_write(const char* path, const float* positions,
                  const float* colors, long n_tris, int weld,
                  float weld_resolution) {
  const long nv_in = n_tris * 3;
  std::vector<int32_t> remap(nv_in);
  std::vector<float> verts;
  std::vector<uint8_t> vcols;
  verts.reserve(nv_in);
  vcols.reserve(nv_in);
  const float inv_res = 1.0f / weld_resolution;

  std::unordered_map<VKey, int32_t, VKeyHash> seen;
  if (weld) seen.reserve(nv_in * 2);

  long n_out = 0;
  for (long i = 0; i < nv_in; i++) {
    const float* p = positions + i * 3;
    int32_t id;
    if (weld) {
      VKey key{(int32_t)lrintf(p[0] * inv_res), (int32_t)lrintf(p[1] * inv_res),
               (int32_t)lrintf(p[2] * inv_res)};
      auto it = seen.find(key);
      if (it != seen.end()) {
        id = it->second;
      } else {
        id = (int32_t)n_out++;
        seen.emplace(key, id);
        verts.insert(verts.end(), p, p + 3);
        const float* c = colors + i * 3;
        for (int k = 0; k < 3; k++) {
          float v = c[k] * 255.0f;
          vcols.push_back((uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)));
        }
      }
    } else {
      id = (int32_t)n_out++;
      verts.insert(verts.end(), p, p + 3);
      const float* c = colors + i * 3;
      for (int k = 0; k < 3; k++) {
        float v = c[k] * 255.0f;
        vcols.push_back((uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)));
      }
    }
    remap[i] = id;
  }

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat binary_little_endian 1.0\ncomment vulcan-tpu mesh "
          "(native)\nelement vertex %ld\nproperty float x\nproperty float "
          "y\nproperty float z\nproperty uchar red\nproperty uchar "
          "green\nproperty uchar blue\nelement face %ld\nproperty list uchar "
          "int vertex_indices\nend_header\n",
          n_out, n_tris);
  for (long v = 0; v < n_out; v++) {
    fwrite(verts.data() + v * 3, sizeof(float), 3, f);
    fwrite(vcols.data() + v * 3, 1, 3, f);
  }
  for (long t = 0; t < n_tris; t++) {
    uint8_t three = 3;
    fwrite(&three, 1, 1, f);
    fwrite(remap.data() + t * 3, sizeof(int32_t), 3, f);
  }
  fclose(f);
  return n_out;
}

}  // extern "C"
