// Native host-side data loader.
//
// The reference delegates its data loading to torch DataLoader's native
// worker pool (vqwae_train.py:1045-1048). This library is the equivalent:
// mmap-based .npy readers, hop-aligned synchronized random cropping (the
// collate contract of vqwae_train.py:468-478), and multithreaded batch
// assembly — all outside the Python GIL. Python binds via ctypes
// (wavenet_autoencoders_tpu_torch/data/native.py), which builds this file
// at first use:  g++ -O3 -std=c++17 -shared -fPIC -pthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// minimal .npy (format 1.0/2.0) parser — C-order, little-endian only
// ---------------------------------------------------------------------
struct NpyInfo {
  char dtype;        // 'f' float32, 'h' int16, 'i' int32, 'd' float64
  int64_t rows;
  int64_t cols;      // 1 for 1-D
  size_t data_offset;
  size_t item_size;
};

bool parse_npy_header(const uint8_t* buf, size_t len, NpyInfo* info) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) | ((size_t)buf[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string h(reinterpret_cast<const char*>(buf + header_off), header_len);

  auto find_val = [&](const char* key) -> std::string {
    size_t p = h.find(key);
    if (p == std::string::npos) return "";
    p = h.find(':', p);
    size_t e = h.find(',', p);
    // shape tuple contains commas; handled separately
    return h.substr(p + 1, e - p - 1);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("<f4") != std::string::npos) { info->dtype = 'f'; info->item_size = 4; }
  else if (descr.find("<i2") != std::string::npos) { info->dtype = 'h'; info->item_size = 2; }
  else if (descr.find("<i4") != std::string::npos) { info->dtype = 'i'; info->item_size = 4; }
  else if (descr.find("<i8") != std::string::npos) { info->dtype = 'q'; info->item_size = 8; }
  else if (descr.find("<f8") != std::string::npos) { info->dtype = 'd'; info->item_size = 8; }
  else return false;

  if (h.find("'fortran_order': True") != std::string::npos) return false;

  size_t sp = h.find("'shape'");
  if (sp == std::string::npos) return false;
  sp = h.find('(', sp);
  size_t se = h.find(')', sp);
  std::string shape = h.substr(sp + 1, se - sp - 1);
  long r = 0, c = 1;
  int n = sscanf(shape.c_str(), "%ld , %ld", &r, &c);
  if (n < 1) return false;
  if (n == 1) c = 1;
  info->rows = r;
  info->cols = c;
  info->data_offset = header_off + header_len;
  return true;
}

struct MappedNpy {
  uint8_t* base = nullptr;
  size_t len = 0;
  NpyInfo info;
};

bool map_npy(const char* path, MappedNpy* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return false; }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return false;
  out->base = static_cast<uint8_t*>(p);
  out->len = st.st_size;
  if (!parse_npy_header(out->base, out->len, &out->info)) {
    munmap(p, st.st_size);
    return false;
  }
  return true;
}

void unmap_npy(MappedNpy* m) {
  if (m->base) munmap(m->base, m->len);
  m->base = nullptr;
}

template <typename SRC>
void copy_rows_f32(const uint8_t* data, int64_t cols, int64_t row0,
                   int64_t nrows, float* dst) {
  const SRC* src = reinterpret_cast<const SRC*>(data) + row0 * cols;
  for (int64_t i = 0; i < nrows * cols; ++i) dst[i] = static_cast<float>(src[i]);
}

template <typename SRC>
void copy_rows_i32(const uint8_t* data, int64_t cols, int64_t row0,
                   int64_t nrows, int32_t* dst) {
  const SRC* src = reinterpret_cast<const SRC*>(data) + row0 * cols;
  for (int64_t i = 0; i < nrows * cols; ++i) dst[i] = static_cast<int32_t>(src[i]);
}

// xorshift64 — per-item deterministic crop RNG
inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13; x ^= x >> 7; x ^= x << 17;
  *s = x;
  return x;
}

}  // namespace

extern "C" {

// Read one utterance pair and write a synchronized hop-aligned random crop:
//   wave npy (T,) int16/int32 -> x_out (max_steps,) int32
//   feat npy (N, D) f32       -> c_out (max_frames + 2*cin_pad, D) f32
// Crop start frame s ~ U[cin_pad, N - max_frames - cin_pad] from `seed`.
// Returns 0 ok, negative error.
int wae_load_crop(const char* wave_path, const char* feat_path,
                  int64_t max_steps, int64_t hop, int64_t cin_pad,
                  uint64_t seed, int32_t* x_out, float* c_out,
                  int64_t* feat_dim_out) {
  MappedNpy wav, feat;
  if (!map_npy(wave_path, &wav)) return -1;
  if (!map_npy(feat_path, &feat)) { unmap_npy(&wav); return -2; }

  int64_t N = feat.info.rows, D = feat.info.cols;
  int64_t max_frames = max_steps / hop;
  int rc = 0;
  if (wav.info.rows != N * hop) rc = -3;  // alignment contract
  else if (N < max_frames + 2 * cin_pad) rc = -4;
  else {
    int64_t lo = cin_pad, hi = N - max_frames - cin_pad;  // inclusive
    uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ull;
    int64_t s = lo + (int64_t)(xorshift64(&st) % (uint64_t)(hi - lo + 1));
    // wave crop [s*hop, s*hop + max_steps)
    const uint8_t* wdata = wav.base + wav.info.data_offset;
    if (wav.info.dtype == 'h')
      copy_rows_i32<int16_t>(wdata, 1, s * hop, max_steps, x_out);
    else if (wav.info.dtype == 'i')
      copy_rows_i32<int32_t>(wdata, 1, s * hop, max_steps, x_out);
    else if (wav.info.dtype == 'q')
      copy_rows_i32<int64_t>(wdata, 1, s * hop, max_steps, x_out);
    else rc = -5;
    // feature crop [s - cin_pad, s + max_frames + cin_pad)
    if (rc == 0) {
      const uint8_t* fdata = feat.base + feat.info.data_offset;
      if (feat.info.dtype == 'f')
        copy_rows_f32<float>(fdata, D, s - cin_pad, max_frames + 2 * cin_pad, c_out);
      else if (feat.info.dtype == 'd')
        copy_rows_f32<double>(fdata, D, s - cin_pad, max_frames + 2 * cin_pad, c_out);
      else rc = -6;
    }
    *feat_dim_out = D;
  }
  unmap_npy(&wav);
  unmap_npy(&feat);
  return rc;
}

// Assemble a full batch in parallel over worker threads.
// wave_paths/feat_paths: B C-string pointers. Outputs are contiguous:
//   x_out (B, max_steps) int32; c_out (B, max_frames+2*cin_pad, D) f32.
int wae_load_batch(const char** wave_paths, const char** feat_paths,
                   int64_t batch, int64_t max_steps, int64_t hop,
                   int64_t cin_pad, int64_t feat_dim, uint64_t seed,
                   int32_t* x_out, float* c_out, int n_threads) {
  int64_t frames = max_steps / hop + 2 * cin_pad;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  int nt = n_threads > 0 ? n_threads : 2;

  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= batch || err.load() != 0) break;
      int64_t d = 0;
      int rc = wae_load_crop(wave_paths[i], feat_paths[i], max_steps, hop,
                             cin_pad, seed + 0x517CC1B727220A95ull * (i + 1),
                             x_out + i * max_steps,
                             c_out + i * frames * feat_dim, &d);
      if (rc != 0) err.store(rc);
      else if (d != feat_dim) err.store(-7);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  return err.load();
}

// Probe a npy header: returns rows, cols via out params (0 on success).
int wae_npy_shape(const char* path, int64_t* rows, int64_t* cols) {
  MappedNpy m;
  if (!map_npy(path, &m)) return -1;
  *rows = m.info.rows;
  *cols = m.info.cols;
  unmap_npy(&m);
  return 0;
}

}  // extern "C"
