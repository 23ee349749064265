// Tensor-frame codec: the native serialization hot path for the
// cross-host transport layer.
//
// The reference reaches native speed through pip-packaged bindings
// (mpi4py's C MPI, grpcio's C-core — SURVEY.md L0); its own payload path
// is python pickle of whole state_dicts (mpi_send_thread.py:22-27). This
// codec replaces that for bulk tensors: a frame is
//
//   [u64 total_len][u32 n_tensors]
//   n x [u32 dtype_code][u32 ndim][u64 dims...][u64 nbytes]
//   concatenated raw tensor bytes (8-byte aligned)
//
// pack() gathers all tensor buffers into one contiguous frame with
// multi-threaded memcpy (model blobs are 100MB-1GB class — memory
// bandwidth bound, so threads help); crc32c-style checksum guards DCN
// frames. unpack offsets let python build zero-copy numpy views.
//
// Built with: g++ -O3 -march=native -shared -fPIC -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Simple CRC32 (polynomial 0xEDB88320), table-driven.
static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t fedml_crc32(const uint8_t* buf, uint64_t len) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Header sizing: python computes the header; C++ does the bulk copy.
// copy_gather: memcpy n_srcs buffers into dst at given offsets, using up
// to n_threads worker threads split by bytes.
void fedml_copy_gather(uint8_t* dst, const uint8_t** srcs,
                       const uint64_t* sizes, const uint64_t* offsets,
                       uint32_t n_srcs, uint32_t n_threads) {
  if (n_threads <= 1) {
    for (uint32_t i = 0; i < n_srcs; i++)
      std::memcpy(dst + offsets[i], srcs[i], sizes[i]);
    return;
  }
  // assign tensors to threads round-robin weighted by bytes
  std::vector<std::vector<uint32_t>> buckets(n_threads);
  std::vector<uint64_t> loads(n_threads, 0);
  for (uint32_t i = 0; i < n_srcs; i++) {
    uint32_t t = 0;
    for (uint32_t j = 1; j < n_threads; j++)
      if (loads[j] < loads[t]) t = j;
    buckets[t].push_back(i);
    loads[t] += sizes[i];
  }
  std::vector<std::thread> workers;
  for (uint32_t t = 0; t < n_threads; t++) {
    if (buckets[t].empty()) continue;
    workers.emplace_back([&, t]() {
      for (uint32_t i : buckets[t])
        std::memcpy(dst + offsets[i], srcs[i], sizes[i]);
    });
  }
  for (auto& w : workers) w.join();
}

// scatter: the inverse — copy slices of one frame out to n dst buffers.
void fedml_copy_scatter(const uint8_t* src, uint8_t** dsts,
                        const uint64_t* sizes, const uint64_t* offsets,
                        uint32_t n_dsts, uint32_t n_threads) {
  if (n_threads <= 1) {
    for (uint32_t i = 0; i < n_dsts; i++)
      std::memcpy(dsts[i], src + offsets[i], sizes[i]);
    return;
  }
  std::vector<std::vector<uint32_t>> buckets(n_threads);
  std::vector<uint64_t> loads(n_threads, 0);
  for (uint32_t i = 0; i < n_dsts; i++) {
    uint32_t t = 0;
    for (uint32_t j = 1; j < n_threads; j++)
      if (loads[j] < loads[t]) t = j;
    buckets[t].push_back(i);
    loads[t] += sizes[i];
  }
  std::vector<std::thread> workers;
  for (uint32_t t = 0; t < n_threads; t++) {
    if (buckets[t].empty()) continue;
    workers.emplace_back([&, t]() {
      for (uint32_t i : buckets[t])
        std::memcpy(dsts[i], src + offsets[i], sizes[i]);
    });
  }
  for (auto& w : workers) w.join();
}

// Quantize float32 -> uint8 with per-tensor scale/zero (transport
// compression for model blobs; lossy, opt-in).
void fedml_quantize_u8(const float* src, uint8_t* dst, uint64_t n,
                       float lo, float hi) {
  float scale = (hi > lo) ? 255.0f / (hi - lo) : 0.0f;
  for (uint64_t i = 0; i < n; i++) {
    float v = (src[i] - lo) * scale;
    if (v < 0.0f) v = 0.0f;
    if (v > 255.0f) v = 255.0f;
    dst[i] = (uint8_t)(v + 0.5f);
  }
}

void fedml_dequantize_u8(const uint8_t* src, float* dst, uint64_t n,
                         float lo, float hi) {
  float scale = (hi - lo) / 255.0f;
  for (uint64_t i = 0; i < n; i++) dst[i] = lo + src[i] * scale;
}

}  // extern "C"
