// Flash attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by fedml_tpu_torch/ops/flash_attention.py.
//
// Replaces: fedml_tpu/ops/flash_attention.py, the pl.pallas_call of
// flash_attention (body _flash_kernel). Same function: softmax(q k^T / sqrt(D)) v
// over [B, T, H, D] inputs, causal or not, with the online softmax (running
// max, sum and output) kept in float32 and the output cast to q's type.
//
// What bounds it on the H100: at the shapes the transformer FedAvg path
// evaluates ([256, 80, 4, 32] f32, causal) the work is ~0.4 GFLOP against
// ~42 MB of q, k, v and o, so device memory (3.35 TB/s) bounds it: ~12.5 us.
// At long context (T in the thousands) the two products per tile dominate.
//
// What the design does about it: every input element is read from device
// memory once per Q tile into shared memory and converted to float32 there;
// the [T, T] score matrix never leaves the block (one 64x64 tile of it lives
// in shared memory at a time), and causal tiles past the Q tile are never
// loaded. q, k, v and o are addressed through their strides, so the
// [B, T, H, D] layout needs no transposes. The products run on the FP32
// cores, two threads per query row; wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key/value rows per shared-memory tile
constexpr int THREADS = 2 * BQ;   // two threads per query row
constexpr int LDP = BK + 1;       // padded row stride of the probability tile

struct Strides {
  long long b, t, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Copies rows [t0, t0 + rows) of one (batch, head) slice into a float32
// shared-memory tile with row stride ld; rows past the sequence are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const Strides& s, int t0, int rows,
                                          int seq_len) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    const int t = t0 + r;
    dst[r * ld + c] =
        t < seq_len ? to_f32(src[(long long)t * s.t + (long long)c * s.d])
                    : 0.f;
  }
}

// One block per (batch * head, Q tile). Thread (row, half) owns query row
// `row` of the tile, the keys of parity `half` in each K tile, and the
// output columns of parity `half`; interleaving by parity keeps the two
// threads of a row on different shared-memory banks.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq_len,
                 int heads, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale, int causal) {
  constexpr int LD = D + 1;      // padded row stride: rows on distinct banks
  constexpr int KC = BK / 2;     // keys of one tile per thread
  constexpr int DC = D / 2;      // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* k_s = q_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* p_s = v_s + BK * LD;    // [BQ][LDP]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.y * BQ;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int q_pos = q0 + row;

  const T* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const T* kb = k + (long long)b * sk.b + (long long)h * sk.h;
  const T* vb = v + (long long)b * sv.b + (long long)h * sv.h;

  load_tile<T, D>(q_s, LD, qb, sq, q0, BQ, seq_len);

  float acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // causal: key tiles past the last query row of this tile are skipped
  const int kv_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(k_s, LD, kb, sk, k0, BK, seq_len);
    load_tile<T, D>(v_s, LD, vb, sv, k0, BK, seq_len);
    __syncthreads();

    float s[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[row * LD + d];
#pragma unroll
      for (int j = 0; j < KC; ++j) s[j] += qd * k_s[(2 * j + half) * LD + d];
    }

    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int k_pos = k0 + 2 * j + half;
      const bool visible = k_pos < seq_len && (!causal || k_pos <= q_pos);
      s[j] = visible ? s[j] * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_new = fmaxf(m, m_tile);
    // guards for rows that have seen no visible key yet
    const float alpha = isfinite(m) ? expf(m - m_new) : 0.f;
    const bool any = isfinite(m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float p = any ? expf(s[j] - m_new) : 0.f;
      p_s[row * LDP + 2 * j + half] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = l * alpha + p_sum;
    m = m_new;
    __syncwarp();  // both threads of a row sit in one warp

#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = p_s[row * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] += p * v_s[c * LD + 2 * j + half];
    }
  }

  if (q_pos < seq_len) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + (long long)b * so.b + (long long)h * so.h +
            (long long)q_pos * so.t;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(long long)(2 * j + half) * so.d] = from_f32<T>(acc[j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq_len, int heads, const Strides* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LDP);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * heads, (seq_len + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, heads, st[0],
      st[1], st[2], st[3], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq_len, int heads,
                              int head_dim, const Strides* st, float scale,
                              int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, seq_len, heads, st, scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seq_len, heads, st, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seq_len, heads, st, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 16 element strides,
// (batch, time, head, dim) for q, k, v and o in that order. Returns the CUDA
// error of the launch (0 on success); the kernel runs on `stream`.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int batch, int seq_len, int heads,
                                       int head_dim, const long long* strides,
                                       float scale, int causal, void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<float>(q, k, v, o, batch, seq_len, heads,
                                      head_dim, st, scale, causal, s);
    case 1:
      return dispatch_head_dim<__nv_bfloat16>(q, k, v, o, batch, seq_len,
                                              heads, head_dim, st, scale,
                                              causal, s);
    case 2:
      return dispatch_head_dim<__half>(q, k, v, o, batch, seq_len, heads,
                                       head_dim, st, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
