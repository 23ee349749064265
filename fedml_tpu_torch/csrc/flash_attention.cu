// Flash attention forward for Hopper (sm_90a) on the FP32 cores, with a
// plain C interface loaded through ctypes by fedml_tpu_torch/ops/flash_attention.py.
//
// Replaces: fedml_tpu/ops/flash_attention.py, the pl.pallas_call of
// flash_attention (body _flash_kernel). Same function: softmax(q k^T / sqrt(D)) v
// over [B, T, H, D] inputs, causal or not, with the online softmax (running
// max, sum and output) kept in float32 and the output cast to q's type.
//
// What bounds it on the H100: at the shape the transformer FedAvg path
// evaluates ([256, 80, 4, 32] f32, causal) q, k, v and o are 41.9 MB, so
// device memory (3.35 TB/s) bounds it at about 12.5 us. The products need
// 4,608 score entries per head once no work is padded: about 0.3 GFMA, or
// 9 us of the FP32 cores' 67 TFLOP/s. At long context the products bound it.
//
// What the design does about it:
// - No padded work beyond 16 query rows x 32 keys. Each warp owns 16
//   consecutive query rows and walks K/V in subtiles of 32 keys. A warp
//   whose rows all lie past T does no products; in the causal case a warp
//   stops at the subtile that holds its own last row. Only the diagonal
//   subtile and the ragged end at T are masked.
// - Register tiles. Lane = (rg, cg), rg = lane / 8, cg = lane % 8. A thread
//   computes the scores of rows rg + 4i and keys cg + 8j (i, j < 4) and the
//   output of the same rows at columns 4 (cg + 8m) .. 4 (cg + 8m) + 3.
//   Every operand comes from shared memory as a float4: 8 loads for 64 FMAs
//   in each product. Shared rows have a stride of D + 4 floats, so float4s
//   stay aligned and 8 consecutive rows fall on 8 distinct 4-bank groups.
//   P goes through a warp-private slab (row stride 40: its scalar stores
//   hit 32 distinct banks) with __syncwarp and no block barrier. Row max
//   and row sum are reduced with __shfl_xor_sync over the 8 lanes of a row.
// - 16-byte global loads when the head dim is contiguous and every row
//   starts on a 16-byte boundary (the contiguous inputs of the main path:
//   a D = 32 f32 row is 128 B); a scalar path for other strides.
// - For T <= 128 one block holds all ceil(T / 16) row groups of a (b, h), so
//   K and V are read from device memory once per head. Longer sequences use
//   blocks of 64 rows that stream K/V through tiles of 64 keys.
// - Causal at T <= 128, a warp owns two row groups, a long one and a short
//   one, so the warps of a block finish together (row groups alone would
//   need 1, 1, 2, 2 and 3 subtiles at T = 80; pairs need 3 each).
// What still bounds it: both products read their operands from shared
// memory (0.125 float4 loads per FMA), and the short path's loads and
// compute overlap only across the few blocks an SM holds.
// bf16 and fp16 inputs are converted to f32 at load and run through the
// same FP32-core body: a tensor-core design for them is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 16;  // query rows per warp
constexpr int SUB = 32;        // keys per subtile
constexpr int MAX_WARPS = 8;
constexpr int SHORT_T = 128;   // up to here, one block per (b, h)
constexpr int LONG_WARPS = 4;  // warps per block past SHORT_T
constexpr int LONG_KV = 64;    // K/V rows per shared tile past SHORT_T
constexpr int LDP = SUB + 8;   // row stride of a warp's P slab

struct Strides {
  long long b, t, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Writes 16 bytes of T, as loaded, to shared memory as floats.
template <typename T>
__device__ __forceinline__ void store_f32(float* d, const uint4& x);
template <>
__device__ __forceinline__ void store_f32<float>(float* d, const uint4& x) {
  *reinterpret_cast<float4*>(d) =
      make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                  __uint_as_float(x.z), __uint_as_float(x.w));
}
template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(float* d,
                                                         const uint4& x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(d)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(d)[1] = make_float4(c.x, c.y, e.x, e.y);
}
template <>
__device__ __forceinline__ void store_f32<__half>(float* d, const uint4& x) {
  const __half2* h = reinterpret_cast<const __half2*>(&x);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  const float2 c = __half22float2(h[2]), e = __half22float2(h[3]);
  reinterpret_cast<float4*>(d)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(d)[1] = make_float4(c.x, c.y, e.x, e.y);
}

// Writes 4 consecutive outputs, as one store when `vec` (unit stride and
// aligned to 4 elements), else through the stride.
__device__ __forceinline__ void store4(float* p, float4 x, long long sd,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x;
    p[sd] = x.y;
    p[2 * sd] = x.z;
    p[3 * sd] = x.w;
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x,
                                       long long sd, bool vec) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  if (vec) {
    reinterpret_cast<__nv_bfloat162*>(p)[0] = lo;
    reinterpret_cast<__nv_bfloat162*>(p)[1] = hi;
  } else {
    p[0] = lo.x;
    p[sd] = lo.y;
    p[2 * sd] = hi.x;
    p[3 * sd] = hi.y;
  }
}
__device__ __forceinline__ void store4(__half* p, float4 x, long long sd,
                                       bool vec) {
  const __half2 lo = __floats2half2_rn(x.x, x.y);
  const __half2 hi = __floats2half2_rn(x.z, x.w);
  if (vec) {
    reinterpret_cast<__half2*>(p)[0] = lo;
    reinterpret_cast<__half2*>(p)[1] = hi;
  } else {
    p[0] = lo.x;
    p[sd] = lo.y;
    p[2 * sd] = hi.x;
    p[3 * sd] = hi.y;
  }
}

// Copies rows [t0, t0 + rows) of one (batch, head) slice into a float32
// shared tile with row stride D + 4; rows at or past seq_len are zeros.
// With `vec`, each thread moves 16 bytes a load and keeps LOADS loads in
// flight before it stores any. D and the loads per row are powers of two
// known at compile time, so a load's row and column come from shifts.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Strides& s, int t0, int rows,
                                          int seq_len, bool vec) {
  constexpr int LD = D + 4;
  if (vec) {
    constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
    constexpr int CHUNKS = D / N;      // loads per row
    constexpr int LOADS = 8;
    const int total = rows * CHUNKS;
    for (int i0 = threadIdx.x; i0 < total; i0 += LOADS * blockDim.x) {
      uint4 x[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * blockDim.x;
        const int t = t0 + i / CHUNKS;
        x[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && t < seq_len)
          x[u] = __ldg(reinterpret_cast<const uint4*>(
              src + (long long)t * s.t + (i % CHUNKS) * N));
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total)
          store_f32<T>(dst + (i / CHUNKS) * LD + (i % CHUNKS) * N, x[u]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      const int c = i % D;
      const int t = t0 + r;
      dst[r * LD + c] =
          t < seq_len ? to_f32(src[(long long)t * s.t + (long long)c * s.d])
                      : 0.f;
    }
  }
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// One block per (batch * head, Q tile of `groups` x 16 rows). Normally warp
// w owns row group w. With `paired` (causal, and every key in one shared
// tile) a block has ceil(groups / 2) warps and warp w owns row groups
// groups - 1 - w and w - (groups odd), the second skipped where negative:
// each warp then walks about the same number of key subtiles. `vec` has
// bit 0, 1, 2, 3 set when q, k, v, o may be read or written with vector
// accesses. Scores are kept in log2 units (scale_log2 = log2(e) / sqrt(D)),
// so each probability is one exp2.
template <typename T, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq_len,
                 int heads, int groups, int kv_tile, int paired, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale_log2,
                 int causal, int vec) {
  constexpr int LD = D + 4;   // shared row stride, in floats
  constexpr int DC = D / 32;  // float4 output columns per thread
  const int block_rows = groups * WARP_ROWS;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [block_rows][LD]
  float* k_s = q_s + block_rows * LD;            // [kv_tile][LD]
  float* v_s = k_s + kv_tile * LD;               // [kv_tile][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;  // rows w0 + rg + 4i
  const int cg = lane & 7;   // keys cg + 8j, columns 4 (cg + 8m) + 0..3
  float* p_w = v_s + kv_tile * LD + warp * WARP_ROWS * LDP;  // [16][LDP]

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  // the last Q tiles see the most keys when causal, so they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * block_rows;
  const T* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const T* kb = k + (long long)b * sk.b + (long long)h * sk.h;
  const T* vb = v + (long long)b * sv.b + (long long)h * sv.h;
  // keys that some warp of the block needs
  const int block_end = causal ? min(seq_len, q0 + block_rows) : seq_len;

  for (int n = 0; n < 1 + paired; ++n) {
    const int g = paired ? (n == 0 ? groups - 1 - warp
                                   : warp - (groups & 1))
                         : warp;
    const int w0 = q0 + g * WARP_ROWS;
    // keys this warp needs: none for a skipped group or rows past T
    const int warp_end = g < 0 || w0 >= seq_len ? 0
                         : causal ? min(seq_len, w0 + WARP_ROWS)
                                  : seq_len;
    const float* q_w = q_s + max(g, 0) * WARP_ROWS * LD;

    float4 acc[4][DC];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;  // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int k0 = 0; k0 < block_end; k0 += kv_tile) {
      if (n == 0) {  // a paired warp's second group reuses the one tile
        // whole subtiles: rows past seq_len load as zeros
        const int rows = min(kv_tile, (block_end - k0 + SUB - 1) / SUB * SUB);
        __syncthreads();  // the previous tile is no longer read
        if (k0 == 0)
          load_rows<T, D>(q_s, qb, sq, q0, block_rows, seq_len, vec & 1);
        load_rows<T, D>(k_s, kb, sk, k0, rows, seq_len, vec & 2);
        load_rows<T, D>(v_s, vb, sv, k0, rows, seq_len, vec & 4);
        __syncthreads();
      }

      const int sub_end = min(k0 + kv_tile, warp_end);
      for (int c0 = k0; c0 < sub_end; c0 += SUB) {
        const float* k_t = k_s + (c0 - k0) * LD;
        const float* v_t = v_s + (c0 - k0) * LD;

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          float4 qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] =
                *reinterpret_cast<const float4*>(q_w + (rg + 4 * i) * LD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[j] =
                *reinterpret_cast<const float4*>(k_t + (cg + 8 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            }
        }

        // only the ragged end and the diagonal subtile need a mask
        const bool edge =
            c0 + SUB > seq_len || (causal && c0 + SUB - 1 > w0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = w0 + rg + 4 * i;
          float m_sub = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = c0 + cg + 8 * j;
            float x = s[i][j] * scale_log2;
            if (edge && (key >= seq_len || (causal && key > row)))
              x = -INFINITY;
            s[i][j] = x;
            m_sub = fmaxf(m_sub, x);
          }
          const float m_new = fmaxf(m[i], row_max8(m_sub));
          // guards for rows that have seen no visible key yet
          const float alpha = isfinite(m[i]) ? exp2f(m[i] - m_new) : 0.f;
          const bool any = isfinite(m_new);
          float p_sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = any ? exp2f(s[i][j] - m_new) : 0.f;
            p_w[(rg + 4 * i) * LDP + cg + 8 * j] = p;
            p_sum += p;
          }
          l[i] = l[i] * alpha + p_sum;
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc[i][c].x *= alpha;
            acc[i][c].y *= alpha;
            acc[i][c].z *= alpha;
            acc[i][c].w *= alpha;
          }
        }
        __syncwarp();  // the slab is written

#pragma unroll
        for (int kk = 0; kk < SUB; kk += 4) {
          float p[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(
                p_w + (rg + 4 * i) * LDP + kk);
            p[i][0] = x.x;
            p[i][1] = x.y;
            p[i][2] = x.z;
            p[i][3] = x.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              const float4 y = *reinterpret_cast<const float4*>(
                  v_t + (kk + e) * LD + 4 * (cg + 8 * c));
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[i][c].x = fmaf(p[i][e], y.x, acc[i][c].x);
                acc[i][c].y = fmaf(p[i][e], y.y, acc[i][c].y);
                acc[i][c].z = fmaf(p[i][e], y.z, acc[i][c].z);
                acc[i][c].w = fmaf(p[i][e], y.w, acc[i][c].w);
              }
            }
        }
        __syncwarp();  // the slab is read before the next subtile writes it
      }
    }

    if (warp_end == 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = w0 + rg + 4 * i;
      const float denom = fmaxf(row_sum8(l[i]), 1e-30f);
      if (row >= seq_len) continue;
      T* orow = o + (long long)b * so.b + (long long)h * so.h +
                (long long)row * so.t;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 a = acc[i][c];
        store4(orow + (long long)(4 * (cg + 8 * c)) * so.d,
               make_float4(a.x / denom, a.y / denom, a.z / denom,
                           a.w / denom),
               so.d, vec & 8);
      }
    }
  }
}

// Whether a [B, T, H, D] tensor can be accessed `bytes` at a time: unit
// stride over D, and every row of D starting on a `bytes` boundary.
bool vectorizable(const void* p, const Strides& s, int batch, int seq_len,
                  int heads, int elem, int bytes) {
  const long long n = bytes / elem;
  return s.d == 1 && reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
         (batch == 1 || s.b % n == 0) && (seq_len == 1 || s.t % n == 0) &&
         (heads == 1 || s.h % n == 0);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq_len, int heads, const Strides* st,
                   float scale, int causal, cudaStream_t stream) {
  const bool short_seq = seq_len <= SHORT_T;
  const int groups =
      short_seq ? (seq_len + WARP_ROWS - 1) / WARP_ROWS : LONG_WARPS;
  const int kv_tile = short_seq ? (seq_len + SUB - 1) / SUB * SUB : LONG_KV;
  const int paired = causal && short_seq;
  const int nwarps = paired ? (groups + 1) / 2 : groups;
  const int block_rows = groups * WARP_ROWS;
  const size_t smem =
      sizeof(float) * ((size_t)(block_rows + 2 * kv_tile) * (D + 4) +
                       (size_t)nwarps * WARP_ROWS * LDP);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int elem = sizeof(T);
  const int vec =
      vectorizable(q, st[0], batch, seq_len, heads, elem, 16) |
      vectorizable(k, st[1], batch, seq_len, heads, elem, 16) << 1 |
      vectorizable(v, st[2], batch, seq_len, heads, elem, 16) << 2 |
      vectorizable(o, st[3], batch, seq_len, heads, elem, 4 * elem) << 3;
  const dim3 grid(batch * heads, (seq_len + block_rows - 1) / block_rows);
  flash_fwd_kernel<T, D><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, heads, groups,
      kv_tile, paired, st[0], st[1], st[2], st[3],
      scale * 1.4426950408889634f, causal, vec);
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
