// Flash attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by fedml_tpu_torch/ops/flash_attention.py. Two
// kernels sit behind flash_attention_forward: flash_fwd_kernel, on the FP32
// cores, for float32; flash_fwd_mma_kernel, on the tensor cores, for bf16
// and fp16.
//
// Replaces: fedml_tpu/ops/flash_attention.py, the pl.pallas_call of
// flash_attention (body _flash_kernel). Same function: softmax(q k^T / sqrt(D)) v
// over [B, T, H, D] inputs, causal or not, with the online softmax (running
// max, sum and output) kept in float32 and the output cast to q's type.
// One stated divergence, in the 16-bit kernel only: the Pallas body keeps
// the probabilities P in float32 for the P V product, and the tensor-core
// kernel rounds P to q's type before its mma, as every 16-bit flash kernel
// does (the row sums still add the float32 P).
//
// ---- float32: flash_fwd_kernel ----
//
// What bounds it on the H100: at the shape the transformer FedAvg path
// evaluates ([256, 80, 4, 32] f32, causal) q, k, v and o are 41.9 MB, so
// device memory (3.35 TB/s) bounds it at about 12.5 us. The products need
// 4,608 score entries per head once no work is padded: about 0.3 GFMA, or
// 9 us of the FP32 cores' 67 TFLOP/s. At long context the products bound it.
// The PEFT path's evaluation ([256, 20, 4, 16] f32, causal) moves 5.2 MB,
// 1.6 us of device memory, for 0.014 GFLOP: memory and the launch bound it.
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
//   in each product. At D = 16 a thread owns 2 output columns, 2 (cg + 8m)
//   and the next, read and written as float2s. Shared rows have a stride
//   of D + 4 floats, so float4s stay aligned and 8 consecutive rows fall
//   on 8 distinct 4-bank groups.
//   P goes through a warp-private slab (row stride 40: its scalar stores
//   hit 32 distinct banks) with __syncwarp and no block barrier. Row max
//   and row sum are reduced with __shfl_xor_sync over the 8 lanes of a row.
// - 16-byte global loads when the head dim is contiguous and every row
//   starts on a 16-byte boundary (the contiguous inputs of the main path:
//   a D = 32 f32 row is 128 B, a D = 16 row of the PEFT path 64 B); a
//   scalar path for other strides.
// - For T <= 128 one block holds all ceil(T / 16) row groups of a (b, h), so
//   K and V are read from device memory once per head. Longer sequences use
//   blocks of 64 rows that stream K/V through tiles of 64 keys.
// - Causal at T <= 128, a warp owns two row groups, a long one and a short
//   one, so the warps of a block finish together (row groups alone would
//   need 1, 1, 2, 2 and 3 subtiles at T = 80; pairs need 3 each).
// What still bounds it: both products read their operands from shared
// memory (0.125 float4 loads per FMA), and the short path's loads and
// compute overlap only across the few blocks an SM holds.
//
// ---- bf16 and fp16: flash_fwd_mma_kernel ----
//
// What bounds it on the H100: the products. At [4, 2048, 8, 64] bf16 they
// are 34.4 GFLOP non-causal and 17.2 causal (q k^T and P V, 2 flops a
// multiply-add), 34.7 and 17.4 us of the tensor cores' 989 TFLOP/s, while
// q, k, v and o are 33.6 MB, 10.0 us of device memory. At the main path's
// shape in bf16, [256, 80, 4, 32], memory bounds it (21 MB, 6.3 us).
//
// What the design does about it:
// - Both products on the tensor cores: mma.sync.m16n8k16 with bf16 or fp16
//   operands and float32 sums. A warp owns MG row groups of 16 query rows
//   (MG = 2 for D <= 64, 1 for D = 128, where two would not fit in the
//   registers) and keeps their q as A fragments in registers, loaded once
//   with ldmatrix.x4. K fragments come from ldmatrix.x4 and V fragments
//   from ldmatrix.x4.trans, and each feeds the products of all MG groups.
//   At D = 16, q k^T is one k-step and the output two n8 tiles, fed by one
//   ldmatrix.x4.trans of V per 16 keys.
//   Shared rows are padded by 8 elements (16 bytes), so the 8 row
//   addresses of an ldmatrix phase fall on distinct banks.
// - P never leaves the registers: the float32 accumulators of two adjacent
//   n8 score tiles, rounded to T and packed in pairs, are exactly the A
//   fragment of the P V product for those 16 keys (the FA2 layout
//   identity). Row max and row sum are reduced over the 4 lanes of a quad
//   (__shfl_xor_sync 1 and 2). The scores stay unscaled; the scale and
//   log2(e) fold into one FFMA before ex2.approx, so a probability costs
//   one FFMA and one MUFU instruction.
// - Interior tiles run a step with no mask and no branch; only the diagonal
//   tile and the ragged end at T are masked, and there the 16-key chunks
//   past a warp's last row are skipped.
// - Blocks of 128 query rows (4 warps of 2 x 16 rows for D <= 64, 8 warps
//   of 16 for D = 128), so K/V are read once per 128 rows, and for T <= 128
//   one block holds a whole (b, h). One layout serves every T.
// - K/V stream through a two-stage cp.async ring (16 bytes a thread,
//   zero-filled past T): tile j + 1 loads while tile j computes. Inputs
//   that cannot be read 16 bytes at a time (a strided head dim, rows off
//   16-byte alignment) take a scalar load path into the same tiles; the
//   output goes through shared memory and leaves as 16-byte stores.
// What still holds it back: mma.sync issues from one warp at a time, where
// wgmma reads B from shared memory for a whole warpgroup; the softmax's
// FFMA, MUFU, max and sum run on the same warps between the two products;
// and the loads are issued by the same warps that compute (no TMA, no
// warp specialisation). Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// Writes 16 bytes of T, as loaded, to shared memory as floats.
template <typename T>
__device__ __forceinline__ void store_f32(float* d, const uint4& x);
template <>
__device__ __forceinline__ void store_f32<float>(float* d, const uint4& x) {
  *reinterpret_cast<float4*>(d) =
      make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                  __uint_as_float(x.z), __uint_as_float(x.w));
}

// Output columns a thread owns per chunk: 4 (a float4) for D >= 32, so
// that 8 lanes cover 32 columns; 2 (a float2) at D = 16.
template <int D>
constexpr int OUT_VEC = D >= 32 ? 4 : D / 8;

// Reads N = 4 or 2 consecutive floats of shared memory as one access.
template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else {
    static_assert(N == 2, "a chunk is 4 or 2 floats");
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x;
    x[1] = y.y;
  }
}

// Writes N consecutive outputs, as one store when `vec` (unit stride and
// aligned to N elements), else through the stride.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N],
                                          long long sd, bool vec) {
  if (vec) {
    if constexpr (N == 4)
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e * sd] = x[e];
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
  constexpr int LD = D + 4;            // shared row stride, in floats
  constexpr int CV = OUT_VEC<D>;       // output columns per chunk
  constexpr int DC = D / (8 * CV);     // output chunks per thread
  const int block_rows = groups * WARP_ROWS;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [block_rows][LD]
  float* k_s = q_s + block_rows * LD;            // [kv_tile][LD]
  float* v_s = k_s + kv_tile * LD;               // [kv_tile][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;  // rows w0 + rg + 4i
  const int cg = lane & 7;   // keys cg + 8j, columns CV (cg + 8m) + 0..CV-1
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

    float acc[4][DC][CV];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;  // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[i][c][e] = 0.f;
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
          for (int c = 0; c < DC; ++c)
#pragma unroll
            for (int e = 0; e < CV; ++e) acc[i][c][e] *= alpha;
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
              float y[CV];
              load_vec<CV>(y, v_t + (kk + e) * LD + CV * (cg + 8 * c));
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int n = 0; n < CV; ++n)
                  acc[i][c][n] = fmaf(p[i][e], y[n], acc[i][c][n]);
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
        float out[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) out[e] = acc[i][c][e] / denom;
        store_vec<CV>(orow + (long long)(CV * (cg + 8 * c)) * so.d, out,
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
      vectorizable(o, st[3], batch, seq_len, heads, elem,
                   OUT_VEC<D> * elem) << 3;
  const dim3 grid(batch * heads, (seq_len + block_rows - 1) / block_rows);
  flash_fwd_kernel<T, D><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, heads, groups,
      kv_tile, paired, st[0], st[1], st[2], st[3],
      scale * 1.4426950408889634f, causal, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and fp16: flash_fwd_mma_kernel, on the tensor cores.

constexpr int MMA_KV = 64;     // keys per K/V tile
constexpr int MMA_ROWS = 128;  // query rows per block
constexpr int MMA_LD_PAD = 8;  // elements (16 bytes) past each shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 tiles of 16-bit elements from shared memory: lanes 8i .. 8i + 7
// give the addresses of tile i's rows, and r[i] receives this lane's pair
// of tile i (row lane / 4, columns 2 (lane % 4) and the next).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each tile transposed: the pair is column lane / 4, rows
// 2 (lane % 4) and the next.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: a is a 16 x 16 tile (row major) and b a 16 x 8 tile (column
// major) of T, d is float. Fragments as in the PTX ISA for m16n8k16, with
// g = lane / 4 and c = 2 (lane % 4): a = {(g, c), (g + 8, c), (g, c + 8),
// (g + 8, c + 8)}, b = {(c, g), (c + 8, g)}, d = {(g, c), (g, c + 1),
// (g + 8, c), (g + 8, c + 1)}; each 16-bit register holds a pair of
// neighbours along k.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to T and packed, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Copies 16 bytes from device to shared memory without passing through
// registers; with `valid` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [t0, t0 + rows) of one (batch, head) slice of 16-bit
// elements into a shared tile with row stride D + MMA_LD_PAD; rows at or
// past seq_len are zeros. With `vec`, by cp.async, 16 bytes a thread,
// completing at the next cp_async_wait that covers its group; else one
// element at a time through the strides, complete at the next barrier.
template <int D>
__device__ __forceinline__ void load_rows16(uint16_t* dst,
                                            const uint16_t* src,
                                            const Strides& s, int t0,
                                            int rows, int seq_len, bool vec) {
  constexpr int LD = D + MMA_LD_PAD;
  if (vec) {
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * CHUNKS; i += blockDim.x) {
      const int r = i / CHUNKS;
      const int c = (i % CHUNKS) * 8;
      const int t = t0 + r;
      cp_async16(smem_u32(dst + r * LD + c),
                 src + (long long)min(t, seq_len - 1) * s.t + c,
                 t < seq_len);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      const int c = i % D;
      const int t = t0 + r;
      dst[r * LD + c] =
          t < seq_len ? src[(long long)t * s.t + (long long)c * s.d] : 0;
    }
  }
}

// 2^x, with -inf giving 0 (one MUFU instruction; denormals flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row groups of 16 a warp owns: two where the registers allow it (D <= 64),
// so that each K and V fragment read from shared memory feeds two products.
template <int D>
constexpr int MMA_GROUPS = D <= 64 ? 2 : 1;

// One warp's step over one K/V tile in shared memory: the scores of its
// MG x 16 rows against the tile's MMA_KV keys, the online softmax, and p v
// added to acc. For row group i, m[i] is the running row max of the
// unscaled scores (rows g and g + 8 of the group), l[i] this lane's share
// of the running row sums. EDGE masks keys past seq_len and, when causal,
// past each row, and skips the 16-key chunks that lie wholly past
// warp_end; without it every key is visible.
template <typename T, int D, int MG, bool EDGE>
__device__ __forceinline__ void mma_tile(
    const uint32_t (&qf)[MG][D / 16][4], const uint16_t* k_t,
    const uint16_t* v_t, float (&acc)[MG][D / 8][4], float (&m)[MG][2],
    float (&l)[MG][2], int k0, int w0, int warp_end, int seq_len,
    int causal, float scale_log2) {
  constexpr int LD = D + MMA_LD_PAD;
  constexpr int KD = D / 16;
  constexpr int NS = MMA_KV / 8;
  constexpr int NO = D / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int chunks = EDGE ? (min(warp_end - k0, MMA_KV) + 15) >> 4 : NS / 2;

  float s[MG][NS][4];
#pragma unroll
  for (int i = 0; i < MG; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    if (!EDGE || j < chunks) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        // K rows are the columns of k^T: tiles (keys 16 j .. + 7 and
        // + 8 .. + 15) x (dims 16 kk .. + 7 and + 8 .. + 15)
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(k_t +
                                 (16 * j + (lane & 7) + ((lane >> 4) << 3)) *
                                     LD +
                                 16 * kk + (lane & 8)));
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          mma_16816<T>(s[i][2 * j], qf[i][kk], kf[0], kf[1]);
          mma_16816<T>(s[i][2 * j + 1], qf[i][kk], kf[2], kf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MG; ++i) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EDGE) {
          const int key = k0 + 8 * n + c2 + (e & 1);
          const int row = w0 + 16 * i + g + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > row)) s[i][n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i][n][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad share rows g and g + 8
      float mr = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      const float m_new = fmaxf(m[i][r], mr);
      // a row with no visible key yet keeps m = -inf: its p and alpha are 0
      const float m_scaled = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float alpha = ex2(m[i][r] * scale_log2 - m_scaled);
      float p_sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[i][n][e] = ex2(fmaf(s[i][n][e], scale_log2, -m_scaled));
          p_sum += s[i][n][e];
        }
      l[i][r] = l[i][r] * alpha + p_sum;
      m[i][r] = m_new;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[i][c][2 * r] *= alpha;
        acc[i][c][2 * r + 1] *= alpha;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    if (!EDGE || j < chunks) {
      // the score tiles of keys 16 j .. 16 j + 15 are, rounded to T, the A
      // fragment of p v for that k-step
      uint32_t pa[MG][4];
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        pa[i][0] = pack2<T>(s[i][2 * j][0], s[i][2 * j][1]);
        pa[i][1] = pack2<T>(s[i][2 * j][2], s[i][2 * j][3]);
        pa[i][2] = pack2<T>(s[i][2 * j + 1][0], s[i][2 * j + 1][1]);
        pa[i][3] = pack2<T>(s[i][2 * j + 1][2], s[i][2 * j + 1][3]);
      }
#pragma unroll
      for (int c = 0; c < NO / 2; ++c) {
        // V tiles (keys 16 j .. + 7 and + 8 .. + 15) x (dims 16 c .. + 7
        // and + 8 .. + 15), transposed into B fragments
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(v_t + (16 * j + (lane & 15)) * LD +
                                       16 * c + ((lane >> 4) << 3)));
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          mma_16816<T>(acc[i][2 * c], pa[i], vf[0], vf[1]);
          mma_16816<T>(acc[i][2 * c + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
  }
}

// One block per (batch * head, Q tile of MMA_ROWS rows); warp w owns rows
// q0 + 16 MG w .. q0 + 16 MG (w + 1) - 1 and keeps them, as the A fragments
// of q k^T, in registers. A warp whose rows all lie past T only helps load.
// K and V stream through a ring of two shared tiles of MMA_KV keys each.
// `vec` has bit 0, 1, 2, 3 set when q, k, v, o may be moved 16 bytes at a
// time. scale_log2 = log2(e) / sqrt(D) turns a score into the exponent of
// 2 of its probability.
template <typename T, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq_len,
                     int heads, Strides sq, Strides sk, Strides sv,
                     Strides so, float scale_log2, int causal, int vec) {
  constexpr int MG = MMA_GROUPS<D>;
  constexpr int ROWS = MG * WARP_ROWS;  // query rows per warp
  constexpr int LD = D + MMA_LD_PAD;    // shared row stride, in elements
  constexpr int KD = D / 16;            // k-steps of q k^T
  constexpr int NO = D / 8;             // n8 tiles of the output
  constexpr int TILE = MMA_KV * LD;     // elements of one K or V tile
  extern __shared__ uint4 smem_mma[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_mma);  // [MMA_ROWS][LD]
  uint16_t* kv_s = q_s + MMA_ROWS * LD;  // per stage: K tile, then V tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // rows g and g + 8 of each row group
  const int c2 = 2 * (lane & 3);  // columns c2, c2 + 1 of each n8 tile
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  // the last Q tiles see the most keys when causal, so they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_ROWS;
  const int w0 = q0 + warp * ROWS;
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) +
                       (long long)b * sq.b + (long long)h * sq.h;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) +
                       (long long)b * sk.b + (long long)h * sk.h;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) +
                       (long long)b * sv.b + (long long)h * sv.h;
  // keys that some warp of the block needs, and that this warp needs
  const int block_end = causal ? min(seq_len, q0 + MMA_ROWS) : seq_len;
  const int warp_end = w0 >= seq_len ? 0
                       : causal      ? min(seq_len, w0 + ROWS)
                                     : seq_len;
  const int n_tiles = (block_end + MMA_KV - 1) / MMA_KV;

  load_rows16<D>(q_s, qb, sq, q0, MMA_ROWS, seq_len, vec & 1);
  load_rows16<D>(kv_s, kb, sk, 0, MMA_KV, seq_len, vec & 2);
  load_rows16<D>(kv_s + TILE, vb, sv, 0, MMA_KV, seq_len, vec & 4);
  cp_async_commit();

  uint32_t qf[MG][KD][4];
  float acc[MG][NO][4];
  float m[MG][2], l[MG][2];
#pragma unroll
  for (int i = 0; i < MG; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = -INFINITY;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * MMA_KV;
    if (it + 1 < n_tiles) {  // tile it + 1 loads meanwhile
      uint16_t* nxt = kv_s + ((it + 1) & 1) * 2 * TILE;
      load_rows16<D>(nxt, kb, sk, k0 + MMA_KV, MMA_KV, seq_len, vec & 2);
      load_rows16<D>(nxt + TILE, vb, sv, k0 + MMA_KV, MMA_KV, seq_len,
                     vec & 4);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();

    const uint16_t* k_t = kv_s + (it & 1) * 2 * TILE;
    const uint16_t* v_t = k_t + TILE;
    if (k0 < warp_end) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < MG; ++i)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            ldmatrix_x4(qf[i][kk],
                        smem_u32(q_s + (warp * ROWS + 16 * i + (lane & 15)) *
                                           LD +
                                 16 * kk + ((lane >> 4) << 3)));
      }
      // only the ragged end and the diagonal tile need a mask
      if (k0 + MMA_KV > seq_len || (causal && k0 + MMA_KV - 1 > w0))
        mma_tile<T, D, MG, true>(qf, k_t, v_t, acc, m, l, k0, w0, warp_end,
                                 seq_len, causal, scale_log2);
      else
        mma_tile<T, D, MG, false>(qf, k_t, v_t, acc, m, l, k0, w0,
                                  warp_end, seq_len, causal, scale_log2);
    }
    __syncthreads();  // the stage is read before the next load reuses it
  }

  if (warp_end == 0) return;
  // the warp's own Q rows, read into registers long ago, stage its output
  uint16_t* o_s = q_s + warp * ROWS * LD;
#pragma unroll
  for (int i = 0; i < MG; ++i) {
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[i][r] + __shfl_xor_sync(0xffffffffu, l[i][r], 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      denom[r] = fmaxf(x, 1e-30f);
    }
    uint16_t* o_g = o_s + 16 * i * LD;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      *reinterpret_cast<uint32_t*>(o_g + g * LD + 8 * c + c2) =
          pack2<T>(acc[i][c][0] / denom[0], acc[i][c][1] / denom[0]);
      *reinterpret_cast<uint32_t*>(o_g + (g + 8) * LD + 8 * c + c2) =
          pack2<T>(acc[i][c][2] / denom[1], acc[i][c][3] / denom[1]);
    }
  }
  __syncwarp();
  uint16_t* ob = reinterpret_cast<uint16_t*>(o) + (long long)b * so.b +
                 (long long)h * so.h;
  if (vec & 8) {
    constexpr int CHUNKS = D / 8;
    for (int i = lane; i < ROWS * CHUNKS; i += 32) {
      const int r = i / CHUNKS;
      const int c = (i % CHUNKS) * 8;
      if (w0 + r < seq_len)
        *reinterpret_cast<uint4*>(ob + (long long)(w0 + r) * so.t + c) =
            *reinterpret_cast<const uint4*>(o_s + r * LD + c);
    }
  } else {
    for (int i = lane; i < ROWS * D; i += 32) {
      const int r = i / D;
      const int c = i % D;
      if (w0 + r < seq_len)
        ob[(long long)(w0 + r) * so.t + (long long)c * so.d] =
            o_s[r * LD + c];
    }
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int batch, int seq_len, int heads, const Strides* st,
                       float scale, int causal, cudaStream_t stream) {
  const int nwarps = MMA_ROWS / (MMA_GROUPS<D> * WARP_ROWS);
  // Q, and two stages of K and V
  const size_t smem =
      sizeof(uint16_t) * (MMA_ROWS + 4 * MMA_KV) * (D + MMA_LD_PAD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = vectorizable(q, st[0], batch, seq_len, heads, 2, 16) |
                  vectorizable(k, st[1], batch, seq_len, heads, 2, 16) << 1 |
                  vectorizable(v, st[2], batch, seq_len, heads, 2, 16) << 2 |
                  vectorizable(o, st[3], batch, seq_len, heads, 2, 16) << 3;
  const dim3 grid(batch * heads, (seq_len + MMA_ROWS - 1) / MMA_ROWS);
  flash_fwd_mma_kernel<T, D><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, heads, st[0],
      st[1], st[2], st[3], scale * 1.4426950408889634f, causal, vec);
  return cudaGetLastError();
}

// float32 goes to the FP32-core body, bf16 and fp16 to the tensor cores.
template <typename T, int D>
cudaError_t launch_for(const void* q, const void* k, const void* v, void* o,
                       int batch, int seq_len, int heads, const Strides* st,
                       float scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return launch<float, D>(q, k, v, o, batch, seq_len, heads, st, scale,
                            causal, stream);
  else
    return launch_mma<T, D>(q, k, v, o, batch, seq_len, heads, st, scale,
                            causal, stream);
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq_len, int heads,
                              int head_dim, const Strides* st, float scale,
                              int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_for<T, 16>(q, k, v, o, batch, seq_len, heads, st, scale,
                               causal, stream);
    case 32:
      return launch_for<T, 32>(q, k, v, o, batch, seq_len, heads, st, scale,
                               causal, stream);
    case 64:
      return launch_for<T, 64>(q, k, v, o, batch, seq_len, heads, st, scale,
                               causal, stream);
    case 128:
      return launch_for<T, 128>(q, k, v, o, batch, seq_len, heads, st, scale,
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
