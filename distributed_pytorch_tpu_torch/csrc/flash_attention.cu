// Flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward kernels (K2: dQ, K3: dK and dV).
//
// Replaces the TPU kernels of distributed_pytorch_tpu/ops/flash_attention.py:
//   K1 _fwd_kernel      (pallas_call in _flash_fwd)      -> flash_fwd
//   K2 _bwd_dq_kernel   (first pallas_call of _flash_bwd_impl) -> flash_bwd_dq
//   K3 _bwd_dkv_kernel  (second pallas_call of _flash_bwd_impl) -> flash_bwd_dkv
// over q, k, v laid out [B*H, T, D] (one contiguous [T, D] slab per head).
//
// The function is the TPU kernels' own. Scores are s = (q . k) * D^-0.5 in
// fp32; causal masking (query position i + q_offset sees key j iff
// i + q_offset >= j, and with window > 0 also i + q_offset - j < window)
// writes NEG_INF = -1e30 (finite, as in the JAX package), and tiles with no
// unmasked pair are skipped by the reference's _tile_live rule on 64 x 64
// tiles. The forward runs the online softmax in fp32 (running max m,
// denominator l, accumulator) in the reference's order of operations, so a
// row that is wholly masked inside a live tile takes exp(NEG_INF - NEG_INF)
// = 1 exactly as on the TPU, and a row whose every tile is skipped writes
// out = 0 and lse = NEG_INF. The values are rounded where the reference
// rounds: p to v's dtype before P V (K1) and before P^T dO (K3), ds to k's
// dtype before dS K (K2) and to q's dtype before dS^T Q (K3). The backward
// kernels rebuild p = exp(s - lse) from the saved lse; delta = rowsum(dO o O)
// (minus the lse cotangent) comes in from the caller, as XLA computed it
// outside the TPU kernels. T need not be a multiple of the tile: rows and
// keys past T are loaded as zeros and given p = 0, so the tail tile is
// masked in the kernel and no shape falls back to dense attention.
//
// What bounds it on this card: operations. Causal attention at T = 8192,
// D = 128 does ~2 * T^2 * D flops per head per product against ~6 * T * D
// bytes of inputs and outputs, thousands of flops per byte. The H100's
// bound is its 989 TFLOP/s of bf16 tensor-core math.
//
// What this design does about it: little yet, by intent. It is the simple
// kernel that is right. Each block owns one 64-row tile of its output
// (queries for K1 and K2, keys for K3, so no block shares an output row and
// no atomics are needed) and loops over the tiles of the other side,
// replacing the TPU grid's innermost dimension and its VMEM scratch by
// registers: 256 threads in a 16 x 16 grid, each holding a 4 x 4 block of
// scores and a 4 x D/16 block of the accumulator, fed from fp32 tiles in
// shared memory by 16-byte loads, with plain fp32 FMAs on the CUDA cores
// (67 TFLOP/s at most). Tensor cores (mma / wgmma), TMA tile loads, bf16
// tiles in shared memory and a pipelined ring of tiles are left to later
// work; PERF.md records the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;       // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kLdP = kBlock + 4; // row stride of a [64][64] score tile
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// x rounded to T's precision and back (the reference's .astype casts).
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Reductions over the 16 threads that share a row (tx = lane & 15).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The reference's _tile_live for a causal (optionally banded) tile.
__device__ __forceinline__ bool tile_live(int q_start, int k_start,
                                          int window) {
  bool live = k_start <= q_start + kBlock - 1;
  if (window) live = live && (q_start - (k_start + kBlock - 1) <= window - 1);
  return live;
}

// Whether query position qpos may see key position kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  if (!causal) return true;
  return qpos >= kpos && (window == 0 || qpos - kpos < window);
}

// Rows row0 .. row0 + 63 of one head's [t, D] slab into dst [64][D + 4] as
// fp32; rows at or past t are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t) {
  constexpr int kLd = D + 4;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    dst[r * kLd + c] =
        row < t ? to_float(src[static_cast<int64_t>(row) * D + c]) : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]; A, B are [64][D + 4].
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&acc)[4][4], int ty, int tx) {
  constexpr int kLd = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][4 j + e] += sum_c P[ty + 16 i][c] * B[c][64 j + 4 tx + e];
// P is [64][kLdP], B is [64][D + 4].
template <int D>
__device__ __forceinline__ void mm_nn(const float* P, const float* B,
                                      float (&acc)[4][D / 16], int ty,
                                      int tx) {
  constexpr int kLd = D + 4;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLdP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* brow = B + (c + cc) * kLd + 4 * tx;
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(brow + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = comp(p[i], cc);
          acc[i][4 * j + 0] = fmaf(pv, b.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(pv, b.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pv, b.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pv, b.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// Row r's D/16 accumulator cells of this thread into out[row][.].
template <typename T, int D>
__device__ __forceinline__ void store_row(T* out_row, const float* acc,
                                          float div, int tx) {
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) store(&out_row[64 * j + 4 * tx + e], acc[4 * j + e] / div);
}

// ---------------------------------------------------------------- K1
// One block per (query tile, b*h). Shared: q_s, k_s, v_s [64][D + 4]; the
// probability tile p_s [64][kLdP] reuses k_s once the scores are taken.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int t, float scale,
    int causal, int window, int q_offset) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = D + 4;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlock * kLd;
  float* v_s = k_s + kBlock * kLd;
  float* p_s = k_s;

  const int n_tiles = (t + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int64_t base = static_cast<int64_t>(blockIdx.y) * t * D;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qt * kBlock;
  const int q_start = q0 + q_offset;
  load_tile<T, D>(q_s, q + base, q0, t);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    if (causal && !tile_live(q_start, k0, window)) continue;
    __syncthreads();  // the last tile's readers of k_s / p_s / v_s are done
    load_tile<T, D>(k_s, k + base, k0, t);
    load_tile<T, D>(v_s, v + base, k0, t);
    __syncthreads();
    float s[4][4] = {};
    mm_nt<D>(q_s, k_s, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (!visible(qpos, kpos, causal, window)) x = kNegInf;
        if (kpos >= t) x = -INFINITY;  // no such key: p = 0 below
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // every thread is done reading k_s, which p_s reuses
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = round_as<T>(s[i][j]);
    __syncthreads();
    mm_nn<D>(p_s, v_s, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    store_row<T, D>(out + base + static_cast<int64_t>(row) * D, acc[i], l_safe, tx);
    if (tx == 0)
      lse[static_cast<int64_t>(blockIdx.y) * t + row] =
          l[i] == 0.f ? kNegInf : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- K2
// One block per (query tile, b*h). Shared: q_s, do_s, k_s, v_s [64][D + 4];
// the ds tile reuses v_s once dP is taken.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int t, float scale,
    int causal, int window, int q_offset) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = D + 4;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kBlock * kLd;
  float* k_s = do_s + kBlock * kLd;
  float* v_s = k_s + kBlock * kLd;
  float* ds_s = v_s;

  const int n_tiles = (t + kBlock - 1) / kBlock;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * t * D;
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * t;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qt * kBlock;
  const int q_start = q0 + q_offset;
  load_tile<T, D>(q_s, q + base, q0, t);
  load_tile<T, D>(do_s, dout + base, q0, t);

  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < t ? lse[row_base + row] : 0.f;
    delta_r[i] = row < t ? delta[row_base + row] : 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    if (causal && !tile_live(q_start, k0, window)) continue;
    __syncthreads();
    load_tile<T, D>(k_s, k + base, k0, t);
    load_tile<T, D>(v_s, v + base, k0, t);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mm_nt<D>(q_s, k_s, s, ty, tx);
    mm_nt<D>(do_s, v_s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty + 16 * i;
      const bool row_ok = q0 + ty + 16 * i < t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (!visible(qpos, kpos, causal, window)) x = kNegInf;
        const float p = (row_ok && kpos < t) ? expf(x - lse_r[i]) : 0.f;
        s[i][j] = round_as<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    }
    __syncthreads();  // every thread is done reading v_s, which ds_s reuses
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();
    mm_nn<D>(ds_s, k_s, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < t)
      store_row<T, D>(dq + base + static_cast<int64_t>(row) * D, acc[i], 1.f, tx);
  }
}

// ---------------------------------------------------------------- K3
// One block per (key tile, b*h): scores are taken transposed, keys as rows
// and queries as columns. Shared: k_s, v_s, q_s, do_s [64][D + 4] and one
// [64][kLdP] tile holding P^T, then dS^T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int t, float scale, int causal, int window, int q_offset) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = D + 4;
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kBlock * kLd;
  float* q_s = v_s + kBlock * kLd;
  float* do_s = q_s + kBlock * kLd;
  float* pt_s = do_s + kBlock * kLd;

  const int n_tiles = (t + kBlock - 1) / kBlock;
  const int kt = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * t * D;
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * t;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int k0 = kt * kBlock;
  load_tile<T, D>(k_s, k + base, k0, t);
  load_tile<T, D>(v_s, v + base, k0, t);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlock;
    const int q_start = q0 + q_offset;
    if (causal && !tile_live(q_start, k0, window)) continue;
    __syncthreads();
    load_tile<T, D>(q_s, q + base, q0, t);
    load_tile<T, D>(do_s, dout + base, q0, t);
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      lse_c[j] = row < t ? lse[row_base + row] : 0.f;
      delta_c[j] = row < t ? delta[row_base + row] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {};
    float dpt[4][4] = {};
    mm_nt<D>(k_s, q_s, st, ty, tx);
    mm_nt<D>(v_s, do_s, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qrow = q0 + tx + 16 * j;
        float x = st[i][j] * scale;
        if (!visible(q_start + tx + 16 * j, kpos, causal, window)) x = kNegInf;
        const float p = (kpos < t && qrow < t) ? expf(x - lse_c[j]) : 0.f;
        st[i][j] = p;
        pt_s[(ty + 16 * i) * kLdP + tx + 16 * j] = round_as<T>(p);
      }
    }
    __syncthreads();
    mm_nn<D>(pt_s, do_s, dv_acc, ty, tx);
    __syncthreads();  // every thread is done reading P^T before dS^T lands
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt_s[(ty + 16 * i) * kLdP + tx + 16 * j] =
            round_as<T>(st[i][j] * (dpt[i][j] - delta_c[j]) * scale);
    __syncthreads();
    mm_nn<D>(pt_s, q_s, dk_acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t) continue;
    store_row<T, D>(dk + base + static_cast<int64_t>(row) * D, dk_acc[i], 1.f, tx);
    store_row<T, D>(dv + base + static_cast<int64_t>(row) * D, dv_acc[i], 1.f, tx);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int bh, int t, float scale, int causal, int window,
                int q_offset, cudaStream_t stream) {
  const size_t smem = 3 * kBlock * (D + 4) * sizeof(float);
  const cudaError_t err = set_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBlock - 1) / kBlock, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      t, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int t, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  const size_t smem = 4 * kBlock * (D + 4) * sizeof(float);
  const cudaError_t err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBlock - 1) / kBlock, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int t, float scale, int causal,
                    int window, int q_offset, cudaStream_t stream) {
  const size_t smem =
      (4 * kBlock * (D + 4) + kBlock * kLdP) * sizeof(float);
  const cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBlock - 1) / kBlock, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, scale, causal, window,
      q_offset);
  return cudaGetLastError();
}

// Calls f(T{}, std::integral_constant<int, D>{}) for the dtype code
// (0 = float32, 1 = bfloat16) and head dim (64 or 128) it names.
template <typename F>
int dispatch(int dtype_code, int head_dim, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype_code == 0 && head_dim == 64) err = f(float{}, D64{});
  if (dtype_code == 0 && head_dim == 128) err = f(float{}, D128{});
  if (dtype_code == 1 && head_dim == 64) err = f(__nv_bfloat16{}, D64{});
  if (dtype_code == 1 && head_dim == 128) err = f(__nv_bfloat16{}, D128{});
  return static_cast<int>(err);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (q, k, v, dO and every output but
// lse). head_dim: 64 or 128. lse and delta are float32 [B*H, T]. Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// dtype or head dim it does not take).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int t, int head_dim,
                         float scale, int causal, int window, int q_offset,
                         int dtype_code, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype_code, head_dim, [&](auto tag, auto dim) {
    return fwd<decltype(tag), decltype(dim)::value>(
        q, k, v, out, lse, bh, t, scale, causal, window, q_offset, s);
  });
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int t,
                            int head_dim, float scale, int causal, int window,
                            int q_offset, int dtype_code, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype_code, head_dim, [&](auto tag, auto dim) {
    return bwd_dq<decltype(tag), decltype(dim)::value>(
        q, k, v, dout, lse, delta, dq, bh, t, scale, causal, window,
        q_offset, s);
  });
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int t, int head_dim, float scale, int causal,
                             int window, int q_offset, int dtype_code,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype_code, head_dim, [&](auto tag, auto dim) {
    return bwd_dkv<decltype(tag), decltype(dim)::value>(
        q, k, v, dout, lse, delta, dk, dv, bh, t, scale, causal, window,
        q_offset, s);
  });
}
