// Block-N:M sparse matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/nm_spmm/kernel.py
// (nm_spmm_pallas):   y[:, j*bo:(j+1)*bo] = sum_t x[:, idx[j,t]*bk : +bk] @ wc[j,t]
// with x [B,K], wc [J,T,bk,bo], idx [J,T] int32, y [B, J*bo]; f32 or bf16
// in and out, f32 accumulation. The gather kernel also takes the per-row
// compact delta of the serving path (src/repro/kernels/nm_spmm/ops.py,
// nm_spmm_deltas; jnp in the reference) and adds
//     sum_t x[s, idx[j,t]] * delta[s, j, t]        delta [B, J, T, 1, 1]
// to row s of y in the same launch.
//
// Two kernels, chosen by the wrapper (kernel.launch_config):
//
// nm_spmm_ell: the element-granular layout bk = bo = 1 that every SNN path
// runs (paper spec: T = 104 of K = 512 kept per output neuron), K a
// multiple of 4.
// What bounds it: the base product is 2*B*J*T flops on a few MB (x, wc, idx,
// y), 0.0016 ms at the card's f32 FMA rate for B = 1024, J = 512; what sets
// the pace of a plain gather is the shared-memory traffic of the gather and
// filling 132 SMs when B is 16. With the delta the function reads 4*B*J*T
// bytes once (218 MB at B = 1024), 0.065 ms at 3.35 TB/s: it is
// bandwidth-bound, and its loads have to be coalesced and in flight.
// Design:
// * A block owns BM rows (a power of two) and BN output columns. It stages
//   its rows of x into shared memory K-major, x_s[k][BM] in f32 (converted
//   once): each thread loads a 4 x 4 sub-block with four 16-byte (f32) or
//   8-byte (bf16) row loads, transposes it in registers and stores four
//   16-byte rows of x_s. Indices are shifts and masks, no divides.
// * Four lanes share the rows and the column of a column group member: lane
//   (q, rl) computes rows 4 rl .. 4 rl + 3 (one 16-byte shared load of
//   x_s[idx[j,t]][rows] feeds 4 FMAs) over the t-chunks c = t / 4 with
//   c % 4 == q, and the four partial sums meet in a fixed butterfly (two
//   shuffles). idx[j, 4c..4c+3] and wc[j, 4c..4c+3] are read as one vector
//   each, the same address for the RL = BM / 4 lanes of one q (a
//   broadcast), so a kept connection costs a quarter of those two loads and
//   one shared load per 4 FMAs; those lanes read consecutive words of one
//   x_s row, without bank conflicts.
// * The wrapper picks BM (4 to 32 rows), BN and the threads: every block
//   stages its x rows once for all its BN columns, so BN is as wide as
//   leaves one block on all but a few SMs: 32 rows and 128 columns a block
//   at B = 1024, 16 rows and 4 columns at B = 16 (128 blocks each). On the
//   card a grid of 256 narrower blocks was slower at both sizes: staging x
//   twice as often costs more than four idle SMs. With one block an SM, the
//   base product at large B needs 1024 threads to hide its load latency;
//   the fused kernel (bandwidth-bound, 16 loads of 16 bytes in flight a
//   lane) and small B run best with 256. Loads are batched so that many are
//   in flight: the staging issues four 4 x 4 sub-blocks' loads before it
//   stores them, the t-loop four chunks' idx, wc and delta loads (two at
//   1024 threads, for registers) before it computes on them. ptxas decides
//   how many stay in flight: this source's build gives the fused kernel 182
//   registers and all of them, 0.101 ms at the serving shape; a build
//   without the scalar branch for T % 4 != 0 got 138 registers, sank loads
//   into the FMA loop and took 0.144 ms, side by side on one H100 (a
//   compiler barrier between the loads and the FMAs did not change it).
// * The delta: lane (q, rl) loads delta[s, j, 4c..4c+3] of its 4 rows as
//   16-byte loads, so one warp instruction reads 64 contiguous bytes of each
//   (row, column)'s delta; it multiplies them with the same gathered x value
//   and keeps the sum in a second f32 accumulator, and y = acc_base +
//   acc_delta, the plain path's association nm_spmm(...) +
//   nm_spmm_deltas(...). Each delta element is read once.
// * A row's association depends on T alone (its t-chunks in order in four
//   lanes, then the butterfly), whatever B is and wherever the row falls in
//   a block: a row computed alone equals the same row
//   computed in a batch, bit for bit. No atomics: each output is written
//   once, the block's tile transposed through shared memory so that the
//   stores run along rows.
// * A kept-block id outside [0, K) traps (the launch's stream then fails with
//   an error): a corrupt topology is a fault, never a dropped contribution.
//
// nm_spmm_kernel: any bk, bo (the tiled specs; no ported path runs them),
// the plain design of the first port, kept as it was:
// * A block owns BM = ROWS*RY rows and one column group of BN output columns:
//   either JG whole out tiles (bo <= BN) or a BN-wide slice of one tile.
// * It stages its rows of x ([BM, K], the gather source), its slice of idx
//   ([T, JG]) and of wc ([T*bk, BN], transposed so neighbouring threads read
//   neighbouring words) into shared memory.
// * Thread (tx, ty) computes column tx for ROWS rows, walking the T kept
//   blocks and bk rows of each, accumulating in f32 registers; for bk, bo >=
//   16 the threads of a warp share one kept block, so the x reads broadcast.
// * Ragged rows (B % BM) and ragged tiles (J % JG) are masked in the kernel;
//   nothing is padded on the host.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;   // rows per thread
constexpr int RY = 4;     // thread rows per block
constexpr int BM = ROWS * RY;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__global__ void nm_spmm_kernel(const T* __restrict__ x, const T* __restrict__ wc,
                               const int* __restrict__ idx, T* __restrict__ y,
                               int B, int K, int J, int Tk, int bk, int bo,
                               int BN, int JG, int BNc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* x_s = reinterpret_cast<T*>(smem);                                   // [BM][K]
  T* w_s = reinterpret_cast<T*>(smem + align16(sizeof(T) * BM * K));     // [Tk*bk][BN]
  int* i_s = reinterpret_cast<int*>(
      smem + align16(sizeof(T) * BM * K) + align16(sizeof(T) * Tk * bk * BN));  // [Tk][JG]

  const int N = J * bo;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int j0 = n0 / bo, c0 = n0 % bo;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const T zero = from_f<T>(0.f);

  for (int e = tid; e < BM * K; e += nthr) {
    const int r = e / K, k = e - r * K;
    const int gr = row0 + r;
    x_s[e] = gr < B ? x[(size_t)gr * K + k] : zero;
  }
  for (int e = tid; e < Tk * JG; e += nthr) {
    const int t = e / JG, jl = e - t * JG;
    const int j = j0 + jl;
    i_s[e] = j < J ? idx[(size_t)j * Tk + t] : 0;
  }
  // walk wc[j0 : j0+JG, :, :, c0 : c0+BNc] in its global (contiguous) order
  const int per_tile = Tk * bk * BNc;
  for (int e = tid; e < JG * per_tile; e += nthr) {
    const int c = e % BNc;
    int r = e / BNc;
    const int kk = r % bk;
    r /= bk;
    const int t = r % Tk;
    const int jl = r / Tk;
    const int j = j0 + jl;
    w_s[(t * bk + kk) * BN + jl * BNc + c] =
        j < J ? wc[(((size_t)j * Tk + t) * bk + kk) * bo + c0 + c] : zero;
  }
  __syncthreads();

  const int col = threadIdx.x;
  const int jl = col / BNc;
  if (col >= BN || j0 + jl >= J) return;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  const T* xr = x_s + threadIdx.y * ROWS * K;
  for (int t = 0; t < Tk; ++t) {
    const int kb = i_s[t * JG + jl] * bk;
    if (kb < 0 || kb > K - bk) __trap();   // corrupt topology: a fault
    const T* wt = w_s + t * bk * BN + col;
    for (int kk = 0; kk < bk; ++kk) {
      const float w = to_f(wt[kk * BN]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += to_f(xr[r * K + kb + kk]) * w;
    }
  }
  const int n = n0 + col;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gr = row0 + threadIdx.y * ROWS + r;
    if (gr < B) y[(size_t)gr * N + n] = from_f<T>(acc[r]);
  }
}

template <typename T>
int launch(const void* x, const void* wc, const int* idx, void* y, int B, int K,
           int J, int Tk, int bk, int bo, int BN, int JG, int BNc, int ngroups,
           int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nm_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ngroups, (B + BM - 1) / BM);
  dim3 block(BN, RY);
  nm_spmm_kernel<T><<<grid, block, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), idx, static_cast<T*>(y),
      B, K, J, Tk, bk, bo, BN, JG, BNc);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bk = bo = 1: the K-major gather, with the optional per-row delta
// ---------------------------------------------------------------------------

constexpr int ELL_NT_NARROW = 256;   // threads per block: the fused kernel, small B
constexpr int ELL_NT_WIDE = 1024;    // threads per block: the base product at large B
constexpr int ELL_R = 4;      // rows a lane computes
constexpr int ELL_TS = 4;     // lanes sharing a (rows, column): interleaved t-chunks

// Four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// One kept connection (column j, input kb) for the lane's 4 rows: the base
// term w and, when fused, each row's delta term d[i].
template <bool FUSED>
__device__ __forceinline__ void ell_step(float* ab, float* ad, const float* x_s, int kb, int K,
                                         int BM, int rl, float w, const float* d) {
  if ((unsigned)kb >= (unsigned)K) __trap();   // corrupt topology: a fault
  const float4 xv = *reinterpret_cast<const float4*>(x_s + kb * BM + rl);
  const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int i = 0; i < ELL_R; ++i) {
    ab[i] = fmaf(xr[i], w, ab[i]);
    if constexpr (FUSED) ad[i] = fmaf(xr[i], d[i], ad[i]);
  }
}

template <typename T, bool FUSED, int NT>
__global__ void __launch_bounds__(NT)
nm_spmm_ell(const T* __restrict__ x, const T* __restrict__ wc, const int* __restrict__ idx,
            const T* __restrict__ delta, long long d_sb, T* __restrict__ y, int B, int K,
            int J, int Tk, int bm_bits, int bn_bits) {
  extern __shared__ __align__(16) float smem_f[];
  const int BM = 1 << bm_bits, BN = 1 << bn_bits;
  float* x_s = smem_f;                       // [K][BM]
  float* y_s = smem_f + K * BM;              // [BM][BN + 1]
  const int row0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // stage x[row0 : row0 + BM, :] K-major, 4 rows x 4 columns a sub-block,
  // four sub-blocks' loads in flight a thread before their stores
  {
    const int rb_bits = bm_bits - 2, nrb = 1 << rb_bits;
    const int n = nrb * (K >> 2);
    for (int e0 = tid; e0 < n; e0 += 4 * NT) {
      float4 v[4][4];
#pragma unroll
      for (int sb = 0; sb < 4; ++sb) {
        const int e = e0 + sb * NT;
        const int r = (e & (nrb - 1)) << 2, k = (e >> rb_bits) << 2;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gr = row0 + r + i;
          v[sb][i] = e < n && gr < B ? ld4(x + (size_t)gr * K + k)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int sb = 0; sb < 4; ++sb) {
        const int e = e0 + sb * NT;
        if (e >= n) break;
        const int r = (e & (nrb - 1)) << 2, k = (e >> rb_bits) << 2;
        float* dst = x_s + k * BM + r;
        const float4* w = v[sb];
        *reinterpret_cast<float4*>(dst) = make_float4(w[0].x, w[1].x, w[2].x, w[3].x);
        *reinterpret_cast<float4*>(dst + BM) = make_float4(w[0].y, w[1].y, w[2].y, w[3].y);
        *reinterpret_cast<float4*>(dst + 2 * BM) = make_float4(w[0].z, w[1].z, w[2].z, w[3].z);
        *reinterpret_cast<float4*>(dst + 3 * BM) = make_float4(w[0].w, w[1].w, w[2].w, w[3].w);
      }
    }
  }
  __syncthreads();

  // A column group is ELL_TS x RL lanes (RL = BM / 4 <= 8): lane (q, rl)
  // owns rows 4 rl .. 4 rl + 3 and the t-chunks c = t / 4 with c % ELL_TS ==
  // q, in order; the ELL_TS partial sums meet in a fixed butterfly. So one
  // warp instruction reads 4 x 16 contiguous bytes of each (row, column)'s
  // delta, and a row's association depends on T alone.
  const int rl_bits = bm_bits - 2, RL = 1 << rl_bits;
  const int lane_in_grp = tid & ((ELL_TS << rl_bits) - 1);
  const int rl = (lane_in_grp & (RL - 1)) * ELL_R, q = lane_in_grp >> rl_bits;
  const int grp = tid >> (rl_bits + 2), ngrp = NT >> (rl_bits + 2);
  const int nchunks = (Tk + 3) >> 2;
  for (int jb = 0; jb < BN; jb += ngrp) {      // passes: the same count for every lane
    const int jl = jb + grp, j = j0 + jl;
    const bool live = jl < BN && j < J;
    float ab[ELL_R], ad[ELL_R];
#pragma unroll
    for (int i = 0; i < ELL_R; ++i) ab[i] = ad[i] = 0.f;
    if (live) {
      const int* ij = idx + (size_t)j * Tk;
      const T* wj = wc + (size_t)j * Tk;
      const T* dj[ELL_R];
      bool rv[ELL_R];
#pragma unroll
      for (int i = 0; i < ELL_R; ++i) {
        rv[i] = row0 + rl + i < B;
        dj[i] = FUSED ? delta + (long long)(rv[i] ? row0 + rl + i : 0) * d_sb + (size_t)j * Tk
                      : nullptr;
      }
      if ((Tk & 3) == 0) {
        // U chunks' idx, wc and delta loads in flight, then their FMAs: 4, but
        // 2 at 1024 threads a block, where a thread has 64 registers (4 spill)
        constexpr int U = NT >= 1024 ? 2 : 4;
        for (int c0 = q; c0 < nchunks; c0 += U * ELL_TS) {
          int4 iv[U];
          float4 wv[U], dv[U][ELL_R];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + u * ELL_TS;
            if (c < nchunks) {
              iv[u] = __ldg(reinterpret_cast<const int4*>(ij + (c << 2)));
              wv[u] = ld4(wj + (c << 2));
              if constexpr (FUSED) {
#pragma unroll
                for (int i = 0; i < ELL_R; ++i)
                  dv[u][i] = rv[i] ? ld4(dj[i] + (c << 2)) : make_float4(0.f, 0.f, 0.f, 0.f);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (c0 + u * ELL_TS >= nchunks) break;
            const int kbs[4] = {iv[u].x, iv[u].y, iv[u].z, iv[u].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float d[ELL_R];
              if constexpr (FUSED) {
#pragma unroll
                for (int i = 0; i < ELL_R; ++i) d[i] = comp(dv[u][i], e);
              }
              ell_step<FUSED>(ab, ad, x_s, kbs[e], K, BM, rl, comp(wv[u], e), d);
            }
          }
        }
      } else {               // T not a multiple of 4: the same chunks, scalar loads
        for (int c = q; c < nchunks; c += ELL_TS) {
          for (int t = c << 2; t < min(Tk, (c << 2) + 4); ++t) {
            float d[ELL_R];
            if constexpr (FUSED) {
#pragma unroll
              for (int i = 0; i < ELL_R; ++i) d[i] = rv[i] ? to_f(dj[i][t]) : 0.f;
            }
            ell_step<FUSED>(ab, ad, x_s, __ldg(ij + t), K, BM, rl, to_f(wj[t]), d);
          }
        }
      }
    }
    // (q0 + q1) + (q2 + q3), the same on every lane of the quad
#pragma unroll
    for (int i = 0; i < ELL_R; ++i) {
#pragma unroll
      for (int m = 1; m < ELL_TS; m <<= 1) {
        ab[i] += __shfl_xor_sync(0xffffffffu, ab[i], m << rl_bits);
        if constexpr (FUSED) ad[i] += __shfl_xor_sync(0xffffffffu, ad[i], m << rl_bits);
      }
    }
    if (live && q == 0) {
#pragma unroll
      for (int i = 0; i < ELL_R; ++i)
        y_s[(rl + i) * (BN + 1) + jl] = FUSED ? ab[i] + ad[i] : ab[i];
    }
  }
  __syncthreads();

  // the block's [BM, BN] tile of y, along rows
  for (int e = tid; e < (BM << bn_bits); e += NT) {
    const int r = e >> bn_bits, c = e & (BN - 1);
    const int gr = row0 + r, j = j0 + c;
    if (gr < B && j < J) y[(size_t)gr * J + j] = from_f<T>(y_s[r * (BN + 1) + c]);
  }
}

template <typename T, bool FUSED, int NT>
int launch_ell(const void* x, const void* wc, const int* idx, const void* delta, long long d_sb,
               void* y, int B, int K, int J, int Tk, int bm_bits, int bn_bits, int smem_bytes,
               cudaStream_t stream) {
  auto kernel = nm_spmm_ell<T, FUSED, NT>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int BM = 1 << bm_bits, BN = 1 << bn_bits;
  dim3 grid((J + BN - 1) / BN, (B + BM - 1) / BM);
  kernel<<<grid, NT, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), idx, static_cast<const T*>(delta),
      d_sb, static_cast<T*>(y), B, K, J, Tk, bm_bits, bn_bits);
  return (int)cudaGetLastError();
}

// The fused kernel runs with ELL_NT_NARROW threads; the base product with
// ELL_NT_WIDE or ELL_NT_NARROW, as the wrapper asks.
template <typename T>
int launch_ell_t(const void* x, const void* wc, const int* idx, const void* delta,
                 long long d_sb, void* y, int B, int K, int J, int Tk, int bm_bits,
                 int bn_bits, int threads, int smem_bytes, cudaStream_t s) {
  if (delta && threads == ELL_NT_NARROW)
    return launch_ell<T, true, ELL_NT_NARROW>(x, wc, idx, delta, d_sb, y, B, K, J, Tk, bm_bits,
                                              bn_bits, smem_bytes, s);
  if (!delta && threads == ELL_NT_NARROW)
    return launch_ell<T, false, ELL_NT_NARROW>(x, wc, idx, delta, d_sb, y, B, K, J, Tk, bm_bits,
                                               bn_bits, smem_bytes, s);
  if (!delta && threads == ELL_NT_WIDE)
    return launch_ell<T, false, ELL_NT_WIDE>(x, wc, idx, delta, d_sb, y, B, K, J, Tk, bm_bits,
                                             bn_bits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows per block of the tiled kernel; the wrapper sizes shared memory with it.
int nm_spmm_block_rows() { return BM; }

// Any bk, bo (nm_spmm_kernel). dtype: 0 = float32, 1 = bfloat16. Returns
// the cudaError_t of the launch.
int nm_spmm_launch(const void* x, const void* wc, const void* idx, void* y,
                   int B, int K, int J, int Tk, int bk, int bo, int BN, int JG,
                   int BNc, int ngroups, int smem_bytes, int dtype, void* stream) {
  if (B == 0 || J == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch<float>(x, wc, ix, y, B, K, J, Tk, bk, bo, BN, JG, BNc, ngroups,
                         smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wc, ix, y, B, K, J, Tk, bk, bo, BN, JG, BNc,
                                 ngroups, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// Geometry of the bk = bo = 1 kernel, for the wrapper to check: {threads
// per block (narrow, wide), rows a lane, lanes sharing a column's t-chunks}.
void nm_spmm_ell_geometry(int* out) {
  out[0] = ELL_NT_NARROW; out[1] = ELL_NT_WIDE; out[2] = ELL_R; out[3] = ELL_TS;
}

// bk = bo = 1 (nm_spmm_ell): y [B, J] from x [B, K], wc [J, T], idx [J, T]
// and, when delta is not null, delta [B, J, T] of x's dtype, its rows d_sb
// elements apart (each row's [J, T] contiguous); K a multiple of 4. 2^bm_bits rows a block (4
// to 32) and 2^bn_bits columns, `threads` a block (ELL_NT_NARROW, or
// ELL_NT_WIDE without delta); K a multiple of 4 and every operand 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch.
int nm_spmm_ell_launch(const void* x, const void* wc, const void* idx, const void* delta,
                       long long d_sb, void* y, int B, int K, int J, int Tk, int bm_bits,
                       int bn_bits, int threads, int smem_bytes, int dtype, void* stream) {
  if (bm_bits < 2 || bm_bits > 5 || K % 4) return (int)cudaErrorInvalidValue;
  if (B == 0 || J == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch_ell_t<float>(x, wc, ix, delta, d_sb, y, B, K, J, Tk, bm_bits, bn_bits,
                               threads, smem_bytes, s);
  if (dtype == 1)
    return launch_ell_t<__nv_bfloat16>(x, wc, ix, delta, d_sb, y, B, K, J, Tk, bm_bits,
                                       bn_bits, threads, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
