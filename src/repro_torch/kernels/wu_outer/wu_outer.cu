// Gated three-factor compact weight update for Hopper (sm_90a), plain C
// interface for ctypes. Three kernels, chosen by the wrapper (kernel.py):
//
//   wu_outer_gather  batch-summed, bk = bo = 1 (every SNN spec: the training
//                    path), the add into the compact weights fused in;
//   wu_outer_kernel  batch-summed, any bk, bo (the tiled specs), the add
//                    fused in likewise;
//   wu_outer_slots   per slot, in place (the serving path).
//
// The batch-summed kernels replace the Pallas kernel
// src/repro/kernels/wu_outer/kernel.py (wu_outer_pallas):
//     dw[j, t] = scale * pre[:, idx[j,t]*bk : +bk]^T @ mod[:, j*bo : +bo]
// with pre [B,K], mod [B,N] (N = J*bo), idx [J,T] int32, scale a one-element
// device tensor (lr x gate: the counterpart of the Pallas SMEM operand, so
// the gate never goes to the host), dw [J,T,bk,bo]; f32 or bf16 in and out,
// f32 accumulation. Given wc [J,T,bk,bo] they write wc + dw instead, into a
// fresh tensor, rounded as the plain `wc + dw` rounds it: the product
// scale*acc rounded to the dtype, then the add (__fmul_rn / __fadd_rn, so
// nvcc cannot contract the two into one FMA).
//
// wu_outer_slots serves the reference's jnp per-slot update
// (src/repro/kernels/wu_outer/ref.py, wu_outer_slots; no Pallas kernel) and
// the add after it, in place:
//     delta[s, j, t, kk, c] += (scale[s] * pre[s, idx[j,t]*bk + kk]) * mod[s, j*bo + c]
// f32 only (the serving path's dtype), delta [S, J, T, bk, bo] with each
// slot's block contiguous and the slots slot_stride elements apart (one
// layer of the engine's slot-leading [S, L, ...] deltas).
//
// What bounds them:
// * Batch-summed, at the training shape (B = 16, K = N = 512, T = 104, bk =
//   bo = 1): the function moves ~0.49 MB (pre and mod 32 KB each, idx and dw
//   213 KB each; 0.70 MB with wc read) and does 1.7 MFLOP, a floor of
//   ~0.15-0.21 us of HBM time: a launch-latency kernel. What it costs is the
//   chain of dependent loads (idx, then the gathered pre) and the launch.
// * Per slot, at the serving shape (S = 1024, J = 512, T = 104): each open
//   slot's delta is read and written once, 2 x 213 KB, ~0.44 GB with every
//   slot open, 0.131 ms at 3.35 TB/s; pre, mod and idx add ~4.4 MB. A
//   byte-bound stream; closed slots cost nothing.
//
// Design:
// * wu_outer_gather: one warp owns an output neuron j, its lanes on t (lane
//   l takes t = l, l + 32, ...; G_TPL of them in one pass, more passes for T
//   > 32 G_TPL), G_WARPS neurons a block. A lane issues its idx (and wc)
//   loads, then the block stages BC rows of pre (all of them at B = 16: 32
//   KB) in shared memory with 16-byte loads, G_SU of them in flight a thread
//   (a loop that stores each vector before it loads the next waits one
//   memory latency per vector), and its mod columns, behind one barrier; the sum over b then reads pre[b, idx[j,t]] and the warp's
//   broadcast mod[b, j] from shared memory, f32 in registers, in batch
//   order. No 64-bit division. Why stage: gathering straight from L1/L2
//   was slower on the card than the staged kernel it replaced, in every
//   block shape tried: a warp's gather touches up to 32 cache lines, so L1
//   serves it in up to 32 wavefronts, and a lane makes 64 such loads at B
//   = 16; a gather from shared memory costs a few bank conflicts instead. The closed gate (scale == 0) writes wc unchanged (or zeros)
//   without reading pre or mod.
// * wu_outer_kernel (any bk, bo; the first port's design, kept): output
//   elements are cut into contiguous ranges of EB = NT*R; a block stages
//   chunks of BC batch rows of pre (full rows: the gather source) and its
//   mod columns in shared memory, then every thread accumulates its R
//   outputs over the chunk in f32 registers. The last chunk is ragged and
//   masked: no row padding (the Pallas kernel's b % bb == 0 was a TPU tile
//   artefact). For bk, bo >= 16 a warp shares one kk, so its pre reads
//   broadcast and its mod reads are consecutive.
// * wu_outer_slots: grid (chunks of a slot, slots). A block reads its
//   slot's scale first and returns at once when it is 0: a closed slot's
//   delta is neither read nor written. A thread takes SLOT_U vectors of VEC
//   consecutive delta elements (VEC = 4 where a row of T*bk*bo elements is a
//   multiple of 4 and everything is 16-byte aligned: 16-byte loads and
//   stores, neighbouring lanes on neighbouring t; else VEC = 1), issues all
//   its delta and idx loads before the gathers and all of those before the
//   stores. At bk = bo = 1 one 16-byte load brings idx[j, t..t+3] and the
//   lane reads mod[s, j] once for its four t (one address for a row's
//   lanes). Every element is computed in the reference's association with
//   three explicit roundings, d + ((scale*p)*m) via __fmul_rn, __fmul_rn,
//   __fadd_rn, so it equals the plain `delta + ref.wu_outer_slots(...)` bit
//   for bit at every coordinate. The one bit-level difference: the plain
//   version computes d + 0*(...) on a closed slot, which may turn a -0 delta
//   into +0; the kernel leaves -0 as it is (torch.equal holds either way,
//   given finite mod). No atomics: each element is written once, by one
//   thread.
// * A kept-block id outside [0, K/bk) traps (the launch's stream then fails
//   with an error), so a corrupt topology shows as a fault, never as a
//   silent zero update at the synapses it names.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // wu_outer_kernel: threads per block
constexpr int R = 2;          // wu_outer_kernel: output elements per thread
constexpr int EB = NT * R;
constexpr int G_WARPS = 4;    // wu_outer_gather: output neurons (warps) per block
constexpr int G_TPL = 4;      // wu_outer_gather: t positions a lane takes per pass
constexpr int G_SU = 16;      // wu_outer_gather: staging loads a thread has in flight
constexpr int SLOT_NT = 256;  // wu_outer_slots: threads per block
constexpr int SLOT_U = 2;     // wu_outer_slots: vectors per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The update's last step: dw = scale*acc rounded to T, or (with_wc) w + dw
// with the product and the add rounded apart, as the plain
// `wc + scale * acc` does.
template <typename T>
__device__ __forceinline__ T finish(float scale, float acc, bool with_wc, T w) {
  const T dw = from_f<T>(__fmul_rn(scale, acc));
  if (!with_wc) return dw;
  return from_f<T>(__fadd_rn(to_f(w), to_f(dw)));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__global__ void __launch_bounds__(NT)
wu_outer_kernel(const T* __restrict__ pre, const T* __restrict__ mod,
                const int* __restrict__ idx, const T* __restrict__ scale_p,
                const T* __restrict__ wc, T* __restrict__ out, int B, int K,
                int J, int Tk, int bk, int bo, int BC, int MW) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* pre_s = reinterpret_cast<T*>(smem);                                  // [BC][K]
  T* mod_s = reinterpret_cast<T*>(smem + align16(sizeof(T) * BC * K));    // [BC][MW]

  const long long total = (long long)J * Tk * bk * bo;
  const long long e0 = (long long)blockIdx.x * EB;
  const int N = J * bo;
  const long long per_tile = (long long)Tk * bk * bo;
  const int m0 = (int)(e0 / per_tile) * bo;          // first mod column staged
  const int mw = min(MW, N - m0);
  const float scale = to_f(scale_p[0]);

  long long e[R];
  int kcol[R], mcol[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    e[r] = e0 + threadIdx.x + (long long)r * NT;
    kcol[r] = -1;
    mcol[r] = 0;
    if (e[r] < total) {
      const int c = (int)(e[r] % bo);
      long long q = e[r] / bo;
      const int kk = (int)(q % bk);
      q /= bk;                                       // q = j*T + t
      const int j = (int)(q / Tk);
      const int kb = idx[q] * bk;
      if (kb < 0 || kb > K - bk) __trap();           // corrupt topology: a fault
      kcol[r] = kb + kk;
      mcol[r] = j * bo + c - m0;
    }
  }

  if (scale == 0.f) {                                // gate closed: skip the WU
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (e[r] < total) out[e[r]] = wc == nullptr ? from_f<T>(0.f) : wc[e[r]];
    return;
  }

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int b0 = 0; b0 < B; b0 += BC) {
    const int nb = min(BC, B - b0);
    __syncthreads();                                 // the previous chunk is read
    for (int i = threadIdx.x; i < nb * K; i += NT)
      pre_s[i] = pre[(size_t)b0 * K + i];
    for (int i = threadIdx.x; i < nb * mw; i += NT) {
      const int b = i / mw, c = i - b * mw;
      mod_s[b * MW + c] = mod[(size_t)(b0 + b) * N + m0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kcol[r] < 0) continue;
      float a = acc[r];
      for (int b = 0; b < nb; ++b)
        a += to_f(pre_s[b * K + kcol[r]]) * to_f(mod_s[b * MW + mcol[r]]);
      acc[r] = a;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    if (e[r] < total)
      out[e[r]] = finish(scale, acc[r], wc != nullptr,
                         wc == nullptr ? from_f<T>(0.f) : wc[e[r]]);
}

// Four consecutive elements of pre as f32 (16 or 8 bytes, aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
  return make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
}

// Stage rows [b0, b0 + nb) of pre (f32 in shared memory) and the block's
// mod columns. Vector loads where K % 4 == 0 and pre is aligned, G_SU of
// them issued before their stores, so that a thread waits on one memory
// latency per G_SU vectors, not one per vector.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ pre,
                                           const T* __restrict__ mod, float* pre_s,
                                           float* mod_s, int b0, int nb, int K, int J,
                                           int j0) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const T* src = pre + (size_t)b0 * K;
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(pre) & 15) == 0) {
    const int n4 = nb * K / 4;
    for (int i0 = tid; i0 < n4; i0 += G_SU * nthr) {
      float4 v[G_SU];
#pragma unroll
      for (int u = 0; u < G_SU; ++u) {
        const int i = i0 + u * nthr;
        if (i < n4) v[u] = load4(src + 4 * i);
      }
#pragma unroll
      for (int u = 0; u < G_SU; ++u) {
        const int i = i0 + u * nthr;
        if (i < n4) reinterpret_cast<float4*>(pre_s)[i] = v[u];
      }
    }
  } else {
    for (int i = tid; i < nb * K; i += nthr) pre_s[i] = to_f(src[i]);
  }
  for (int i = tid; i < nb * G_WARPS; i += nthr) {
    const int b = i / G_WARPS, w = i - b * G_WARPS;
    mod_s[i] = j0 + w < J ? to_f(mod[(size_t)(b0 + b) * J + j0 + w]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * G_WARPS)
wu_outer_gather(const T* __restrict__ pre, const T* __restrict__ mod,
                const int* __restrict__ idx, const T* __restrict__ scale_p,
                const T* __restrict__ wc, T* __restrict__ out, int B, int K,
                int J, int Tk, int BC) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pre_s = reinterpret_cast<float*>(smem);                          // [BC][K]
  float* mod_s = reinterpret_cast<float*>(smem + align16(sizeof(float) * BC * K));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * G_WARPS;
  const int j = j0 + warp;
  const bool live = j < J;              // a warp past J still takes the barriers
  const float scale = to_f(scale_p[0]);
  const long long row = (long long)j * Tk;
  int staged = -1;                      // first row of the chunk in shared memory
  for (int t0 = 0; t0 < Tk; t0 += 32 * G_TPL) {
    // idx and wc first: their loads are in flight while pre is staged
    int kc[G_TPL];
    T w[G_TPL];
#pragma unroll
    for (int i = 0; i < G_TPL; ++i) {
      const int t = t0 + lane + 32 * i;
      const bool in = live && t < Tk;
      kc[i] = in ? idx[row + t] : 0;
      w[i] = wc != nullptr && in ? wc[row + t] : from_f<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < G_TPL; ++i)
      if (kc[i] < 0 || kc[i] >= K) __trap();           // corrupt topology: a fault
    if (scale == 0.f) {                 // gate closed (the whole block): skip the WU
#pragma unroll
      for (int i = 0; i < G_TPL; ++i) {
        const int t = t0 + lane + 32 * i;
        if (live && t < Tk) out[row + t] = w[i];
      }
      continue;
    }
    float acc[G_TPL];
#pragma unroll
    for (int i = 0; i < G_TPL; ++i) acc[i] = 0.f;
    for (int b0 = 0; b0 < B; b0 += BC) {
      const int nb = min(BC, B - b0);
      if (b0 != staged) {               // block-uniform: every warp takes it
        if (staged >= 0) __syncthreads();            // the last chunk is read
        stage_rows(pre, mod, pre_s, mod_s, b0, nb, K, J, j0);
        __syncthreads();
        staged = b0;
      }
#pragma unroll 4
      for (int b = 0; b < nb; ++b) {
        const float m = mod_s[b * G_WARPS + warp];
        const float* p = pre_s + b * K;
#pragma unroll
        for (int i = 0; i < G_TPL; ++i) acc[i] = fmaf(p[kc[i]], m, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < G_TPL; ++i) {
      const int t = t0 + lane + 32 * i;
      if (live && t < Tk) out[row + t] = finish(scale, acc[i], wc != nullptr, w[i]);
    }
  }
}

// delta[s, j, t, kk, c] += (scale[s] * pre[s, kb*bk + kk]) * mod[s, j*bo + c],
// kb = idx[j, t]; VEC consecutive elements of a row (of Tk*bk*bo) a vector.
template <int VEC, bool UNIT>
__global__ void __launch_bounds__(SLOT_NT)
wu_outer_slots(float* __restrict__ delta, long long slot_stride,
               const float* __restrict__ pre, const float* __restrict__ mod,
               const int* __restrict__ idx, const float* __restrict__ scale,
               int S, int K, int J, int Tk, int bk, int bo) {
  const int row_len = Tk * bk * bo;                  // elements of one j's block
  const int vpr = row_len / VEC;                     // vectors per row
  const int nvec = J * vpr;                          // vectors per slot
  const int q0 = blockIdx.x * (SLOT_NT * SLOT_U) + threadIdx.x;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float sc = scale[s];
    if (sc == 0.f) continue;                         // closed: not read, not written
    const float* pre_s = pre + (size_t)s * K;
    const float* mod_s = mod + (size_t)s * J * bo;
    float* d_s = delta + s * slot_stride;

    float d[SLOT_U][VEC], p[SLOT_U][VEC], m[SLOT_U][VEC];
    int kc[SLOT_U][VEC];
    long long off[SLOT_U];
#pragma unroll
    for (int u = 0; u < SLOT_U; ++u) {
      const int q = q0 + u * SLOT_NT;
      off[u] = -1;
      if (q >= nvec) continue;
      const int j = q / vpr;
      const int e0 = (q - j * vpr) * VEC;            // first element within row j
      off[u] = (long long)j * row_len + e0;
      if constexpr (VEC == 4) {
        const float4 dv = *reinterpret_cast<const float4*>(d_s + off[u]);
        d[u][0] = dv.x; d[u][1] = dv.y; d[u][2] = dv.z; d[u][3] = dv.w;
      } else {
        d[u][0] = d_s[off[u]];
      }
      if constexpr (UNIT) {                          // e0 is t; one mod per row
        if constexpr (VEC == 4) {
          const int4 iv = *reinterpret_cast<const int4*>(idx + (size_t)j * Tk + e0);
          kc[u][0] = iv.x; kc[u][1] = iv.y; kc[u][2] = iv.z; kc[u][3] = iv.w;
        } else {
          kc[u][0] = idx[(size_t)j * Tk + e0];
        }
        const float mj = mod_s[j];
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[u][i] = mj;
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int e = e0 + i;
          const int t = e / (bk * bo), kk = (e / bo) % bk, c = e % bo;
          const int kb = idx[(size_t)j * Tk + t] * bk;
          if (kb < 0 || kb > K - bk) __trap();       // corrupt topology: a fault
          kc[u][i] = kb + kk;
          m[u][i] = mod_s[j * bo + c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SLOT_U; ++u) {
      if (off[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (UNIT && (kc[u][i] < 0 || kc[u][i] >= K)) __trap();   // corrupt topology
        p[u][i] = pre_s[kc[u][i]];
      }
    }
#pragma unroll
    for (int u = 0; u < SLOT_U; ++u) {
      if (off[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        d[u][i] = __fadd_rn(d[u][i], __fmul_rn(__fmul_rn(sc, p[u][i]), m[u][i]));
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(d_s + off[u]) =
            make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
      } else {
        d_s[off[u]] = d[u][0];
      }
    }
  }
}

template <typename T>
int launch(const void* pre, const void* mod, const int* idx, const void* scale,
           const void* wc, void* out, int B, int K, int J, int Tk, int bk, int bo,
           int BC, int MW, int nblocks, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wu_outer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  wu_outer_kernel<T><<<nblocks, NT, smem_bytes, stream>>>(
      static_cast<const T*>(pre), static_cast<const T*>(mod), idx,
      static_cast<const T*>(scale), static_cast<const T*>(wc), static_cast<T*>(out),
      B, K, J, Tk, bk, bo, BC, MW);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const void* pre, const void* mod, const int* idx, const void* scale,
                  const void* wc, void* out, int B, int K, int J, int Tk, int BC,
                  int nblocks, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wu_outer_gather<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  wu_outer_gather<T><<<nblocks, 32 * G_WARPS, smem_bytes, stream>>>(
      static_cast<const T*>(pre), static_cast<const T*>(mod), idx,
      static_cast<const T*>(scale), static_cast<const T*>(wc), static_cast<T*>(out),
      B, K, J, Tk, BC);
  return (int)cudaGetLastError();
}

template <int VEC, bool UNIT>
int launch_slots(float* delta, long long slot_stride, const float* pre,
                 const float* mod, const int* idx, const float* scale, int S, int K,
                 int J, int Tk, int bk, int bo, int grid_x, int grid_y,
                 cudaStream_t stream) {
  wu_outer_slots<VEC, UNIT><<<dim3(grid_x, grid_y), SLOT_NT, 0, stream>>>(
      delta, slot_stride, pre, mod, idx, scale, S, K, J, Tk, bk, bo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry for the wrapper to check: {elements per block of wu_outer_kernel,
// warps per block and t positions per lane of wu_outer_gather, threads per
// block and vectors per thread of wu_outer_slots}.
void wu_outer_geometry(int* out) {
  out[0] = EB; out[1] = G_WARPS; out[2] = G_TPL; out[3] = SLOT_NT; out[4] = SLOT_U;
}

// Any bk, bo (wu_outer_kernel); wc may be null (write dw). dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int wu_outer_launch(const void* pre, const void* mod, const void* idx,
                    const void* scale, const void* wc, void* out, int B, int K,
                    int J, int Tk, int bk, int bo, int BC, int MW, int nblocks,
                    int smem_bytes, int dtype, void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch<float>(pre, mod, ix, scale, wc, out, B, K, J, Tk, bk, bo, BC, MW,
                         nblocks, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pre, mod, ix, scale, wc, out, B, K, J, Tk, bk, bo,
                                 BC, MW, nblocks, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// bk = bo = 1 (wu_outer_gather): out [J, T] from pre [B, K], mod [B, J],
// idx [J, T]; wc may be null (write dw); BC batch rows staged per chunk.
// dtype as above.
int wu_outer_gather_launch(const void* pre, const void* mod, const void* idx,
                           const void* scale, const void* wc, void* out, int B,
                           int K, int J, int Tk, int BC, int nblocks, int smem_bytes,
                           int dtype, void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch_gather<float>(pre, mod, ix, scale, wc, out, B, K, J, Tk, BC, nblocks,
                                smem_bytes, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(pre, mod, ix, scale, wc, out, B, K, J, Tk, BC,
                                        nblocks, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// Per slot, in place (wu_outer_slots), f32: delta [S, J, T, bk, bo], slots
// slot_stride elements apart; pre [S, K], mod [S, J*bo], idx [J, T], scale
// [S]. vec 4 needs T*bk*bo % 4 == 0, delta, slot_stride and (bk = bo = 1)
// idx 16-byte aligned; else vec 1. Returns the cudaError_t of the launch.
int wu_outer_slots_launch(void* delta, long long slot_stride, const void* pre,
                          const void* mod, const void* idx, const void* scale,
                          int S, int K, int J, int Tk, int bk, int bo, int vec,
                          int grid_x, int grid_y, void* stream) {
  if (grid_x == 0 || grid_y == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const float* p = static_cast<const float*>(pre);
  const float* m = static_cast<const float*>(mod);
  const int* ix = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  const bool unit = bk == 1 && bo == 1;
  if (vec == 4 && unit)
    return launch_slots<4, true>(d, slot_stride, p, m, ix, sc, S, K, J, Tk, bk, bo,
                                 grid_x, grid_y, s);
  if (vec == 4)
    return launch_slots<4, false>(d, slot_stride, p, m, ix, sc, S, K, J, Tk, bk, bo,
                                  grid_x, grid_y, s);
  if (vec == 1 && unit)
    return launch_slots<1, true>(d, slot_stride, p, m, ix, sc, S, K, J, Tk, bk, bo,
                                 grid_x, grid_y, s);
  if (vec == 1)
    return launch_slots<1, false>(d, slot_stride, p, m, ix, sc, S, K, J, Tk, bk, bo,
                                  grid_x, grid_y, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
