// Gated three-factor compact weight update for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/wu_outer/kernel.py
// (wu_outer_pallas):
//     dw[j, t] = scale * pre[:, idx[j,t]*bk : +bk]^T @ mod[:, j*bo : +bo]
// with pre [B,K], mod [B,N] (N = J*bo), idx [J,T] int32, scale a one-element
// device tensor (lr x gate: the counterpart of the Pallas SMEM operand, so
// the gate never goes to the host), dw [J,T,bk,bo]; f32 or bf16 in and out,
// f32 accumulation. The update exists only for kept blocks; the training
// step adds it to the compact weights in torch.
//
// What bounds it: at the training shape (B = 16, K = N = 512, T = 104,
// bk = bo = 1) the function moves ~0.49 MB (pre and mod 32 KB each, idx and
// dw 213 KB each) and does 1.7 MFLOP, so its floor is ~0.15 us of HBM time:
// a launch-latency kernel. What it costs in practice is the latency of
// staging pre and of the gather from shared memory.
//
// Design (simple and correct first; wgmma/TMA tiles are later work):
// * Output elements e = ((j*T + t)*bk + kk)*bo + c are cut into contiguous
//   ranges of EB = NT*R; a block owns one range and each thread R elements
//   (its (j, t, kk, c) decoded once, its pre column idx[j,t]*bk + kk kept in
//   a register). At bk = bo = 1 a block owns the kept synapses of ~5 output
//   neurons: a sampled (gathered) outer product. For bk, bo >= 16 a block
//   owns whole kept blocks (or a piece of one) and computes the
//   [bk, B] x [B, bo] product from shared memory: a warp shares one kk, so
//   its pre reads broadcast and its mod reads are consecutive.
// * The batch is walked in chunks of BC rows: the chunk's rows of pre
//   (full rows: the gather source) and the block's mod columns are staged in
//   shared memory, then every thread accumulates its outputs over the chunk
//   in f32 registers. The last chunk is ragged and masked: no row padding
//   (the Pallas kernel's b % bb == 0 was a TPU tile artefact).
// * A closed gate (scale == 0) writes zeros without reading pre or mod: the
//   WU the chip skips. No atomics: each output is written once.
// * A kept-block id outside [0, K/bk) traps (the launch's stream then fails
//   with an error), so a corrupt topology shows as a fault, never as a
//   silent zero update at the synapses it names.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int R = 2;      // output elements per thread
constexpr int EB = NT * R;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__global__ void __launch_bounds__(NT)
wu_outer_kernel(const T* __restrict__ pre, const T* __restrict__ mod,
                const int* __restrict__ idx, const T* __restrict__ scale_p,
                T* __restrict__ dw, int B, int K, int J, int Tk, int bk, int bo,
                int BC, int MW) {
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
      if (e[r] < total) dw[e[r]] = from_f<T>(0.f);
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
    if (e[r] < total) dw[e[r]] = from_f<T>(scale * acc[r]);
}

template <typename T>
int launch(const void* pre, const void* mod, const int* idx, const void* scale,
           void* dw, int B, int K, int J, int Tk, int bk, int bo, int BC, int MW,
           int nblocks, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wu_outer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  wu_outer_kernel<T><<<nblocks, NT, smem_bytes, stream>>>(
      static_cast<const T*>(pre), static_cast<const T*>(mod), idx,
      static_cast<const T*>(scale), static_cast<T*>(dw), B, K, J, Tk, bk, bo, BC, MW);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output elements per block; the Python wrapper sizes the grid with it.
int wu_outer_elems_per_block() { return EB; }

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int wu_outer_launch(const void* pre, const void* mod, const void* idx,
                    const void* scale, void* dw, int B, int K, int J, int Tk,
                    int bk, int bo, int BC, int MW, int nblocks, int smem_bytes,
                    int dtype, void* stream) {
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return launch<float>(pre, mod, ix, scale, dw, B, K, J, Tk, bk, bo, BC, MW,
                         nblocks, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pre, mod, ix, scale, dw, B, K, J, Tk, bk, bo, BC,
                                 MW, nblocks, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
