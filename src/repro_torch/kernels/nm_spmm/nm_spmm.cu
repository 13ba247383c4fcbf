// Block-N:M sparse matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/nm_spmm/kernel.py
// (nm_spmm_pallas):   y[:, j*bo:(j+1)*bo] = sum_t x[:, idx[j,t]*bk : +bk] @ wc[j,t]
// with x [B,K], wc [J,T,bk,bo], idx [J,T] int32, y [B, J*bo]; f32 or bf16
// in and out, f32 accumulation.
//
// What bounds it: at the paper shape (bk = bo = 1, T = 104 of K = 512 kept
// per output neuron) every weight is used once per row and every gathered
// x element once per kept connection, so the work is 2*B*J*T*bk*bo FMAs on
// data that fits in shared memory: the floor is the bytes of x, wc, idx and
// y (a few MB), and in practice the gather latency from shared memory.
//
// Design (simple and correct first; wgmma/TMA tiles are later work):
// * A block owns BM = ROWS*RY rows and one column group of BN output columns:
//   either JG whole out tiles (bo <= BN) or a BN-wide slice of one tile.
// * It stages its rows of x ([BM, K], the gather source), its slice of idx
//   ([T, JG]) and of wc ([T*bk, BN], transposed so neighbouring threads read
//   neighbouring words) into shared memory: the counterpart of the Pallas
//   scalar prefetch of idx, and of the x/wc BlockSpecs.
// * Thread (tx, ty) computes column tx for ROWS rows, walking the T kept
//   blocks and bk rows of each, accumulating in f32 registers. At bk = bo = 1
//   this is an ELL gather SpMM; for bk, bo >= 16 the threads of a warp share
//   one kept block, so the x reads broadcast.
// * Ragged rows (B % BM) and ragged tiles (J % JG) are masked in the kernel;
//   nothing is padded on the host. No atomics: each output is written once.
// * A kept-block id outside [0, K/bk) traps (the launch's stream then fails
//   with an error): a corrupt topology is a fault, never a silently dropped
//   contribution.
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

}  // namespace

extern "C" {

// Rows per block; the Python wrapper sizes shared memory with it.
int nm_spmm_block_rows() { return BM; }

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
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

}  // extern "C"
