// Fused AdamW for the port's LM training: one pass for the gradients' sum
// of squares, one in-place pass for the update.
//
// Replaces no TPU kernel: the JAX package's update
// (src/repro/optim/optimizer.py, adamw_update) is jnp that XLA fuses into
// a few loops. Written plainly in PyTorch it is about 23 elementwise
// kernels a leaf, each streaming f32 temporaries through HBM (about 210
// bytes an element with the norm).
//
// Bound: HBM bytes. The update reads g, p, m, v and writes p, m, v once:
// 22 bytes an element with bf16 parameters and gradients and f32 moments;
// the norm reads g once (2 bytes). At 3.35 TB/s that is the floor, and
// the design spends nothing else on the bus:
//
// * one launch for the norm and one for the update over a table of leaves
//   (kernel.py builds it; FIELDS int64 each), a block per CHUNK elements of
//   a leaf, so a step of thousands of leaves and slabs is two launches;
// * each thread moves VEC = 8 elements a turn with 16-byte loads and stores
//   where the layout allows (kernel.py decides per leaf), else one;
// * a view is rows of contiguous runs, rows equally apart: a ZeRO-1 block
//   narrowed along any dim is read and written where it lies, no copy;
// * a gate scale is read per row of the last axis from at most MAX_TERMS
//   (divisor, size, stride) terms, never broadcast to the leaf's size;
// * offsets are 64-bit (one expert leaf's m is 2.95 GB), divided in 32
//   bits where both operands fit.
//
// Bit for bit the plain update (ref.py) on the card: the plain path's op
// order, each op rounded once (__f*_rn: no contraction into FMAs), IEEE
// division and square root, and PyTorch's own scalars: kernel.py casts
// each Python scalar to f32 as PyTorch does, and passes 1/bc for `x / bc`
// (PyTorch's CUDA division by a Python scalar multiplies by the f32
// reciprocal). The update is elementwise, so a block or a slab of a leaf
// gets the whole leaf's bits.
//
// The norm sums squares in f32 within a chunk (fixed order: eight lanes a
// thread, then the block's tree) and the chunks' sums in f64 in chunk
// order, in the last block to finish (an integer ticket; no float atomic):
// the same bits on every run. It keeps two sums, the replicated leaves'
// and the model-split ones' (global_norm all-reduces the second).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define VEC 8
#define CHUNK 65536  // elements of a leaf a block takes: THREADS * VEC * 32
#define FIELDS 24
#define MAX_TERMS 3

// a leaf's fields, as kernel.py's F_* (int64 each)
enum {
  F_P, F_G, F_M, F_V, F_S,                 // pointers (s 0: no scale)
  F_N, F_RUN,                              // elements; contiguous run
  F_RS_P, F_RS_G, F_RS_M, F_RS_V,          // row strides (elements)
  F_FLAGS, F_FIRST, F_NTERMS, F_TERMS      // F_TERMS..: (div, size, stride)
};
enum { P_BF16 = 1, G_BF16 = 2, S_BF16 = 4, HAS_SCALE = 8, VECTOR = 16,
       SPLIT = 32 };

typedef unsigned long long u64;
typedef __nv_bfloat16 bf16;

struct Hyper {
  float b1, omb1, b2, omb2, lr, ibc1, ibc2, eps, lrwd;
};

__device__ __forceinline__ u64 udiv(u64 a, u64 b) {
  return ((a | b) >> 32) ? a / b : (u64)((unsigned)a / (unsigned)b);
}

// the leaf that holds chunk c (the last whose first chunk is <= c)
__device__ __forceinline__ int find_leaf(const long long* table, int nleaves,
                                         long long c) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (table[(size_t)mid * FIELDS + F_FIRST] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// thread 0 copies chunk c's leaf into shared memory for the block
__device__ __forceinline__ void load_leaf(long long* L, const long long* table,
                                          int nleaves, long long c) {
  if (threadIdx.x == 0) {
    const long long* src = table + (size_t)find_leaf(table, nleaves, c) * FIELDS;
    for (int f = 0; f < FIELDS; ++f) L[f] = src[f];
  }
  __syncthreads();
}

// element e of a view lies at row * row_stride + col, each tensor its own
// row stride
__device__ __forceinline__ void row_col(const long long* L, u64 e, u64& row,
                                        u64& col) {
  u64 run = (u64)L[F_RUN];
  if ((u64)L[F_N] == run) { row = 0; col = e; return; }
  row = udiv(e, run);
  col = e - row * run;
}

__device__ __forceinline__ float scale_at(const long long* L, u64 e) {
  u64 o = 0;
  int nt = (int)L[F_NTERMS];
  for (int t = 0; t < nt; ++t) {
    const long long* T = L + F_TERMS + 3 * t;
    u64 q = udiv(e, (u64)T[0]);
    q -= udiv(q, (u64)T[1]) * (u64)T[1];
    o += q * (u64)T[2];
  }
  if (L[F_FLAGS] & S_BF16)
    return __bfloat162float(reinterpret_cast<const bf16*>(L[F_S])[o]);
  return reinterpret_cast<const float*>(L[F_S])[o];
}

// W elements from x[i]: 16-byte accesses for W = VEC (kernel.py checks
// the alignment), one element for W = 1
template <int W> __device__ __forceinline__ void load(const float* x, float* out) {
  if constexpr (W == VEC) {
    float4 a = reinterpret_cast<const float4*>(x)[0];
    float4 b = reinterpret_cast<const float4*>(x)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    out[0] = *x;
  }
}

template <int W> __device__ __forceinline__ void load(const bf16* x, float* out) {
  if constexpr (W == VEC) {
    uint4 u = *reinterpret_cast<const uint4*>(x);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
    out[0] = __bfloat162float(*x);
  }
}

template <int W> __device__ __forceinline__ void store(float* x, const float* in) {
  if constexpr (W == VEC) {
    reinterpret_cast<float4*>(x)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(x)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else {
    *x = in[0];
  }
}

// rounds to nearest even, as PyTorch's `.to(torch.bfloat16)` on the card
template <int W> __device__ __forceinline__ void store(bf16* x, const float* in) {
  if constexpr (W == VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
    *reinterpret_cast<uint4*>(x) = u;
  } else {
    *x = __float2bfloat16(in[0]);
  }
}

template <typename GT, int W>
__device__ float sq_chunk(const long long* L, u64 c0, u64 c1) {
  const GT* g = reinterpret_cast<const GT*>(L[F_G]);
  const u64 rs = (u64)L[F_RS_G];
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (u64 e = c0 + threadIdx.x * W; e < c1; e += THREADS * W) {
    u64 row, col;
    row_col(L, e, row, col);
    float x[W];
    load<W>(g + row * rs + col, x);
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = __fmaf_rn(x[k], x[k], acc[k]);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) s = __fadd_rn(s, acc[k]);
  return s;
}

// the block's sum, in thread 0, in a fixed order
template <typename T> __device__ __forceinline__ T block_sum(T x, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// part[2c + split] = chunk c's sum of squares, part[2c + 1 - split] = 0;
// the last block sums them into out[0] (replicated) and out[1] (split)
__global__ void __launch_bounds__(THREADS)
adamw_norm(const long long* table, int nleaves, long long nchunks,
           float* part, float* out, u64* ticket) {
  __shared__ long long L[FIELDS];
  __shared__ float redf[THREADS / 32];
  __shared__ double redd[THREADS / 32];
  __shared__ bool last;
  const long long c = blockIdx.x;
  load_leaf(L, table, nleaves, c);
  const u64 c0 = (u64)(c - L[F_FIRST]) * CHUNK;
  const u64 c1 = min(c0 + CHUNK, (u64)L[F_N]);
  const long long fl = L[F_FLAGS];
  float s;
  if (fl & VECTOR)
    s = (fl & G_BF16) ? sq_chunk<bf16, VEC>(L, c0, c1) : sq_chunk<float, VEC>(L, c0, c1);
  else
    s = (fl & G_BF16) ? sq_chunk<bf16, 1>(L, c0, c1) : sq_chunk<float, 1>(L, c0, c1);
  s = block_sum(s, redf);
  if (threadIdx.x == 0) {
    const int sp = (fl & SPLIT) ? 1 : 0;
    part[2 * c + sp] = s;
    part[2 * c + 1 - sp] = 0.f;
    __threadfence();
    last = atomicAdd(ticket, 1ull) == (u64)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double a0 = 0.0, a1 = 0.0;
  for (long long i = threadIdx.x; i < nchunks; i += THREADS) {
    a0 += (double)__ldcg(part + 2 * i);
    a1 += (double)__ldcg(part + 2 * i + 1);
  }
  a0 = block_sum(a0, redd);
  __syncthreads();
  a1 = block_sum(a1, redd);
  if (threadIdx.x == 0) {
    out[0] = (float)a0;
    out[1] = (float)a1;
  }
}

// the plain update's ops in its order (ref.update), each rounded once
template <typename PT, typename GT, int W>
__device__ void update_chunk(const long long* L, u64 c0, u64 c1, float clip,
                             const Hyper& h) {
  PT* p = reinterpret_cast<PT*>(L[F_P]);
  const GT* g = reinterpret_cast<const GT*>(L[F_G]);
  float* m = reinterpret_cast<float*>(L[F_M]);
  float* v = reinterpret_cast<float*>(L[F_V]);
  const u64 rp = (u64)L[F_RS_P], rg = (u64)L[F_RS_G], rm = (u64)L[F_RS_M],
            rv = (u64)L[F_RS_V];
  const bool scaled = (L[F_FLAGS] & HAS_SCALE) != 0;
  const bool per_row = scaled && L[F_NTERMS] > 0;
  const float s0 = scaled && !per_row ? scale_at(L, 0) : 1.f;
  for (u64 e = c0 + threadIdx.x * W; e < c1; e += THREADS * W) {
    u64 row, col;
    row_col(L, e, row, col);
    float pf[W], gf[W], mf[W], vf[W];
    load<W>(p + row * rp + col, pf);
    load<W>(g + row * rg + col, gf);
    load<W>(m + row * rm + col, mf);
    load<W>(v + row * rv + col, vf);
    const float s = per_row ? scale_at(L, e) : s0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float gk = __fmul_rn(gf[k], clip);
      mf[k] = __fadd_rn(__fmul_rn(mf[k], h.b1), __fmul_rn(h.omb1, gk));
      vf[k] = __fadd_rn(__fmul_rn(vf[k], h.b2), __fmul_rn(__fmul_rn(h.omb2, gk), gk));
      const float num = __fmul_rn(h.lr, __fmul_rn(mf[k], h.ibc1));
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vf[k], h.ibc2)), h.eps);
      float st = __fadd_rn(__fdiv_rn(num, den), __fmul_rn(h.lrwd, pf[k]));
      if (scaled) st = __fmul_rn(st, s);
      pf[k] = __fsub_rn(pf[k], st);
    }
    store<W>(m + row * rm + col, mf);
    store<W>(v + row * rv + col, vf);
    store<W>(p + row * rp + col, pf);
  }
}

template <int W>
__device__ __forceinline__ void update_dispatch(const long long* L, u64 c0, u64 c1,
                                                float clip, const Hyper& h) {
  const long long fl = L[F_FLAGS];
  if (fl & P_BF16) {
    if (fl & G_BF16) update_chunk<bf16, bf16, W>(L, c0, c1, clip, h);
    else update_chunk<bf16, float, W>(L, c0, c1, clip, h);
  } else {
    if (fl & G_BF16) update_chunk<float, bf16, W>(L, c0, c1, clip, h);
    else update_chunk<float, float, W>(L, c0, c1, clip, h);
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_update(const long long* table, int nleaves, const float* clip_ptr,
             Hyper h) {
  __shared__ long long L[FIELDS];
  const long long c = blockIdx.x;
  load_leaf(L, table, nleaves, c);
  const float clip = *clip_ptr;
  const u64 c0 = (u64)(c - L[F_FIRST]) * CHUNK;
  const u64 c1 = min(c0 + CHUNK, (u64)L[F_N]);
  if (L[F_FLAGS] & VECTOR) update_dispatch<VEC>(L, c0, c1, clip, h);
  else update_dispatch<1>(L, c0, c1, clip, h);
}

extern "C" {

// the block geometry and table layout, checked against kernel.py
void adamw_geometry(int* out) {
  out[0] = THREADS;
  out[1] = VEC;
  out[2] = CHUNK;
  out[3] = FIELDS;
  out[4] = MAX_TERMS;
}

int adamw_norm_launch(const void* table, int nleaves, long long nchunks,
                      void* part, void* out, void* ticket, void* stream) {
  adamw_norm<<<(unsigned)nchunks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, nleaves, nchunks, (float*)part, (float*)out,
      (u64*)ticket);
  return (int)cudaGetLastError();
}

int adamw_update_launch(const void* table, int nleaves, long long nchunks,
                        const void* clip, float b1, float omb1, float b2,
                        float omb2, float lr, float ibc1, float ibc2, float eps,
                        float lrwd, void* stream) {
  Hyper h = {b1, omb1, b2, omb2, lr, ibc1, ibc2, eps, lrwd};
  adamw_update<<<(unsigned)nchunks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, nleaves, (const float*)clip, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
