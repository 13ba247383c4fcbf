// Causal (optionally sliding-window) GQA flash-attention forward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn/kernel.py
// (flash_fwd, body _fwd_kernel):
//     s   = (q . k^T) * dh^-0.5        f32 products and sums
//     s   = -inf where j > i, or where i - j >= window (when window > 0)
//     online max m and sum l over KV tiles, p = exp(s - m) in f32,
//     acc += bf16(p) . v (p cast to v's dtype, f32 sums), l clamped at 1e-30,
//     out = acc / l in q's dtype, lse = m + log(l) in f32.
// q is read as [B, S, H, dh] and k, v as [B, T, KV, dh] through strides (the
// model layout: no transpose, and no copy of K/V per GQA group: query head h
// reads KV head h / (H / KV)); out is written as [B, S, H, dh], lse as
// [B*H, S].
//
// What bounds it: at the LM serving prefill (B 4, S = T = 2048, H 40, KV 10,
// dh 128, bf16) the causal half needs 2 * 2 * dh * S(S+1)/2 * B*H = 172 GFLOP,
// 0.17 ms at 989 TFLOP/s of bf16 tensor cores; q, k, v, out and lse once are
// 0.21 GB, 0.06 ms at 3.35 TB/s. So the bound is the operations.
//
// Design (right and simple first; wgmma/TMA tiles are later work):
// * One block per (batch*head, query tile). The KV loop runs inside the block
//   (Hopper blocks run in no order and carry nothing from one to the next);
//   the m, l and acc of a row stay in registers across it. Query tiles are
//   issued last-first, so the long causal rows start early.
// * Only the KV tiles that hold a visible key for some row of the query tile
//   are visited: none above the diagonal, none wholly outside the window.
//   kv_tile_range() below is mirrored by kernel.kv_tile_range in Python,
//   where the CPU tests check it.
// * Masked scores are -inf, not the reference's -1e30. A row's running max
//   stays -inf until its first visible key, and exp() is taken against 0
//   instead of -inf then, so a row whose first visited tile is all masked
//   (rows past the window) adds exact zeros instead of exp(0) terms, and no
//   inf - inf NaN arises. The reference adds exp(0) terms there and wipes
//   them with alpha = 0 at its first open tile: the same result.
// * The last query tile and the last KV tile may be ragged (S, T not
//   multiples of the tile): out-of-range rows are computed but not written,
//   out-of-range keys are zero-filled in shared memory and masked.
// * bf16: 4 warps, 16 query rows each (64 per block), KV tiles of 64 keys
//   staged in shared memory with 16-byte loads; q . k^T and p . v on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); the q
//   fragments stay in registers for the whole KV loop, p goes from the
//   score accumulators straight into the A fragments of p . v.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 product): 4
//   threads per query row, each holding every 4th feature of q and acc
//   (neighbouring lanes read neighbouring words of a staged K or V row),
//   the dot products summed across the 4 lanes with shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per block, both paths
constexpr int BQ_MMA = 64;        // query rows per block (bf16)
constexpr int BK_MMA = 64;        // keys per KV tile (bf16)
constexpr int PAD = 8;            // bf16 elements of row padding in shared memory
constexpr int BQ_FMA = 32;        // query rows per block (f32), 4 lanes each
constexpr int BK_FMA = 32;        // keys per KV tile (f32)

struct Args {
  const void* q; const void* k; const void* v; void* o; float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, H, G, window;         // G = H / KV; window <= 0: none
  float scale;
};

// KV tiles [lo, hi) that hold a key visible from some query row in
// [q0, q1): keys j <= q1 - 1 and, with a window, j >= q0 - window + 1.
__device__ __forceinline__ void kv_tile_range(int q0, int q1, int T, int window,
                                              int bk, int& lo, int& hi) {
  const int end = min(T, q1);
  const int start = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = start / bk;
  hi = (end + bk - 1) / bk;
}

__device__ __forceinline__ bool visible(int i, int j, int T, int window) {
  return j < T && j <= i && (window <= 0 || i - j < window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// d (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + nrows) of one head of a [*, rows, heads, DH] tensor
// into dst[nrows][DH + PAD] (bf16), zero-filling rows at or past `limit`.
template <int DH>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long row_stride, int r0, int nrows,
                                           int limit) {
  constexpr int CH = DH / 8;                       // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (DH + PAD) + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DH + PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ_MMA * LD;                          // [BK][LD]
  __nv_bfloat16* vs = ks + BK_MMA * LD;                          // [BK][LD]

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_MMA;
  const int q1 = min(a.S, q0 + BQ_MMA);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;          // mma group and thread in group
  const int wr = warp * 16;                       // the warp's first row in the tile
  const int row_a = q0 + wr + g, row_b = row_a + 8;

  stage_bf16<DH>(qs, qg, a.q_ss, q0, BQ_MMA, a.S);
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    const __nv_bfloat16* r0 = qs + (wr + g) * LD + kc * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;   // l: this lane's part

  int lo, hi;
  kv_tile_range(q0, q1, a.T, a.window, BK_MMA, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK_MMA;
    __syncthreads();                              // the previous tile is read
    stage_bf16<DH>(ks, kg, a.k_ss, k0, BK_MMA, a.T);
    stage_bf16<DH>(vs, vg, a.v_ss, k0, BK_MMA, a.T);
    __syncthreads();

    float s[BK_MMA / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK_MMA / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BK_MMA / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK_MMA / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int i = e < 2 ? row_a : row_b;
        const float x = visible(i, j, a.T, a.window) ? s[nt][e] * a.scale : -INFINITY;
        s[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;   // no row visible yet
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = __expf(m_a - base_a), al_b = __expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[i][0] *= al_a; acc[i][1] *= al_a;
      acc[i][2] *= al_b; acc[i][3] *= al_b;
    }
#pragma unroll
    for (int nt = 0; nt < BK_MMA / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - base_a);
      s[nt][1] = __expf(s[nt][1] - base_a);
      s[nt][2] = __expf(s[nt][2] - base_b);
      s[nt][3] = __expf(s[nt][3] - base_b);
      l_a += s[nt][0] + s[nt][1];
      l_b += s[nt][2] + s[nt][3];
    }

#pragma unroll
    for (int kc = 0; kc < BK_MMA / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* v0 = vs + (kc * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const __nv_bfloat16* vr = v0 + dt * 8;
        mma_bf16(acc[dt], pa, pack_bf16(vr[0], vr[LD]),
                 pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float ia = 1.f / l_a, ib = 1.f / l_b;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (row_a < a.S)
      *reinterpret_cast<__nv_bfloat162*>(og + row_a * a.o_ss + c) =
          __floats2bfloat162_rn(acc[dt][0] * ia, acc[dt][1] * ia);
    if (row_b < a.S)
      *reinterpret_cast<__nv_bfloat162*>(og + row_b * a.o_ss + c) =
          __floats2bfloat162_rn(acc[dt][2] * ib, acc[dt][3] * ib);
  }
  if (t4 == 0) {
    float* lg = a.lse + (long long)n * a.S;
    if (row_a < a.S) lg[row_a] = m_a + __logf(l_a);
    if (row_b < a.S) lg[row_b] = m_b + __logf(l_b);
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_fma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DH / 4;                       // features per lane
  float* ks = reinterpret_cast<float*>(smem);     // [BK][DH]
  float* vs = ks + BK_FMA * DH;                   // [BK][DH]

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_FMA;
  const int q1 = min(a.S, q0 + BQ_FMA);
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int c = threadIdx.x % 4;                  // this lane's features: c, c+4, ...
  const int row = q0 + threadIdx.x / 4;
  float q[P], acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    q[i] = row < a.S ? qg[row * a.q_ss + i * 4 + c] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int lo, hi;
  kv_tile_range(q0, q1, a.T, a.window, BK_FMA, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK_FMA;
    __syncthreads();
    for (int i = threadIdx.x; i < BK_FMA * DH / 4; i += NT) {
      const int r = i / (DH / 4), cc = (i - r * (DH / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < a.T) {
        kv4 = *reinterpret_cast<const float4*>(kg + (long long)(k0 + r) * a.k_ss + cc);
        vv4 = *reinterpret_cast<const float4*>(vg + (long long)(k0 + r) * a.v_ss + cc);
      }
      *reinterpret_cast<float4*>(ks + r * DH + cc) = kv4;
      *reinterpret_cast<float4*>(vs + r * DH + cc) = vv4;
    }
    __syncthreads();

    float s[BK_FMA];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK_FMA; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) d = fmaf(q[i], ks[j * DH + i * 4 + c], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = visible(row, k0 + j, a.T, a.window) ? d * a.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float alpha = expf(m - base);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK_FMA; ++j) {
      const float p = expf(s[j] - base);
      l += p;
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = fmaf(p, vs[j * DH + i * 4 + c], acc[i]);
    }
  }

  if (row < a.S) {
    l = fmaxf(l, 1e-30f);
    float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int i = 0; i < P; ++i) og[i * 4 + c] = acc[i] / l;
    if (c == 0) a.lse[(long long)n * a.S + row] = m + logf(l);
  }
}

template <int DH>
int launch(const Args& a, int dtype, int nq, int nbh, int smem, cudaStream_t stream) {
  const dim3 grid(nq, nbh);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(flash_fwd_mma<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma<DH><<<grid, NT, smem, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_fma<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_fma<DH><<<grid, NT, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes, so that the Python wrapper can check it agrees: {NT, BQ_MMA,
// BK_MMA, PAD, BQ_FMA, BK_FMA}.
void flash_fwd_tiles(int* out) {
  out[0] = NT; out[1] = BQ_MMA; out[2] = BK_MMA; out[3] = PAD;
  out[4] = BQ_FMA; out[5] = BK_FMA;
}

// dtype: 0 = float32, 1 = bfloat16. Strides in elements. window <= 0: none.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a head
// width without an instance).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int B, int S, int T, int H, int KV, int dh, int window,
                     float scale, int nq, int smem, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, static_cast<float*>(lse),
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
         S, T, H, H / KV, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbh = B * H;
  switch (dh) {
    case 64: return launch<64>(a, dtype, nq, nbh, smem, s);
    case 128: return launch<128>(a, dtype, nq, nbh, smem, s);
    case 160: return launch<160>(a, dtype, nq, nbh, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
