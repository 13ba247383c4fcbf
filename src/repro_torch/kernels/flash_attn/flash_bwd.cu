// Causal (optionally sliding-window) GQA flash-attention backward for Hopper
// (sm_90a), plain C interface for ctypes: two kernels, as in the reference.
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attn/kernel.py
// (flash_bwd: _dkv_kernel and _dq_kernel). With the forward's lse and
// delta = rowsum(dout * out) (computed by the caller), for every visible
// (query i, key j) pair:
//     s  = (q_i . k_j) * dh^-0.5            f32 products and sums
//     p  = exp(s - lse_i)                   exactly 0 where masked
//     dv_j += p * do_i                      p cast to bf16 (bf16 inputs)
//     dp = do_i . v_j
//     ds = p * (dp - delta_i) * dh^-0.5
//     dk_j += ds * q_i,  dq_i += ds * k_j   ds cast to bf16 (bf16 inputs)
// q, do are read as [B, S, H, dh] and k, v as [B, T, KV, dh] through
// strides (query head h reads KV head h / G, G = H / KV); lse and delta are
// [B*H, S] f32; dq is written as [B, S, H, dh], dk and dv as [B, T, KV, dh],
// each once, in the inputs' dtype.
//
// What bounds it: at the LM training shape (B 2, S = T = 4096, H 12, KV 2,
// dh 128, bf16, causal) one score-sized product is 2 * dh * B*H * S(S+1)/2 =
// 51.6 GFLOP. The dK/dV kernel does four of them (s, dp, dv, dk: 206 GFLOP,
// 0.21 ms at 989 TFLOP/s of bf16 tensor cores), the dQ kernel three (s, dp,
// dq: 155 GFLOP, 0.16 ms). Their bytes (~67 MB for dK/dV) take ~0.02 ms at
// 3.35 TB/s. So the bound is the operations.
//
// Design (right and simple first; wgmma/TMA tiles are later work):
// * dK/dV: one block per (batch, KV head, 64-key tile). The block loops over
//   the G query heads of its group and, for each, over the 32-query tiles
//   that can see its keys (q_tile_range below: rows i >= k0 and, with a
//   window, i < k1 - 1 + window; the mirror of the forward's kv_tile_range).
//   dk and dv of the block's keys stay in f32 registers across both loops,
//   so the GQA sum happens inside the block, with no [B*H, T, dh] temporary
//   and no atomics. Each warp owns 16 keys and computes the transposed score
//   tile s^T = k . q^T directly (keys as the mma's rows), so p^T and ds^T
//   come out of the mma accumulators already in the A-operand layout of
//   dv += p^T . do and dk += ds^T . q: no transpose through shared memory.
//   Key tiles are issued first-first: key tile 0 sees every query.
// * dQ: one block per (batch*head, 64-query tile), looping over the 32-key
//   tiles it can see (kv_tile_range, as the forward); dq in f32 registers.
//   Query tiles are issued last-first, so the long causal rows start early.
//   The two-kernel split stays: dq is not accumulated from the dK/dV pass.
// * Masked entries: p = 0 exactly (the reference's exp(-1e30 - lse)); lse is
//   finite on every row, since a causal row sees at least key j = i.
// * The last query and key tiles may be ragged: out-of-range rows are
//   zero-filled in shared memory, masked, and not written.
// * bf16: 4 warps, mma.sync m16n8k16 (bf16 in, f32 accumulate), tiles staged
//   with 16-byte loads into rows padded by PAD. The operand a warp keeps for
//   the whole loop (dQ: its q and do rows) lives in registers; dK/dV reads
//   its k and v fragments from shared memory at each use, to leave the
//   registers to the two f32 accumulators.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 product): 4
//   threads per key (dK/dV) or query (dQ) row, each holding every 4th
//   feature, the dot products summed across the 4 lanes with shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per block, every kernel
constexpr int PAD = 8;            // bf16 elements of row padding in shared memory
constexpr int BK_DKV = 64;        // keys per dK/dV block (bf16): 4 warps x 16
constexpr int BQ_DKV = 32;        // queries per inner tile of dK/dV (bf16)
constexpr int BQ_DQ = 64;         // queries per dQ block (bf16): 4 warps x 16
constexpr int BK_DQ = 32;         // keys per inner tile of dQ (bf16)
constexpr int BF = 32;            // f32: rows per block and per inner tile

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh;   // dv shares dk's strides
  int S, T, H, KV, G, window;     // window <= 0: none
  float scale;
};

// KV tiles [lo, hi) holding a key visible from some query row in [q0, q1)
// (the forward's rule).
__device__ __forceinline__ void kv_tile_range(int q0, int q1, int T, int window,
                                              int bk, int& lo, int& hi) {
  const int end = min(T, q1);
  const int start = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = start / bk;
  hi = (end + bk - 1) / bk;
}

// Query tiles [lo, hi) holding a row that sees some key in [k0, k1): rows
// i >= k0 and, with a window, i <= k1 - 2 + window; all below S.
__device__ __forceinline__ void q_tile_range(int k0, int k1, int S, int window,
                                             int bq, int& lo, int& hi) {
  const int end = window > 0 ? min(S, k1 - 1 + window) : S;
  lo = k0 / bq;
  hi = (end + bq - 1) / bq;
}

__device__ __forceinline__ bool visible(int i, int j, int S, int T, int window) {
  return i < S && j < T && j <= i && (window <= 0 || i - j < window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragment (16 rows x 16 columns) at rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a row-major bf16 tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld, int r0,
                                       int c0, int g, int t4) {
  const bf16* p = tile + (r0 + g) * ld + c0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The A fragment of a 16x16 chunk made of two 16x8 f32 accumulator tiles
// (c0 | c1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// d[dt] += a . tile[rows r0 .. r0 + 16, all DH columns] for a row-major bf16
// tile (k = the tile's rows, n = its columns).
template <int DH>
__device__ __forceinline__ void mma_rows(float (*d)[4], const uint32_t* a, const bf16* tile,
                                         int ld, int r0, int g, int t4) {
  const bf16* p0 = tile + (r0 + t4 * 2) * ld + g;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const bf16* p = p0 + dt * 8;
    mma_bf16(d[dt], a, pack_bf16(p[0], p[ld]), pack_bf16(p[8 * ld], p[9 * ld]));
  }
}

// Stage rows [r0, r0 + nrows) of one head of a [*, rows, heads, DH] tensor
// into dst[nrows][DH + PAD] (bf16), zero-filling rows at or past `limit`.
template <int DH>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* base, long long row_stride,
                                           int r0, int nrows, int limit) {
  constexpr int CH = DH / 8;                       // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (DH + PAD) + c) = val;
  }
}

// The same for f32 into dst[nrows][DH].
template <int DH>
__device__ __forceinline__ void stage_f32(float* dst, const float* base, long long row_stride,
                                          int r0, int nrows, int limit) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < nrows * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      val = *reinterpret_cast<const float4*>(base + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * DH + c) = val;
  }
}

// lse and delta of rows [r0, r0 + n) of one batch*head into shared memory.
__device__ __forceinline__ void stage_rows(float* ls, float* dl, const float* lse,
                                           const float* delta, int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = r0 + i < S;
    ls[i] = in ? lse[r0 + i] : 0.f;
    dl[i] = in ? delta[r0 + i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DH + PAD;
  bf16* ks = reinterpret_cast<bf16*>(smem);       // [BK_DKV][LD]
  bf16* vs = ks + BK_DKV * LD;                     // [BK_DKV][LD]
  bf16* qs = vs + BK_DKV * LD;                     // [BQ_DKV][LD]
  bf16* dos = qs + BQ_DKV * LD;                    // [BQ_DKV][LD]
  float* ls = reinterpret_cast<float*>(dos + BQ_DKV * LD);   // [BQ_DKV]
  float* dl = ls + BQ_DKV;                                    // [BQ_DKV]

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x - b * a.KV;
  const int k0 = blockIdx.y * BK_DKV, k1 = min(a.T, k0 + BK_DKV);
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  stage_bf16<DH>(ks, kg, a.k_ss, k0, BK_DKV, a.T);
  stage_bf16<DH>(vs, vg, a.v_ss, k0, BK_DKV, a.T);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;          // mma group and thread in group
  const int wr = warp * 16;                       // the warp's first key in the tile
  const int key_a = k0 + wr + g, key_b = key_a + 8;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  int lo, hi;
  q_tile_range(k0, k1, a.S, a.window, BQ_DKV, lo, hi);
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const long long n = (long long)b * a.H + h;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ_DKV;
      __syncthreads();                            // the previous tile is read
      stage_bf16<DH>(qs, qg, a.q_ss, q0, BQ_DKV, a.S);
      stage_bf16<DH>(dos, dog, a.do_ss, q0, BQ_DKV, a.S);
      stage_rows(ls, dl, a.lse + n * a.S, a.delta + n * a.S, q0, BQ_DKV, a.S);
      __syncthreads();

      // s^T = k . q^T and dp^T = v . do^T: [16 keys x BQ_DKV queries] a warp
      float s[BQ_DKV / 8][4], dp[BQ_DKV / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ_DKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, LD, wr, kc * 16, g, t4);
        load_a(va, vs, LD, wr, kc * 16, g, t4);
#pragma unroll
        for (int nt = 0; nt < BQ_DKV / 8; ++nt) {
          const bf16* qr = qs + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
          const bf16* dr = dos + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
          mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
          mma_bf16(dp[nt], va, ld32(dr), ld32(dr + 8));
        }
      }

      // p^T into s, ds^T into dp
#pragma unroll
      for (int nt = 0; nt < BQ_DKV / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + t4 * 2 + (e & 1);
          const int j = e < 2 ? key_a : key_b;
          const float p = visible(q0 + c, j, a.S, a.T, a.window)
                              ? __expf(s[nt][e] * a.scale - ls[c]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl[c]) * a.scale;
        }
      }

      // dv += p^T . do and dk += ds^T . q (k = the tile's queries)
#pragma unroll
      for (int kc = 0; kc < BQ_DKV / 16; ++kc) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
        acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
        mma_rows<DH>(dv, pa, dos, LD, kc * 16, g, t4);
        mma_rows<DH>(dk, da, qs, LD, kc * 16, g, t4);
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dk_sb + kvh * a.dk_sh;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (key_a < a.T) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + key_a * a.dk_ss + c) =
          __floats2bfloat162_rn(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + key_a * a.dk_ss + c) =
          __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
    }
    if (key_b < a.T) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + key_b * a.dk_ss + c) =
          __floats2bfloat162_rn(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + key_b * a.dk_ss + c) =
          __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DH + PAD;
  bf16* qs = reinterpret_cast<bf16*>(smem);       // [BQ_DQ][LD] (staging only)
  bf16* dos = qs + BQ_DQ * LD;                     // [BQ_DQ][LD] (staging only)
  bf16* ks = dos + BQ_DQ * LD;                     // [BK_DQ][LD]
  bf16* vs = ks + BK_DQ * LD;                      // [BK_DQ][LD]

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_DQ;
  const int q1 = min(a.S, q0 + BQ_DQ);
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp * 16;
  const int row_a = q0 + wr + g, row_b = row_a + 8;

  stage_bf16<DH>(qs, qg, a.q_ss, q0, BQ_DQ, a.S);
  stage_bf16<DH>(dos, dog, a.do_ss, q0, BQ_DQ, a.S);
  __syncthreads();
  uint32_t qf[DH / 16][4], df[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    load_a(qf[kc], qs, LD, wr, kc * 16, g, t4);
    load_a(df[kc], dos, LD, wr, kc * 16, g, t4);
  }
  const float* lg = a.lse + (long long)n * a.S;
  const float* dg = a.delta + (long long)n * a.S;
  const float lse_a = row_a < a.S ? lg[row_a] : 0.f, lse_b = row_b < a.S ? lg[row_b] : 0.f;
  const float dl_a = row_a < a.S ? dg[row_a] : 0.f, dl_b = row_b < a.S ? dg[row_b] : 0.f;

  float dq[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int lo, hi;
  kv_tile_range(q0, q1, a.T, a.window, BK_DQ, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK_DQ;
    __syncthreads();                              // the previous tile is read
    stage_bf16<DH>(ks, kg, a.k_ss, k0, BK_DQ, a.T);
    stage_bf16<DH>(vs, vg, a.v_ss, k0, BK_DQ, a.T);
    __syncthreads();

    float s[BK_DQ / 8][4], dp[BK_DQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK_DQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BK_DQ / 8; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
        const bf16* vr = vs + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], df[kc], ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK_DQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + t4 * 2 + (e & 1);
        const bool top = e < 2;
        const float p = visible(top ? row_a : row_b, j, a.S, a.T, a.window)
                            ? __expf(s[nt][e] * a.scale - (top ? lse_a : lse_b)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (top ? dl_a : dl_b)) * a.scale;   // ds
      }
    }
    // dq += ds . k (k = the tile's keys)
#pragma unroll
    for (int kc = 0; kc < BK_DQ / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kc], s[2 * kc + 1]);
      mma_rows<DH>(dq, da, ks, LD, kc * 16, g, t4);
    }
  }

  bf16* qo = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (row_a < a.S)
      *reinterpret_cast<__nv_bfloat162*>(qo + row_a * a.dq_ss + c) =
          __floats2bfloat162_rn(dq[dt][0], dq[dt][1]);
    if (row_b < a.S)
      *reinterpret_cast<__nv_bfloat162*>(qo + row_b * a.dq_ss + c) =
          __floats2bfloat162_rn(dq[dt][2], dq[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// f32, CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_fma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DH / 4;                       // features per lane
  float* qs = reinterpret_cast<float*>(smem);     // [BF][DH]
  float* dos = qs + BF * DH;                      // [BF][DH]
  float* ls = dos + BF * DH;                      // [BF]
  float* dl = ls + BF;                            // [BF]

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x - b * a.KV;
  const int k0 = blockIdx.y * BF, k1 = min(a.T, k0 + BF);
  const int c = threadIdx.x % 4;                  // this lane's features: c, c+4, ...
  const int key = k0 + threadIdx.x / 4;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float kr[P], vr[P], dk[P], dv[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    kr[i] = key < a.T ? kg[key * a.k_ss + i * 4 + c] : 0.f;
    vr[i] = key < a.T ? vg[key * a.v_ss + i * 4 + c] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  int lo, hi;
  q_tile_range(k0, k1, a.S, a.window, BF, lo, hi);
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const long long n = (long long)b * a.H + h;
    const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BF;
      __syncthreads();
      stage_f32<DH>(qs, qg, a.q_ss, q0, BF, a.S);
      stage_f32<DH>(dos, dog, a.do_ss, q0, BF, a.S);
      stage_rows(ls, dl, a.lse + n * a.S, a.delta + n * a.S, q0, BF, a.S);
      __syncthreads();
      for (int i = 0; i < BF; ++i) {
        const float* qi = qs + i * DH + c;
        const float* di = dos + i * DH + c;
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int f = 0; f < P; ++f) {
          sd = fmaf(kr[f], qi[f * 4], sd);
          pd = fmaf(vr[f], di[f * 4], pd);
        }
        sd = sum4(sd);
        pd = sum4(pd);
        const float p = visible(q0 + i, key, a.S, a.T, a.window)
                            ? expf(sd * a.scale - ls[i]) : 0.f;
        const float ds = p * (pd - dl[i]) * a.scale;
#pragma unroll
        for (int f = 0; f < P; ++f) {
          dv[f] = fmaf(p, di[f * 4], dv[f]);
          dk[f] = fmaf(ds, qi[f * 4], dk[f]);
        }
      }
    }
  }
  if (key < a.T) {
    float* dkg = static_cast<float*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + key * a.dk_ss;
    float* dvg = static_cast<float*>(a.dv) + b * a.dk_sb + kvh * a.dk_sh + key * a.dk_ss;
#pragma unroll
    for (int f = 0; f < P; ++f) {
      dkg[f * 4 + c] = dk[f];
      dvg[f * 4 + c] = dv[f];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_fma(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DH / 4;
  float* ks = reinterpret_cast<float*>(smem);     // [BF][DH]
  float* vs = ks + BF * DH;                       // [BF][DH]

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BF;
  const int q1 = min(a.S, q0 + BF);
  const int c = threadIdx.x % 4;
  const int row = q0 + threadIdx.x / 4;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float qr[P], dr[P], dq[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    qr[i] = row < a.S ? qg[row * a.q_ss + i * 4 + c] : 0.f;
    dr[i] = row < a.S ? dog[row * a.do_ss + i * 4 + c] : 0.f;
    dq[i] = 0.f;
  }
  const float lse = row < a.S ? a.lse[(long long)n * a.S + row] : 0.f;
  const float dl = row < a.S ? a.delta[(long long)n * a.S + row] : 0.f;

  int lo, hi;
  kv_tile_range(q0, q1, a.T, a.window, BF, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BF;
    __syncthreads();
    stage_f32<DH>(ks, kg, a.k_ss, k0, BF, a.T);
    stage_f32<DH>(vs, vg, a.v_ss, k0, BF, a.T);
    __syncthreads();
    for (int j = 0; j < BF; ++j) {
      const float* kj = ks + j * DH + c;
      const float* vj = vs + j * DH + c;
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int f = 0; f < P; ++f) {
        sd = fmaf(qr[f], kj[f * 4], sd);
        pd = fmaf(dr[f], vj[f * 4], pd);
      }
      sd = sum4(sd);
      pd = sum4(pd);
      const float p = visible(row, k0 + j, a.S, a.T, a.window)
                          ? expf(sd * a.scale - lse) : 0.f;
      const float ds = p * (pd - dl) * a.scale;
#pragma unroll
      for (int f = 0; f < P; ++f) dq[f] = fmaf(ds, kj[f * 4], dq[f]);
    }
  }
  if (row < a.S) {
    float* qo = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh + row * a.dq_ss;
#pragma unroll
    for (int f = 0; f < P; ++f) qo[f * 4 + c] = dq[f];
  }
}

template <typename K>
int launch_kernel(K kernel, dim3 grid, int smem, cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const Args& a, int which, int dtype, dim3 grid, int smem, cudaStream_t s) {
  if (which == 0)
    return dtype == 1 ? launch_kernel(flash_bwd_dkv_mma<DH>, grid, smem, s, a)
                      : launch_kernel(flash_bwd_dkv_fma<DH>, grid, smem, s, a);
  return dtype == 1 ? launch_kernel(flash_bwd_dq_mma<DH>, grid, smem, s, a)
                    : launch_kernel(flash_bwd_dq_fma<DH>, grid, smem, s, a);
}

}  // namespace

extern "C" {

// Tile sizes, so that the Python wrapper can check it agrees: {NT, PAD,
// BK_DKV, BQ_DKV, BQ_DQ, BK_DQ, BF}.
void flash_bwd_tiles(int* out) {
  out[0] = NT; out[1] = PAD; out[2] = BK_DKV; out[3] = BQ_DKV;
  out[4] = BQ_DQ; out[5] = BK_DQ; out[6] = BF;
}

// which: 0 = dK/dV (writes dk, dv; grid (B*KV, key tiles)), 1 = dQ (writes
// dq; grid (query tiles, B*H)). dtype: 0 = float32, 1 = bfloat16. Strides in
// elements; dv has dk's strides. window <= 0: none. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for a head width without an instance).
int flash_bwd_launch(int which, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long do_sb, long long do_ss, long long do_sh,
                     long long dq_sb, long long dq_ss, long long dq_sh,
                     long long dk_sb, long long dk_ss, long long dk_sh,
                     int S, int T, int H, int KV, int dh, int window, float scale,
                     int grid_x, int grid_y, int smem, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, dk, dv,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
         dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,
         S, T, H, KV, H / KV, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  switch (dh) {
    case 64: return launch<64>(a, which, dtype, grid, smem, s);
    case 128: return launch<128>(a, which, dtype, grid, smem, s);
    case 160: return launch<160>(a, which, dtype, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
