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
// 3.35 TB/s; the head split's f32 partials (2 x 3 x 8 MB at that shape)
// add ~0.03 ms of writes and the wrapper's sum. So the bound is the
// operations.
//
// dK/dV, bf16 (wgmma, TMA, mbarriers; hopper.cuh): copies overlap the
// products, only wgmma reaches the tensor cores' full rate, and the grid
// has to fill 132 SMs although a causal key tile's work falls with its
// index and GQA leaves few (batch, KV head) pairs. The design:
// * One block per (batch, KV head, head split, 128-key tile), three
//   warpgroups. Each consumer warpgroup (setmaxnreg up to 240) owns 64 keys
//   as the rows of every product (wgmma M = 64), so p^T and ds^T leave the
//   accumulators already in the register-A layout: s^T = k . q^T and
//   dp^T = v . dO^T as wgmma m64n{BQ}k16 with A = k / v and B = the q / dO
//   tile, all K-major in shared memory; dv += bf16(p^T) . dO and dk +=
//   bf16(ds^T) . q as wgmma m64n{dh}k16 with A from registers and B = dO / q
//   MN-major (the transpose bit: they stay [queries, dh]). dk and dv stay in
//   f32 registers for the whole loop; masks only where a tile straddles the
//   diagonal, the window edge, S or T (tile_needs_mask), in a loop of its
//   own; p = exp2(s * scale * log2(e) - lse * log2(e)) as one FFMA and one
//   ex2. The two consumers take turns to issue their products (ping-pong on
//   two named barriers), so one's elementwise work runs under the other's
//   products.
// * The producer warpgroup (setmaxnreg down to 24; its first warp works)
//   loads K and V once by TMA, then keeps a ring of DKV_STAGES stages of
//   (q, dO) tiles of BQ queries (64; 32 at dh 160, for registers) in
//   flight by TMA, shared by both consumers, with their lse (times log2 e,
//   for exp2) and delta rows copied by its lanes; each stage is guarded by
//   a "full" mbarrier (32 lane arrivals and the TMA bytes) and an "empty"
//   one (the consumers' 256 arrivals).
// * Filling the card without atomics: the G query heads of a KV head's group
//   are split over gsplit blocks, the smallest divisor of G that gives at
//   least 4 blocks per SM (kernel.dkv_gsplit; 6 at the training shape: 768
//   blocks; 12 for MQA at S 2048: 384). Split gs sums heads [h0, h0 + G/gsplit)
//   (kernel.dkv_heads). With gsplit 1 the block writes bf16 dk, dv; else it
//   writes f32 partials to ws [2, gsplit, B, T, KV, dh] and the wrapper sums
//   them over gsplit in split order and rounds once. Key tiles are issued
//   first-first: key tile 0 sees every query.
// dQ, bf16, on the same building blocks: one block per (batch*head, 128-query
// tile), query tiles issued last-first (the long causal rows start early),
// three warpgroups:
// * The producer warpgroup (setmaxnreg down to 24; one thread works) loads
//   the q and dO tiles once by TMA on their own mbarrier, then keeps a ring
//   of DQ_STAGES stages of (K, V) tiles of BK keys (128; 64 at dh 160, for
//   registers) in flight, each guarded by a "full" mbarrier (the TMA bytes)
//   and an "empty" one (the consumers' 256 arrivals).
// * Each consumer warpgroup (setmaxnreg up to 240) owns 64 query rows as the
//   rows of every product: s = q . k^T and dp = dO . v^T as wgmma m64n{BK}k16
//   with both operands K-major in shared memory; its rows' lse (times log2 e)
//   and delta sit in registers, loaded once; p = exp2(s * scale * log2(e) -
//   lse * log2(e)) as one FFMA and one ex2, masks only on tiles where
//   tile_needs_mask is true, in a loop of their own; ds = p (dp - delta)
//   scale goes from the accumulators straight into register-A fragments
//   (bf16), and dq += ds . k is wgmma m64n{dh}k16 with k read MN-major (the
//   transpose bit: k stays [keys, dh]). dq stays in f32 registers for the
//   whole loop and is written once in bf16. The two consumers take turns to
//   issue (ping-pong on two named barriers), as in dK/dV.
// * The two-kernel split stays: dq is not accumulated from the dK/dV pass,
//   so neither kernel needs atomics.
// * Masked entries: p = 0 exactly (the reference's exp(-1e30 - lse)); lse is
//   finite on every row, since a causal row sees at least key j = i.
// * The last query and key tiles may be ragged: out-of-range rows are
//   zero-filled in shared memory (by TMA or the staging loads), masked, and
//   not written.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 product): 4
//   threads per key (dK/dV) or query (dQ) row, each holding every 4th
//   feature, the dot products summed across the 4 lanes with shuffles.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 128;           // threads per block of the f32 kernels
constexpr int WG = 128;           // threads per warpgroup
constexpr int NT_WG = 3 * WG;     // bf16: a producer + two consumer warpgroups
constexpr int BK_DKV = 128;       // keys per dK/dV block (bf16), 64 per consumer
constexpr int DKV_STAGES = 2;     // (q, dO) tiles in flight (bf16 dK/dV)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ_DQ = 128;        // queries per dQ block (bf16), 64 per consumer
constexpr int DQ_STAGES = 2;      // (K, V) tiles in flight (bf16 dQ)
constexpr int BF = 32;            // f32: rows per block and per inner tile

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  float* ws;                      // bf16 dK/dV with gsplit > 1: f32 partials
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh;   // dv shares dk's strides
  int B, S, T, H, KV, G, window;  // window <= 0: none
  int gsplit;                     // bf16 dK/dV: blocks sharing a GQA group's heads
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

// Rows [r0, r0 + nrows) of one head of a [*, rows, heads, DH] f32 tensor
// into dst[nrows][DH], zero-filling rows at or past `limit`.
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
struct Dkv {
  static constexpr int BQ = DH == 160 ? 32 : 64;     // queries per inner tile
  static constexpr int KV = BK_DKV * DH * 2;         // bytes of the K or the V tile
  static constexpr int QT = BQ * DH * 2;             // bytes of one q or dO tile
  static constexpr int ROWS = 2 * KV + DKV_STAGES * 2 * QT;   // lse, delta of each stage
  static constexpr int BARS = ROWS + DKV_STAGES * 2 * BQ * 4;
  static constexpr int BYTES = BARS + 64 + 1024;     // + barriers + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(NT_WG, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  using D = Dkv<DH>;
  constexpr int BQ = D::BQ, SLABS = DH / hopper::SLAB, R = hopper::SLAB_ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = smem;                        // [SLABS][BK_DKV][32], V after it
  unsigned char* tiles = smem + 2 * D::KV;         // stage st: q at 2 st QT, dO after it
  float* rows = reinterpret_cast<float*>(smem + D::ROWS);   // stage st: lse log2e, delta
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + D::BARS);
  uint64_t* full = kvbar + 1;                      // [DKV_STAGES]: q, dO, lse, delta landed
  uint64_t* empty = full + DKV_STAGES;             // [DKV_STAGES]: both consumers done

  // block: (batch, KV head, head split gs) x key tile; split gs takes heads
  // [h0, h0 + G / gsplit) of the KV head's group (kernel.dkv_heads)
  const int gs = blockIdx.x % a.gsplit, bkv = blockIdx.x / a.gsplit;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int k0 = blockIdx.y * BK_DKV, k1 = min(a.T, k0 + BK_DKV);
  const int hps = a.G / a.gsplit, h0 = kvh * a.G + gs * hps;
  int lo, hi;
  q_tile_range(k0, k1, a.S, a.window, BQ, lo, hi);
  const int nq = max(0, hi - lo), ntiles = hps * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int st = 0; st < DKV_STAGES; ++st) {
      hopper::mbar_init(&full[st], 32);
      hopper::mbar_init(&empty[st], 2 * WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // producer, its first warp: K and V once, then a ring of (q, dO, lse,
    // delta) tiles; lane 0 issues the TMA loads, every lane copies lse and
    // delta rows
    hopper::reg_dealloc<24>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kvbar, 2 * D::KV);
      for (int sl = 0; sl < SLABS; ++sl) {
        hopper::tma_load_4d(ks + sl * BK_DKV * R, &tk, kvbar, sl * hopper::SLAB, kvh, k0, b);
        hopper::tma_load_4d(ks + D::KV + sl * BK_DKV * R, &tv, kvbar, sl * hopper::SLAB, kvh,
                            k0, b);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int h = h0 + it / nq, q0 = (lo + it % nq) * BQ, st = it % DKV_STAGES;
      hopper::mbar_wait(&empty[st], ((it / DKV_STAGES) & 1) ^ 1);
      const long long n = (long long)b * a.H + h;
      float* ls = rows + 2 * st * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < a.S;
        ls[r] = in ? a.lse[n * a.S + q0 + r] * LOG2E : 0.f;
        ls[BQ + r] = in ? a.delta[n * a.S + q0 + r] : 0.f;
      }
      if (lane == 0) {
        unsigned char* qs = tiles + 2 * st * D::QT;
        hopper::mbar_arrive_expect_tx(&full[st], 2 * D::QT);
        for (int sl = 0; sl < SLABS; ++sl) {
          hopper::tma_load_4d(qs + sl * BQ * R, &tq, &full[st], sl * hopper::SLAB, h, q0, b);
          hopper::tma_load_4d(qs + D::QT + sl * BQ * R, &tdo, &full[st], sl * hopper::SLAB, h,
                              q0, b);
        }
      } else {
        hopper::mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup c: keys [kc0, kc0 + 64) of the block are the rows
    // of every product, so p^T and ds^T leave the accumulators in the
    // register-A layout
    hopper::reg_alloc<240>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int kc0 = k0 + 64 * c;
    const int key_a = kc0 + 16 * warp + g, key_b = key_a + 8;
    const float sl2 = a.scale * LOG2E;
    const uint32_t k_addr = hopper::smem_addr(ks) + 64 * c * R, v_addr = k_addr + D::KV;
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) dk[e] = dv[e] = 0.f;

    // the two consumers take turns to issue (named barriers 1 and 2,
    // consumer 0 first), so one's elementwise work runs under the other's
    // products
    auto my_turn = [&] { hopper::bar_sync(1 + c, 2 * WG); };
    auto your_turn = [&] { hopper::bar_arrive(2 - c, 2 * WG); };
    if (c == 1) hopper::bar_arrive(1, 2 * WG);
    hopper::mbar_wait(kvbar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int q0 = (lo + it % nq) * BQ, st = it % DKV_STAGES;
      const uint32_t q_addr = hopper::smem_addr(tiles + 2 * st * D::QT), do_addr = q_addr + D::QT;
      const float* ls = rows + 2 * st * BQ;
      const float* dl = ls + BQ;
      hopper::mbar_wait(&full[st], (it / DKV_STAGES) & 1);

      // s^T = k . q^T and dp^T = v . dO^T: A = k / v, B = q / dO, all K-major
      float s[BQ / 2], dp[BQ / 2];
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc % 2) * 32;        // 16 features = 32 bytes
        hopper::mma_ss<BQ, 0>(s, hopper::desc_k_major(k_addr + (kc / 2) * BK_DKV * R + off),
                              hopper::desc_k_major(q_addr + (kc / 2) * BQ * R + off), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc % 2) * 32;
        hopper::mma_ss<BQ, 0>(dp, hopper::desc_k_major(v_addr + (kc / 2) * BK_DKV * R + off),
                              hopper::desc_k_major(do_addr + (kc / 2) * BQ * R + off), kc > 0);
      }
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<BQ / 2>(s);
      hopper::fence_regs<BQ / 2>(dp);

      // p^T into s, ds^T into dp
      if (hopper::tile_needs_mask(q0, q0 + BQ, kc0, kc0 + 64, a.T, a.window) ||
          q0 + BQ > a.S) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e)
          if (!visible(q0 + 8 * (e / 4) + 2 * t4 + (e & 1), (e & 2) ? key_b : key_a, a.S, a.T,
                       a.window))
            s[e] = -INFINITY;                            // p = 0 exactly
      }
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int c = 8 * (e / 4) + 2 * t4 + (e & 1);
        const float p = hopper::ex2(fmaf(s[e], sl2, -ls[c]));
        s[e] = p;
        dp[e] = p * (dp[e] - dl[c]) * a.scale;
      }

      // dv += bf16(p^T) . dO and dk += bf16(ds^T) . q: A from registers,
      // B = dO / q MN-major (they stay [queries, dh] in shared memory)
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        hopper::acc_to_a(pa[kc], s, kc);
        hopper::acc_to_a(da[kc], dp, kc);
      }
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        hopper::mma_rs<DH, 1>(dv, pa[kc], hopper::desc_mn_major(do_addr + kc * 16 * R, BQ * R), 1);
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        hopper::mma_rs<DH, 1>(dk, da[kc], hopper::desc_mn_major(q_addr + kc * 16 * R, BQ * R), 1);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<DH / 2>(dv);
      hopper::fence_regs<DH / 2>(dk);
      hopper::fence_regs<BQ / 4>(&pa[0][0]);
      hopper::fence_regs<BQ / 4>(&da[0][0]);
      hopper::mbar_arrive(&empty[st]);
    }

    if (a.gsplit == 1) {       // the whole group's sum: bf16, once
      bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
      bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dk_sb + kvh * a.dk_sh;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const int c = nt * 8 + t4 * 2;
        if (key_a < a.T) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + key_a * a.dk_ss + c) =
              __floats2bfloat162_rn(dk[4 * nt], dk[4 * nt + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvg + key_a * a.dk_ss + c) =
              __floats2bfloat162_rn(dv[4 * nt], dv[4 * nt + 1]);
        }
        if (key_b < a.T) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + key_b * a.dk_ss + c) =
              __floats2bfloat162_rn(dk[4 * nt + 2], dk[4 * nt + 3]);
          *reinterpret_cast<__nv_bfloat162*>(dvg + key_b * a.dk_ss + c) =
              __floats2bfloat162_rn(dv[4 * nt + 2], dv[4 * nt + 3]);
        }
      }
    } else {                   // this split's f32 partial: ws[0 or 1, gs, b, key, kvh, :]
      const long long part = (long long)a.gsplit * a.B * a.T * a.KV * DH;
      float* wk = a.ws + (((long long)gs * a.B + b) * a.T * a.KV + kvh) * DH;
      const long long row = (long long)a.KV * DH;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const int c = nt * 8 + t4 * 2;
        if (key_a < a.T) {
          *reinterpret_cast<float2*>(wk + key_a * row + c) =
              make_float2(dk[4 * nt], dk[4 * nt + 1]);
          *reinterpret_cast<float2*>(wk + part + key_a * row + c) =
              make_float2(dv[4 * nt], dv[4 * nt + 1]);
        }
        if (key_b < a.T) {
          *reinterpret_cast<float2*>(wk + key_b * row + c) =
              make_float2(dk[4 * nt + 2], dk[4 * nt + 3]);
          *reinterpret_cast<float2*>(wk + part + key_b * row + c) =
              make_float2(dv[4 * nt + 2], dv[4 * nt + 3]);
        }
      }
    }
  }
}

template <int DH>
struct Dq {
  static constexpr int BK = DH == 160 ? 64 : 128;    // keys per KV tile (registers at 160)
  static constexpr int Q = BQ_DQ * DH * 2;           // bytes of the q or the dO tile
  static constexpr int KV = BK * DH * 2;             // bytes of one K or V tile
  static constexpr int BARS = 2 * Q + DQ_STAGES * 2 * KV;
  static constexpr int BYTES = BARS + 64 + 1024;     // + barriers + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(NT_WG, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Args a) {
  using namespace hopper;
  using L = Dq<DH>;
  constexpr int BK = L::BK, SLABS = DH / SLAB, R = SLAB_ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                        // [SLABS][BQ_DQ][32], dO after it
  unsigned char* kvs = smem + 2 * L::Q;            // stage st: K at 2 st KV, V after it
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;                       // [DQ_STAGES]: K and V landed
  uint64_t* empty = full + DQ_STAGES;              // [DQ_STAGES]: both consumers done

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_DQ;
  int lo, hi;
  kv_tile_range(q0, min(a.S, q0 + BQ_DQ), a.T, a.window, BK, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // producer: one thread loads q and dO once, then keeps the K/V ring full
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, 2 * L::Q);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load_4d(qs + sl * BQ_DQ * R, &tq, qbar, sl * SLAB, h, q0, b);
        tma_load_4d(qs + L::Q + sl * BQ_DQ * R, &tdo, qbar, sl * SLAB, h, q0, b);
      }
      for (int kt = lo; kt < hi; ++kt) {
        const int i = kt - lo, st = i % DQ_STAGES;
        mbar_wait(&empty[st], ((i / DQ_STAGES) & 1) ^ 1);
        unsigned char* ks = kvs + 2 * st * L::KV;
        mbar_arrive_expect_tx(&full[st], 2 * L::KV);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(ks + sl * BK * R, &tk, &full[st], sl * SLAB, kvh, kt * BK, b);
          tma_load_4d(ks + L::KV + sl * BK * R, &tv, &full[st], sl * SLAB, kvh, kt * BK, b);
        }
      }
    }
  } else {
    // consumer warpgroup c: query rows [r0, r0 + 64) of the tile are the
    // rows of every product, so ds leaves the accumulators in the
    // register-A layout
    reg_alloc<240>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const float sl2 = a.scale * LOG2E;
    const long long rows = (long long)n * a.S;
    // rows past S: q and dO arrive as zeros, so ds = 0; they are not written
    const float ls_a = row_a < a.S ? a.lse[rows + row_a] * LOG2E : 0.f;
    const float ls_b = row_b < a.S ? a.lse[rows + row_b] * LOG2E : 0.f;
    const float dl_a = row_a < a.S ? a.delta[rows + row_a] : 0.f;
    const float dl_b = row_b < a.S ? a.delta[rows + row_b] : 0.f;
    const uint32_t q_addr = smem_addr(qs) + 64 * c * R, do_addr = q_addr + L::Q;
    float dq[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) dq[e] = 0.f;

    // the two consumers take turns to issue (named barriers 1 and 2,
    // consumer 0 first), so one's elementwise work runs under the other's
    // products
    auto my_turn = [&] { bar_sync(1 + c, 2 * WG); };
    auto your_turn = [&] { bar_arrive(2 - c, 2 * WG); };
    if (c == 1) bar_arrive(1, 2 * WG);
    mbar_wait(qbar, 0);
    for (int kt = lo; kt < hi; ++kt) {
      const int i = kt - lo, st = i % DQ_STAGES, k0 = kt * BK;
      const uint32_t k_addr = smem_addr(kvs + 2 * st * L::KV), v_addr = k_addr + L::KV;
      mbar_wait(&full[st], (i / DQ_STAGES) & 1);

      // s = q . k^T and dp = dO . v^T: A = q / dO, B = k / v, all K-major
      float s[BK / 2], dp[BK / 2];
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc % 2) * 32;          // 16 features = 32 bytes
        mma_ss<BK, 0>(s, desc_k_major(q_addr + (kc / 2) * BQ_DQ * R + off),
                      desc_k_major(k_addr + (kc / 2) * BK * R + off), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc % 2) * 32;
        mma_ss<BK, 0>(dp, desc_k_major(do_addr + (kc / 2) * BQ_DQ * R + off),
                      desc_k_major(v_addr + (kc / 2) * BK * R + off), kc > 0);
      }
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      fence_regs<BK / 2>(dp);

      // ds into dp: p = 0 exactly where masked
      if (tile_needs_mask(r0, r0 + 64, k0, k0 + BK, a.T, a.window)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          if (!visible((e & 2) ? row_b : row_a, k0 + 8 * (e / 4) + 2 * t4 + (e & 1), a.S, a.T,
                       a.window))
            s[e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float p = ex2(fmaf(s[e], sl2, (e & 2) ? -ls_b : -ls_a));
        dp[e] = p * (dp[e] - ((e & 2) ? dl_b : dl_a)) * a.scale;
      }

      // dq += bf16(ds) . k: A from registers, B = k MN-major (k stays
      // [keys, dh] in shared memory)
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a(da[kc], dp, kc);
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        mma_rs<DH, 1>(dq, da[kc], desc_mn_major(k_addr + kc * 16 * R, BK * R), 1);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<DH / 2>(dq);
      fence_regs<BK / 4>(&da[0][0]);
      mbar_arrive(&empty[st]);
    }

    bf16* qo = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int col = nt * 8 + t4 * 2;
      if (row_a < a.S)
        *reinterpret_cast<__nv_bfloat162*>(qo + row_a * a.dq_ss + col) =
            __floats2bfloat162_rn(dq[4 * nt], dq[4 * nt + 1]);
      if (row_b < a.S)
        *reinterpret_cast<__nv_bfloat162*>(qo + row_b * a.dq_ss + col) =
            __floats2bfloat162_rn(dq[4 * nt + 2], dq[4 * nt + 3]);
    }
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
int launch_dkv_wgmma(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  using D = Dkv<DH>;
  if (smem != D::BYTES || a.gsplit < 1 || a.G % a.gsplit ||
      (int)grid.x != a.B * a.KV * a.gsplit || (a.gsplit > 1 && a.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int bad = hopper::encode_bshd_map(&tq, a.q, a.B, a.S, a.H, DH, a.q_sb, a.q_ss, a.q_sh, D::BQ);
  if (!bad)
    bad = hopper::encode_bshd_map(&tdo, a.dout, a.B, a.S, a.H, DH, a.do_sb, a.do_ss, a.do_sh,
                                  D::BQ);
  if (!bad)
    bad = hopper::encode_bshd_map(&tk, a.k, a.B, a.T, a.KV, DH, a.k_sb, a.k_ss, a.k_sh, BK_DKV);
  if (!bad)
    bad = hopper::encode_bshd_map(&tv, a.v, a.B, a.T, a.KV, DH, a.v_sb, a.v_ss, a.v_sh, BK_DKV);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wgmma<DH><<<grid, NT_WG, smem, s>>>(tq, tdo, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq_wgmma(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  using L = Dq<DH>;
  if (smem != L::BYTES || (int)grid.x != (a.S + BQ_DQ - 1) / BQ_DQ ||
      (int)grid.y != a.B * a.H)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int bad = hopper::encode_bshd_map(&tq, a.q, a.B, a.S, a.H, DH, a.q_sb, a.q_ss, a.q_sh, BQ_DQ);
  if (!bad)
    bad = hopper::encode_bshd_map(&tdo, a.dout, a.B, a.S, a.H, DH, a.do_sb, a.do_ss, a.do_sh,
                                  BQ_DQ);
  if (!bad)
    bad = hopper::encode_bshd_map(&tk, a.k, a.B, a.T, a.KV, DH, a.k_sb, a.k_ss, a.k_sh, L::BK);
  if (!bad)
    bad = hopper::encode_bshd_map(&tv, a.v, a.B, a.T, a.KV, DH, a.v_sb, a.v_ss, a.v_sh, L::BK);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma<DH><<<grid, NT_WG, smem, s>>>(tq, tdo, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const Args& a, int which, int dtype, dim3 grid, int smem, cudaStream_t s) {
  if (which == 0)
    return dtype == 1 ? launch_dkv_wgmma<DH>(a, grid, smem, s)
                      : launch_kernel(flash_bwd_dkv_fma<DH>, grid, smem, s, a);
  return dtype == 1 ? launch_dq_wgmma<DH>(a, grid, smem, s)
                    : launch_kernel(flash_bwd_dq_fma<DH>, grid, smem, s, a);
}

}  // namespace

extern "C" {

// Geometry, so that the Python wrapper can check it agrees: {NT, BF, NT_WG,
// BK_DKV, DKV_STAGES, BQ_DQ, DQ_STAGES, then for dh 64, 128, 160 the bf16
// dK/dV query tile and shared-memory bytes and the bf16 dQ key tile and
// shared-memory bytes}.
void flash_bwd_tiles(int* out) {
  out[0] = NT; out[1] = BF; out[2] = NT_WG; out[3] = BK_DKV; out[4] = DKV_STAGES;
  out[5] = BQ_DQ; out[6] = DQ_STAGES;
  out[7] = Dkv<64>::BQ; out[8] = Dkv<64>::BYTES; out[9] = Dq<64>::BK; out[10] = Dq<64>::BYTES;
  out[11] = Dkv<128>::BQ; out[12] = Dkv<128>::BYTES;
  out[13] = Dq<128>::BK; out[14] = Dq<128>::BYTES;
  out[15] = Dkv<160>::BQ; out[16] = Dkv<160>::BYTES;
  out[17] = Dq<160>::BK; out[18] = Dq<160>::BYTES;
}

// which: 0 = dK/dV (grid (B*KV*gsplit, key tiles); bf16 writes dk, dv when
// gsplit is 1, else each split's f32 partials into ws [2, gsplit, B, T, KV,
// dh]; f32 takes gsplit 1), 1 = dQ (writes dq; grid (query tiles, B*H)).
// dtype: 0 = float32, 1 = bfloat16. Strides in elements; dv has dk's
// strides. window <= 0: none. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a head width without an instance or a geometry
// other than the kernel's), or hopper::MAP_ERROR + the CUresult when a TMA
// tensor map cannot be encoded.
int flash_bwd_launch(int which, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, void* ws,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long do_sb, long long do_ss, long long do_sh,
                     long long dq_sb, long long dq_ss, long long dq_sh,
                     long long dk_sb, long long dk_ss, long long dk_sh,
                     int B, int S, int T, int H, int KV, int dh, int window, float scale,
                     int gsplit, int grid_x, int grid_y, int smem, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1) || (dtype == 0 && gsplit != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, dk, dv, static_cast<float*>(ws),
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
         dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,
         B, S, T, H, KV, H / KV, window, gsplit, scale};
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
