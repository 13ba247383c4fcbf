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
// Design, for bf16: the copies of K and V overlap the products, only wgmma
// reaches the tensor cores' full rate, and the softmax between the two
// products has to run under other products:
// * One block per (batch*head, 128-row query tile), query tiles issued
//   last-first, so the long causal rows start early; three warpgroups. The
//   producer (setmaxnreg down to 24) has one thread issue TMA loads: the q
//   tile once, on its own mbarrier, then the block's K and V tiles of BK
//   keys (128; 64 at dh 160, for registers) into a ring of 3 stages, each
//   guarded by a "full" mbarrier (TMA transaction bytes) and an "empty" one
//   (the consumers' arrivals). TMA zero-fills rows past S or T. Copies of
//   the next tiles overlap the products on this one.
// * Two consumer warpgroups (setmaxnreg up to 240) own 64 query rows each.
//   Per KV tile: s = q . k^T as wgmma m64n{BK}k16 (A = q, B = k, both
//   K-major in shared memory, 64-byte swizzle: hopper.cuh), f32
//   accumulators in registers; the mask only where the tile straddles the
//   diagonal, the window edge or T (tile_needs_mask, mirrored by
//   kernel.tile_needs_mask), in a loop of its own; the online max over raw
//   scores and the sum with each row's values in 4 lanes (quad shuffles);
//   p = exp2(s * scale * log2(e) - max) as one FFMA and one ex2 a score; p
//   rounded to bf16 straight from the accumulators into wgmma register-A
//   fragments; o += p . v as wgmma m64n{dh}k16 with v an MN-major operand
//   (the transpose bit: v stays [keys, dh] in shared memory). The loop is
//   pipelined inside each consumer: q . k^T of tile t is issued with p . v
//   of tile t - 1, the softmax of tile t runs while p . v is on the tensor
//   cores, and o is rescaled once it is done (skipped when no row's max
//   moved); then the consumer arrives on the stage's empty barrier. The
//   epilogue writes o / l in bf16 and lse in f32 from the registers, no row
//   >= S.
// * The two consumers take turns to issue their products (ping-pong on two
//   named barriers), so one's softmax runs under the other's products. The
//   softmax's instruction count, more than the products or the loads, sets
//   the pace: hence the mask in a loop of its own, the folded scale and the
//   skipped rescale.
// * Shared memory at dh 128: q 32 KB + 3 stages x (K 32 + V 32 KB) = 224
//   KB; dh 160: q 40 KB + 3 x (20 + 20 KB); one block per SM.
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
//   out-of-range keys are zero-filled and masked.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 product): 4
//   threads per query row, each holding every 4th feature of q and acc
//   (neighbouring lanes read neighbouring words of a staged K or V row),
//   the dot products summed across the 4 lanes with shuffles.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 128;           // threads per block (f32)
constexpr int BQ_FMA = 32;        // query rows per block (f32), 4 lanes each
constexpr int BK_FMA = 32;        // keys per KV tile (f32)
constexpr int WG = 128;           // threads per warpgroup (bf16)
constexpr int NT_MMA = 3 * WG;    // producer + two consumer warpgroups (bf16)
constexpr int BQ_MMA = 128;       // query rows per block (bf16), 64 per consumer
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

template <int DH>
struct FwdSmem {
  static constexpr int BK = DH == 160 ? 64 : 128;    // keys per KV tile (registers at 160)
  static constexpr int ST = 3;                       // K/V tiles in flight
  static constexpr int Q = BQ_MMA * DH * 2;          // bytes of the q tile
  static constexpr int KV = BK * DH * 2;             // bytes of one K or V tile
  static constexpr int BARS = Q + ST * 2 * KV;       // the barriers' offset
  static constexpr int BYTES = BARS + 64 + 1024;     // + barriers + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(NT_MMA, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, Args a) {
  using namespace hopper;
  using L = FwdSmem<DH>;
  constexpr int SLABS = DH / SLAB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                        // [SLABS][BQ_MMA][32]
  unsigned char* kvs = smem + L::Q;                // stage st: K at 2 st KV, V after it
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;                       // [ST]: K and V landed
  uint64_t* empty = full + L::ST;                  // [ST]: both consumers done

  const int n = blockIdx.y, b = n / a.H, h = n - b * a.H, kvh = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_MMA;
  int lo, hi;
  kv_tile_range(q0, min(a.S, q0 + BQ_MMA), a.T, a.window, L::BK, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < L::ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // producer: one thread keeps the ring of K/V stages full
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, L::Q);
      for (int sl = 0; sl < SLABS; ++sl)
        tma_load_4d(qs + sl * BQ_MMA * SLAB_ROW_BYTES, &tq, qbar, sl * SLAB, h, q0, b);
      for (int kt = lo; kt < hi; ++kt) {
        const int i = kt - lo, st = i % L::ST;
        mbar_wait(&empty[st], ((i / L::ST) & 1) ^ 1);
        unsigned char* ks = kvs + 2 * st * L::KV;
        mbar_arrive_expect_tx(&full[st], 2 * L::KV);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(ks + sl * L::BK * SLAB_ROW_BYTES, &tk, &full[st], sl * SLAB, kvh,
                      kt * L::BK, b);
          tma_load_4d(ks + L::KV + sl * L::BK * SLAB_ROW_BYTES, &tv, &full[st], sl * SLAB, kvh,
                      kt * L::BK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns query rows [r0, r0 + 64) of the tile
    reg_alloc<240>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const float sl2 = a.scale * LOG2E;              // scores in log2 units
    const uint32_t q_addr = smem_addr(qs) + 64 * c * SLAB_ROW_BYTES;

    float o[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) o[e] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;   // l: this lane's part

    // s = q . k^T of the tile in stage st: A = q, B = k, both K-major
    auto issue_qk = [&](float* s, int st) {
      const uint32_t k_addr = smem_addr(kvs + 2 * st * L::KV);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc % 2) * 32;   // 16 features = 32 bytes
        mma_ss<L::BK, 0>(
            s, desc_k_major(q_addr + (kc / 2) * BQ_MMA * SLAB_ROW_BYTES + off),
            desc_k_major(k_addr + (kc / 2) * L::BK * SLAB_ROW_BYTES + off), kc > 0);
      }
      wgmma_commit();
    };
    // o += bf16(p) . v of stage st: A = p from registers, B = v MN-major
    // (v stays [keys, dh])
    auto issue_pv = [&](uint32_t (*pa)[4], int st) {
      const uint32_t v_addr = smem_addr(kvs + 2 * st * L::KV) + L::KV;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < L::BK / 16; ++kc)
        mma_rs<DH, 1>(o, pa[kc],
                      desc_mn_major(v_addr + kc * 16 * SLAB_ROW_BYTES,
                                    L::BK * SLAB_ROW_BYTES), 1);
      wgmma_commit();
    };
    // scores of KV tile kt -> p (in s), the running max and sum; returns
    // each row's rescale factor of o in al_a, al_b
    auto softmax = [&](float* s, int kt, float& al_a, float& al_b) {
      const int k0 = kt * L::BK;
      if (tile_needs_mask(r0, r0 + 64, k0, k0 + L::BK, a.T, a.window)) {
#pragma unroll
        for (int e = 0; e < L::BK / 2; ++e)
          if (!visible((e & 2) ? row_b : row_a, k0 + 8 * (e / 4) + 2 * t4 + (e & 1), a.T,
                       a.window))
            s[e] = -INFINITY;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;            // raw scores
#pragma unroll
      for (int e = 0; e < L::BK / 2; ++e) {
        if (e & 2) mx_b = fmaxf(mx_b, s[e]); else mx_a = fmaxf(mx_a, s[e]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;   // no key visible yet
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      al_a = ex2(m_a - base_a);
      al_b = ex2(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
      const float nb_a = -base_a, nb_b = -base_b;
#pragma unroll
      for (int e = 0; e < L::BK / 2; ++e) {
        const float p = ex2(fmaf(s[e], sl2, (e & 2) ? nb_b : nb_a));
        s[e] = p;
        if (e & 2) l_b += p; else l_a += p;
      }
    };

    // Pipelined over KV tiles: q . k^T of tile t is issued together with
    // p . v of tile t - 1, and the softmax of tile t runs while p . v is
    // on the tensor cores; o is rescaled only once that product is done.
    // The two consumers take turns to issue (named barriers 1 and 2,
    // consumer 0 first), so one's softmax runs under the other's products.
    auto my_turn = [&] { bar_sync(1 + c, 2 * WG); };
    auto your_turn = [&] { bar_arrive(2 - c, 2 * WG); };
    if (c == 1) bar_arrive(1, 2 * WG);
    float s[L::BK / 2], al_a, al_b;
    uint32_t pa[L::BK / 16][4];
    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    my_turn();
    issue_qk(s, 0);
    your_turn();
    wgmma_wait<0>();
    fence_regs<L::BK / 2>(s);
    softmax(s, lo, al_a, al_b);            // o is still 0: no rescale
#pragma unroll
    for (int kc = 0; kc < L::BK / 16; ++kc) acc_to_a(pa[kc], s, kc);
    int prev = 0;
    for (int kt = lo + 1; kt < hi; ++kt) {
      const int i = kt - lo, st = i % L::ST;
      mbar_wait(&full[st], (i / L::ST) & 1);
      my_turn();
      issue_qk(s, st);
      issue_pv(pa, prev);
      your_turn();
      wgmma_wait<1>();                     // q . k^T done, p . v in flight
      fence_regs<L::BK / 2>(s);
      softmax(s, kt, al_a, al_b);
      wgmma_wait<0>();
      fence_regs<DH / 2>(o);
      fence_regs<L::BK / 4>(&pa[0][0]);
      mbar_arrive(&empty[prev]);
      if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {   // a row's max moved
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) o[e] *= (e & 2) ? al_b : al_a;
      }
#pragma unroll
      for (int kc = 0; kc < L::BK / 16; ++kc) acc_to_a(pa[kc], s, kc);
      prev = st;
    }
    my_turn();
    issue_pv(pa, prev);
    your_turn();
    wgmma_wait<0>();
    fence_regs<DH / 2>(o);
    fence_regs<L::BK / 4>(&pa[0][0]);
    mbar_arrive(&empty[prev]);

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
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int col = nt * 8 + t4 * 2;
      if (row_a < a.S)
        *reinterpret_cast<__nv_bfloat162*>(og + row_a * a.o_ss + col) =
            __floats2bfloat162_rn(o[4 * nt] * ia, o[4 * nt + 1] * ia);
      if (row_b < a.S)
        *reinterpret_cast<__nv_bfloat162*>(og + row_b * a.o_ss + col) =
            __floats2bfloat162_rn(o[4 * nt + 2] * ib, o[4 * nt + 3] * ib);
    }
    if (t4 == 0) {
      float* lg = a.lse + (long long)n * a.S;
      if (row_a < a.S) lg[row_a] = (m_a + __log2f(l_a)) * LN2;
      if (row_b < a.S) lg[row_b] = (m_b + __log2f(l_b)) * LN2;
    }
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
int launch(const Args& a, int B, int dtype, int nq, int nbh, int smem, cudaStream_t stream) {
  const dim3 grid(nq, nbh);
  cudaError_t err;
  if (dtype == 1) {
    if (smem != FwdSmem<DH>::BYTES) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    const int kv = a.H / a.G;
    int bad = hopper::encode_bshd_map(&tq, a.q, B, a.S, a.H, DH, a.q_sb, a.q_ss, a.q_sh, BQ_MMA);
    if (!bad)
      bad = hopper::encode_bshd_map(&tk, a.k, B, a.T, kv, DH, a.k_sb, a.k_ss, a.k_sh,
                                    FwdSmem<DH>::BK);
    if (!bad)
      bad = hopper::encode_bshd_map(&tv, a.v, B, a.T, kv, DH, a.v_sb, a.v_ss, a.v_sh,
                                    FwdSmem<DH>::BK);
    if (bad) return bad;
    err = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wgmma<DH><<<grid, NT_MMA, smem, stream>>>(tq, tk, tv, a);
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

// Geometry, so that the Python wrapper can check it agrees: {NT_MMA,
// BQ_MMA, NT, BQ_FMA, BK_FMA, then for dh 64, 128, 160 the bf16 keys per
// tile, stages and shared-memory bytes}.
void flash_fwd_tiles(int* out) {
  out[0] = NT_MMA; out[1] = BQ_MMA; out[2] = NT; out[3] = BQ_FMA; out[4] = BK_FMA;
  out[5] = FwdSmem<64>::BK; out[6] = FwdSmem<64>::ST; out[7] = FwdSmem<64>::BYTES;
  out[8] = FwdSmem<128>::BK; out[9] = FwdSmem<128>::ST; out[10] = FwdSmem<128>::BYTES;
  out[11] = FwdSmem<160>::BK; out[12] = FwdSmem<160>::ST; out[13] = FwdSmem<160>::BYTES;
}

// dtype: 0 = float32, 1 = bfloat16. Strides in elements. window <= 0: none.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a head
// width without an instance or a shared-memory size other than the
// kernel's), or hopper::MAP_ERROR + the CUresult when a TMA tensor map
// cannot be encoded.
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
    case 64: return launch<64>(a, B, dtype, nq, nbh, smem, s);
    case 128: return launch<128>(a, B, dtype, nq, nbh, smem, s);
    case 160: return launch<160>(a, B, dtype, nq, nbh, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
