// Tile product engine for Hopper (sm_90a): float32 products on the tensor
// cores in 3xTF32, operands staged in shared memory by cp.async.
//
// C[m, n] = sum_k A[m, k] B[k, n] over one BM x BN output tile. Each f32
// operand x is split as hi = tf32(x), lo = tf32(x - hi), and the tile sums
// lo*hi + hi*lo + hi*hi with mma.sync m16n8k8 TF32 into f32 accumulators
// (CUTLASS's OpMultiplyAddFastF32): about f32's accuracy at three times
// TF32's cost, where one TF32 pass keeps only about three decimal digits.
// The tensor cores do not round their f32 sums to nearest (they truncate),
// which over thousands of accumulations would bias a sum. A tile shape
// that sums long reductions (the weight gradients sum 5,000 rows a split)
// therefore promotes: each stage's BK-deep sum starts from zero in the
// tensor cores and is then added to the tile's running sum with an
// ordinary, rounded f32 add. The scan's products (at most 768 deep) skip
// this and keep the 32 registers it costs.
//
// Operands are read from global memory through L2 (cp.async.cg), never
// through L1, so a kernel may read what other CTAs wrote before a grid
// barrier. Layouts (element (m, k) of A, (k, n) of B):
//   A_MK  A[m * lda + k]   rows of activations
//   A_KM  A[k * lda + m]   activations read transposed (weight gradients)
//   B_KN  B[k * ldb + n]   PyTorch's (out, in) weight in an input-gradient
//                           product, or activations (weight gradients)
//   B_NK  B[n * ldb + k]   PyTorch's (out, in) weight in a forward product
// Every leading dimension, and K and N, must be multiples of 4 (16-byte
// rows for cp.async); M, N and K may end anywhere else: the edges are
// zero-filled on load and masked on store.
//
// A tile is loaded in BK-deep stages through a ring of C::STAGES, the next
// stages in flight while the tensor cores work on the current one. The
// shared-memory tiles are padded so that every fragment load of a warp
// hits 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int NT = 256;    // threads per CTA (8 warps)

enum { A_MK = 0, A_KM = 1 };
enum { B_KN = 0, B_NK = 1 };

// Tile shapes: BM x BN per CTA, stages BK deep in a ring of STAGES;
// WM x WN x WK warps (8 in all), each warp a (BM / WM) x (BN / WN) block
// of m16n8 accumulator tiles over every WK-th 8-deep step of a stage (the
// WK partial sums are added in a fixed order at the end); PROMOTE as
// above.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int WK_, int STAGES_,
          bool PROMOTE_ = false>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int WK = WK_, STAGES = STAGES_;
  static constexpr bool PROMOTE = PROMOTE_;
  static constexpr int MT = BM / WM / 16;  // m16 tiles per warp
  static constexpr int NT8 = BN / WN / 8;  // n8 tiles per warp
  static_assert(WM * WN * WK * 32 == NT, "8 warps");
  static_assert(MT >= 1 && NT8 >= 1 && BK % (8 * WK) == 0, "warp tile");
};
// Large tiles from kLargeRows rows on: 128 rows share each weight tile.
// Where that leaves too few tiles to fill the card (fewer than
// kFillTiles), medium tiles of 64 rows. Below kLargeRows, few rows make a
// product's time the latency of its chain of stages, not its work: the
// small tile takes 16 rows and 128-deep stages that four warp groups
// share, so a 256-deep product is two stages.
using Large = Cfg<128, 64, 32, 4, 2, 1, 3>;
using LargePromoted = Cfg<128, 64, 32, 4, 2, 1, 3, true>;  // weight gradients
using Medium = Cfg<64, 64, 32, 2, 2, 2, 3>;
using Small = Cfg<16, 32, 128, 1, 2, 4, 2>;
constexpr int kLargeRows = 1024, kFillTiles = 128;

// Floats of one stage's A and B tiles in shared memory.
template <class C, int LA>
__host__ __device__ constexpr int a_floats() {
  return LA == A_MK ? C::BM * (C::BK + 4) : C::BK * (C::BM + 8);
}
template <class C, int LB>
__host__ __device__ constexpr int b_floats() {
  return LB == B_KN ? C::BK * (C::BN + 8) : C::BN * (C::BK + 4);
}
__host__ __device__ constexpr int max_(int a, int b) { return a > b ? a : b; }
template <class C>  // room for either layout of each operand
__host__ __device__ constexpr int stage_floats() {
  return max_(a_floats<C, A_MK>(), a_floats<C, A_KM>()) +
         max_(b_floats<C, B_KN>(), b_floats<C, B_NK>());
}
// The ring, and one stage more for the low halves of the stage in use.
template <class C>
__host__ __device__ constexpr int smem_floats() {
  return (C::STAGES + 1) * stage_floats<C>();
}
// Shared memory of a CTA, for either tile shape: 108 KB, so that two CTAs
// fit on an SM.
constexpr size_t kSmemBytes =
    (size_t)max_(smem_floats<Large>(),
                 max_(smem_floats<Medium>(), smem_floats<Small>())) *
    sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory through L2; zero-filled if !ok.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float tf32_(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand of a product: base pointer, leading dimension.
struct Operand {
  const float* p;
  int ld;
};

// Stage kt of the tile at (m0, n0) into As / Bs.
template <class C, int LA, int LB>
__device__ __forceinline__ void load_stage(Operand a, Operand b, int M, int N,
                                           int K, int m0, int n0, int kt,
                                           float* As, float* Bs) {
  constexpr int BK = C::BK;
  const int k0 = kt * BK;
  if (LA == A_MK) {  // BM rows of BK/4 chunks
    for (int i = threadIdx.x; i < C::BM * (BK / 4); i += NT) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      cp16(As + r * (BK + 4) + c,
           ok ? a.p + (size_t)(m0 + r) * a.ld + k0 + c : a.p, ok);
    }
  } else {  // BK rows of BM/4 chunks
    for (int i = threadIdx.x; i < BK * (C::BM / 4); i += NT) {
      const int r = i / (C::BM / 4), c = (i % (C::BM / 4)) * 4;
      const bool ok = k0 + r < K && m0 + c < M;
      cp16(As + r * (C::BM + 8) + c,
           ok ? a.p + (size_t)(k0 + r) * a.ld + m0 + c : a.p, ok);
    }
  }
  if (LB == B_KN) {  // BK rows of BN/4 chunks
    for (int i = threadIdx.x; i < BK * (C::BN / 4); i += NT) {
      const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
      const bool ok = k0 + r < K && n0 + c < N;
      cp16(Bs + r * (C::BN + 8) + c,
           ok ? b.p + (size_t)(k0 + r) * b.ld + n0 + c : b.p, ok);
    }
  } else {  // BN rows of BK/4 chunks
    for (int i = threadIdx.x; i < C::BN * (BK / 4); i += NT) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = n0 + r < N && k0 + c < K;
      cp16(Bs + r * (BK + 4) + c,
           ok ? b.p + (size_t)(n0 + r) * b.ld + k0 + c : b.p, ok);
    }
  }
}

template <class C, int LA>
__device__ __forceinline__ float a_at(const float* As, int m, int k) {
  return LA == A_MK ? As[m * (C::BK + 4) + k] : As[k * (C::BM + 8) + m];
}
template <class C, int LB>
__device__ __forceinline__ float b_at(const float* Bs, int k, int n) {
  return LB == B_KN ? Bs[k * (C::BN + 8) + n] : Bs[n * (C::BK + 4) + k];
}

// The accumulators of one warp: acc[i][j][0..3] is m16n8 tile (i, j) in
// mma.sync's C layout (rows g and g + 8, columns 2q and 2q + 1, with
// g = lane / 4, q = lane % 4).
template <class C>
struct Acc {
  float v[C::MT][C::NT8][4];
};

// acc = A[m0:m0+BM, :K] @ B[:K, n0:n0+BN] for this CTA's tile, in the
// warps of reduction group 0 (the others' accumulators are spent). If
// colsum is non-null (B_KN only), threads below BN also add up column
// n0 + tid of B over the K rows, in order. Ends with the ring drained and
// the CTA synchronised, so smem may be reused at once.
//
// Each stage, once landed, is split in place: the ring keeps hi = tf32(x)
// and one more stage of smem takes lo = tf32(x - hi), so every element is
// split once and not once per warp that reads it.
template <class C, int LA, int LB>
__device__ __forceinline__ void tile_product(Operand a, Operand b, int M,
                                             int N, int K, int m0, int n0,
                                             float* smem, Acc<C>& acc,
                                             float* colsum = nullptr) {
  constexpr int SA = a_floats<C, LA>(), SS = stage_floats<C>();
  constexpr int SU = SA + b_floats<C, LB>();
  constexpr int STAGES = C::STAGES, WMN = C::WM * C::WN, BK = C::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wk = warp / WMN;
  const int wm = (warp % WMN / C::WN) * (C::BM / C::WM);
  const int wn = (warp % C::WN) * (C::BN / C::WN);
  float* lo = smem + STAGES * SS;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
  float cs = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C, LA, LB>(a, b, M, N, K, m0, n0, s, smem + s * SS,
                            smem + s * SS + SA);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is spent
    {
      const int nx = kt + STAGES - 1;
      if (nx < nk) {
        float* st = smem + (nx % STAGES) * SS;
        load_stage<C, LA, LB>(a, b, M, N, K, m0, n0, nx, st, st + SA);
      }
      cp_commit();
    }
    float* hi = smem + (kt % STAGES) * SS;
    if (colsum != nullptr) {
      if (threadIdx.x < C::BN) {
#pragma unroll 8
        for (int r = 0; r < BK; ++r) cs += b_at<C, LB>(hi + SA, r, threadIdx.x);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x * 4; i < SU; i += NT * 4) {
      const float4 v = *reinterpret_cast<const float4*>(hi + i);
      const float4 h = make_float4(tf32_(v.x), tf32_(v.y), tf32_(v.z), tf32_(v.w));
      *reinterpret_cast<float4*>(hi + i) = h;
      *reinterpret_cast<float4*>(lo + i) =
          make_float4(tf32_(v.x - h.x), tf32_(v.y - h.y), tf32_(v.z - h.z),
                      tf32_(v.w - h.w));
    }
    __syncthreads();

    Acc<C> stage_sum;  // this stage's sum, if promoted
    Acc<C>& part = C::PROMOTE ? stage_sum : acc;
    if (C::PROMOTE) {
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part.v[i][j][e] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < BK / (8 * C::WK); ++st) {
      const int kk = (st * C::WK + wk) * 8;
      uint32_t ah[C::MT][4], al[C::MT][4], bh[C::NT8][2], bl[C::NT8][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int r = wm + i * 16 + g;
        const int rr[4] = {r, r + 8, r, r + 8}, cc[4] = {q, q, q + 4, q + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[i][e] = __float_as_uint(a_at<C, LA>(hi, rr[e], kk + cc[e]));
          al[i][e] = __float_as_uint(a_at<C, LA>(lo, rr[e], kk + cc[e]));
        }
      }
#pragma unroll
      for (int j = 0; j < C::NT8; ++j) {
        const int n = wn + j * 8 + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bh[j][e] = __float_as_uint(b_at<C, LB>(hi + SA, kk + q + 4 * e, n));
          bl[j][e] = __float_as_uint(b_at<C, LB>(lo + SA, kk + q + 4 * e, n));
        }
      }
      // The two small terms first, then the large one; each pass over all
      // the warp's tiles, so that dependent products are far apart.
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j) mma(part.v[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j) mma(part.v[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j) mma(part.v[i][j], ah[i], bh[j]);
    }
    if (C::PROMOTE) {
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.v[i][j][e] += stage_sum.v[i][j][e];
    }
  }
  cp_wait<0>();
  __syncthreads();
  if (colsum != nullptr && threadIdx.x < C::BN) *colsum = cs;
  if (C::WK > 1) {  // group 0 adds the other groups' sums, in order
    constexpr int NA = C::MT * C::NT8 * 4;
    float* red = smem + (warp % WMN) * NA * 32 + lane;
    for (int w = 1; w < C::WK; ++w) {
      if (wk == w) {
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((i * C::NT8 + j) * 4 + e) * 32] = acc.v[i][j][e];
      }
      __syncthreads();
      if (wk == 0) {
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc.v[i][j][e] += red[((i * C::NT8 + j) * 4 + e) * 32];
      }
      __syncthreads();
    }
  }
}

// Calls ep(m, n, v0, v1) for the pairs (m, n), (m, n + 1) of the tile
// that lie inside M x N (n is even and N a multiple of 4, so a pair is
// inside or outside as a whole).
template <class C, class Ep>
__device__ __forceinline__ void tile_store(const Acc<C>& acc, int M, int N,
                                           int m0, int n0, Ep ep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  if (warp >= C::WM * C::WN) return;  // reduction groups 1.. hold no sums
  const int wm = m0 + (warp / C::WN) * (C::BM / C::WM);
  const int wn = n0 + (warp % C::WN) * (C::BN / C::WN);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j) {
      const int n = wn + j * 8 + 2 * q;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + i * 16 + g + 8 * h;
        if (m < M) ep(m, n, acc.v[i][j][2 * h], acc.v[i][j][2 * h + 1]);
      }
    }
}

template <class C>
__host__ __device__ inline int tiles_of(int M, int N) {
  return ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
}

}  // namespace tf32x3
