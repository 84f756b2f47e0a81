// The fused cVAE train step: forward and hand-derived backward of the
// packed multimodal cVAE, for every fold of a k-fold model at once.
//
// Replaces the Pallas kernels multi_modal_normative_modeling_tpu/kernels/
// train_step.py::_kernel (K5, fp32, whole batch in one block) and
// train_step_tiled.py::_tiled_kernel (K6, a grid over batch tiles, fp32 or
// bf16 operands). Per fold f and modality m (math of train_step.py:28-43):
//
//   encoders  a_0 = [x_m | c], a_{l+1} = lrelu(a_l W_l + b_l),
//             mu_m = a_L Wmu + bmu, lv_m = a_L Wlv + blv
//   fusion    (mu, lgv) of the M experts by poe / gpoe / moe / mopoe
//   reparam   z = mu + eps exp(lgv / 2)
//   decoders  g_0 = [z | c], g_{l+1} = lrelu(g_l V_l + c_l),
//             mean_m = g_L Vm + cm
//   loss      total = M kl - sum_m ll_m, masked means over n rows
//
// and every parameter gradient. The TPU kernel keeps the whole step in one
// block's VMEM. An H100 block has 227 KB of shared memory and one flagship
// modality's parameters alone are 377 KB, so here the step is a sequence of
// launches over (row tile, modality, fold) grids, activations and row
// gradients passing through a workspace in device memory.
//
// Layout. Every width the products touch (d_max, the hidden widths, the
// latent and covariate blocks of [x | c] and [z | c]) is padded by the
// caller to a multiple of 4 elements (16 in bf16), padded entries exactly
// zero, so every row of every operand starts on a 16-byte boundary and a
// tile is brought in with 16-byte cp.async copies. The fusion, the KL and
// eps run over the true latent width Z; the NLL over each modality's true
// feature width.
//
// The product routine (`product`, `wgrad_kernel`). A block of 256 threads
// owns 32 rows x 128 columns of an output, its 8 warps 2 x 4 tiles of 16
// rows x 32 columns. The next 32-deep chunk is in flight (cp.async, two
// stages) while this one is multiplied.
//   fp32 (K5, K6 fp32): FFMA. A warp's lanes are 4 row groups x 8 column
//   groups and a thread holds 4 x 4 accumulators. Operands are read from
//   shared memory as float4: the A rows along k (4 addresses a warp), the
//   weights along n (forward, W[k][n]) or along k on a stride of 36 floats
//   (backward, W[n][k]) (8 addresses a warp), so a warp's load is one
//   128-byte wavefront and free of bank conflicts (activation tiles are
//   strided 8 mod 16 floats for that): 64 FFMA for 8 128-bit loads of one
//   wavefront each. The FFMA pipe, not shared memory, is the limit.
//   bf16 (K6 bf16): tensor cores, mma.sync m16n8k16 with fp32 accumulation.
//   The tiles in shared memory hold bf16 values widened to fp32 (the
//   stored operands are bf16; gradient intermediates are rounded where the
//   TPU kernel casts them), so packing two of them into a bf16x2 register
//   is exact, and a warp's 16 x 32 x 16 step is 4 mma for 4 64-bit and 16
//   32-bit loads in place of 256 FFMA a thread. Widths are padded to 16
//   there, so a chunk is one or two k16 steps with no remainder.
//
// Two routes, chosen from the shapes (`plan`):
//   fused (flagship widths), seven launches:
//   1. enc_fwd   (tile, m, f): the encoder chain; stores a_1..a_L, mu, lv
//   2. fuse_fwd  (rows, f):    fusion, z, the per-row KL term
//   3. dec       (tile, m, f): the decoder chain, the mean head in 128-wide
//                column chunks with the NLL terms and dmean, dg = dmean Vm^T
//                accumulated over the chunks, the decoder backward chain
//   4. fuse_bwd  (rows, f):    sum_m dz_m, reparam + KL backward, fusion
//                backward to dmu_m, dlv_m, the per-row gpoe dalpha terms
//   5. enc_bwd   (tile, m, f): the encoder backward chain
//   6. wgrad     (tile, split, f*M + m): every weight gradient A^T dY and
//                every bias-like column sum, each output tile owned by one
//                block that loops over the rows of its split
//   7. finish    (f):          the losses and dalpha
//   wide (few row tiles, wide features: PPMI), ten launches: the wide
//   dimension goes to the grid. The first encoder layer is split over K
//   (enc0_split, partials summed in split order by enc_fwd); pass 3 becomes
//   dec_fwd, then mean (tile, column group, f*M + m: each block reads g_L
//   from the workspace, owns its columns' NLL terms and writes its partial
//   of dg), then dec_bwd (sums the dg partials in group order).
//
// No atomics: every sum has one owner and a fixed order, so two calls give
// bit-identical results. With split > 1 (K6's batch tiles) the weight
// gradients are per-split partials summed in split order by one more
// launch.
//
// Operands of type T (float, or __nv_bfloat16 for K6's bf16 path): the
// batch x and c, the weight matrices, and the stored activations a_l, g_l
// and z. Every product multiplies fp32 values converted from T (a product
// of two bf16 values is exact in fp32) and accumulates in fp32 by FFMA.
// Gradient intermediates (dmean, dy_l, dz_l, dmu_m, dlv_m) are stored fp32
// and rounded to T where a product reads them, as the TPU kernel casts them
// before its bf16 dots; biases, lvo, alpha, fusion, KL, reparam, the NLL
// and all gradients stay fp32.
//
// LeakyReLU's derivative comes from the sign of the stored activation
// (lrelu preserves sign). Padded feature columns are skipped by the NLL, so
// their dmean and dlvo terms are exactly zero; padded hidden, latent and
// covariate columns carry zero weights and zero activations, so every
// gradient entry in the padding is exactly zero; rows whose mask is 0
// contribute nothing.
//
// What bounds each pass on an H100 (fp32 FFMA 67 TFLOP/s, 3.35 TB/s), at
// the flagship (5 folds x 256 rows, 4 x [90, 90, 90, 270], H 110, C 29,
// Z 10; products at the true widths, 2 FLOP a multiply-add; the step reads
// and writes 5.6 MB, 1.7 us at the memory rate, so every product pass is
// bound by operations):
//   enc_fwd   0.33 GFLOP, 4.9 us at the FFMA peak. A block's chain is up to
//             22 dependent 32-deep chunks and 4 products: two stages and two
//             blocks an SM hide the chunk loads; what is left is each
//             product's first load and its epilogue's loads, which nothing
//             overlaps yet.
//   dec       0.61 GFLOP, 9.1 us: the decoder chain, the mean head with the
//             NLL and dg = dmean Vm^T per 128-column chunk, the backward
//             chain: 10 products and 38 chunks for the 270-wide modality,
//             22 for a 90-wide one. The widest modalities start first, so a
//             heavy block shares its SM with a light one. At PPMI width the
//             mean head alone is 0.30 GFLOP for 24 row-owned blocks: there
//             its columns go to the grid (mean_kernel).
//   enc_bwd   0.15 GFLOP, 2.2 us: three short products; latency.
//   wgrad     0.65 GFLOP, 9.7 us: 32 x 128 output tiles, each reading its
//             A and dY rows once; three blocks an SM. Larger (128 x 128)
//             tiles were tried: less traffic, but the padding of the narrow
//             outputs (Z 10, H 110, Z + C 39) to the tile costs more FFMA
//             than it saves at these widths.
//   fuse_fwd, fuse_bwd, finish: a few bytes a row; 16 lanes share a row and
//             the sums fold by shuffles; the latency of one launch each.
// Measured there, a step is 0.28 ms against the 26 us bound: skipping the
// multiply of every chunk takes a quarter off the row-owned passes, skipping
// the chunk loads almost nothing, and half remains with both skipped
// (scripts/torch_step_probe.py): about 5 us a product of exposed latency
// (its first load, its epilogue's loads, its barriers) and the launches.
// fp32 stays off the tensor cores. One TF32 pass keeps about three digits,
// fewer than the gradient check asks. Three passes (each operand split into
// a TF32 value and the TF32 value of the rest, every k8 step summed outside
// the tensor core, whose own accumulation truncates) held that check and
// took a step from 0.28 to 0.26 ms, but 20 Adam steps then ended 8.5e-05
// from the plain trainer's on one near-zero bias, over the trajectory
// check's 5e-05: not kept.
//
// This header holds all of it as templates over T; train_step.cu
// instantiates the fp32 step and the C entry points, train_step_bf16.cu the
// bf16 step, so that the two compile side by side.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace mmnm_ts {

constexpr int TM = 32;            // rows per block of the row-owned passes
constexpr int BN = 128;           // output columns per product pass
constexpr int BK = 32;            // reduction chunk staged in shared memory
constexpr int THREADS = 256;      // 8 warps, 2 x 4 tiles of 16 rows x 32 columns
constexpr int RM = 4;             // rows per thread (FFMA)
constexpr int RN = 4;             // columns per thread (FFMA)
constexpr int LDA = BK + 4;       // stride of a staged k-contiguous tile
constexpr int LDW = BN + 4;       // stride of a staged n-contiguous tile
constexpr int DMS = BN + 8;       // stride of the dmean tile
// one stage: the A tile [TM][LDA], then the weight tile, [BK][LDW]
// (forward) or [BN][LDA] (backward, the larger)
constexpr int STAGE_FLOATS = TM * LDA + BN * LDA;
constexpr int STAGES = 2;
constexpr int MAX_L = 3;
constexpr int MAX_M = 8;
constexpr int MAX_JOBS = 4 * MAX_L + 8;
constexpr int ROW_THREADS = 128;  // threads of a block of the fusion passes
constexpr int ROW_LANES = 16;     // lanes that share a row there
constexpr int ROWS_PER_BLOCK = ROW_THREADS / ROW_LANES;
constexpr int SMS = 132;          // blocks the wide route aims to launch
constexpr float HALF_LOG_2PI = 0.9189385332046727f;

enum Combine { POE = 0, GPOE = 1, MOE = 2, MOPOE = 3 };
enum Mode { NN = 0, NT = 1 };     // W[k][n] (forward) or W[n][k] (backward)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T's precision, kept as float
template <class T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.01f * v;
}
__device__ __forceinline__ float dleaky(float a) {
  return a > 0.f ? 1.f : 0.01f;
}
__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// bf16 operands go to the tensor cores, fp32 operands to FFMA.
template <class T> struct UseMma { static constexpr bool value = false; };
template <> struct UseMma<__nv_bfloat16> { static constexpr bool value = true; };

// Where a thread stands in its block's 2 x 4 warps: (wr, wc) the warp's
// tile; (lr, lc) the lane's row and column group of the FFMA layout; (g, t)
// the lane's group and place in it of the mma fragments.
struct Lanes {
  int wr, wc, lr, lc, g, t;
  __device__ Lanes() {
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    wr = w >> 2;
    wc = w & 3;
    lr = lane >> 3;
    lc = lane & 7;
    g = lane >> 2;
    t = lane & 3;
  }
};

// Two fp32 values that are exact in bf16, packed (lo in the low half).
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack2(v.x, v.y);
}
// acc += A (16 x 16, row) B (16 x 8, col), bf16 in, fp32 out.
__device__ __forceinline__ void mma16816(float* acc, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 16-byte copies into shared memory --------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements of type T (or of an fp32 gradient intermediate
// that a product reads rounded to T) into four floats of shared memory; `ok`
// false stores zeros and reads nothing (src must still be a valid address).
template <class T> struct Ld;
template <> struct Ld<float> {
  static __device__ __forceinline__ void tile4(float* dst, const float* src,
                                               bool ok) {
    cp_async16(dst, src, ok);
  }
  static __device__ __forceinline__ void tile4_f32(float* dst,
                                                   const float* src, bool ok,
                                                   bool) {
    cp_async16(dst, src, ok);
  }
};
template <> struct Ld<__nv_bfloat16> {
  static __device__ __forceinline__ void tile4(float* dst,
                                               const __nv_bfloat16* src,
                                               bool ok) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                      __high2float(hi));
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
  static __device__ __forceinline__ void tile4_f32(float* dst,
                                                   const float* src, bool ok,
                                                   bool round) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      v = *reinterpret_cast<const float4*>(src);
      if (round) {
        v = make_float4(rnd<__nv_bfloat16>(v.x), rnd<__nv_bfloat16>(v.y),
                        rnd<__nv_bfloat16>(v.z), rnd<__nv_bfloat16>(v.w));
      }
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
};

struct Dims {
  int F, M, B, L;
  int Z;                  // true latent width (fusion, KL, eps)
  int Zp, Cp, DM;         // padded latent, covariate and feature widths
  int combine;
  int split_rows;         // rows per weight-gradient split
  int wide;               // 1: the wide route
  int enc0_splits;        // K splits of the first encoder layer (wide)
  int enc0_kper;          // K per split, a multiple of BK
  int col_groups;         // column groups of the mean head (wide)
  int cols_per_group;     // a multiple of BN
  int dims[MAX_M];        // each modality's true width (<= DM)
  int order[MAX_M];       // the modalities, widest first
  int H[MAX_L];           // encoder hidden widths (padded)
  __device__ __host__ int kin(int l) const { return l == 0 ? DM + Cp : H[l - 1]; }
  __device__ __host__ int hr(int l) const { return H[L - 1 - l]; }
  __device__ __host__ int kdec(int l) const { return l == 0 ? Zp + Cp : hr(l - 1); }
  __device__ __host__ int widest() const {
    int w = 2 * Zp;       // enc_bwd stages [dmu | dlv] in an activation tile
    for (int l = 0; l < L; ++l) w = H[l] > w ? H[l] : w;
    return w;
  }
  // Stride of an activation tile: 8 mod 16 floats, so that the 4 rows a
  // warp reads as float4 (and the 8 it reads as float2) fall in distinct
  // banks.
  __device__ __host__ int tile_ld() const {
    const int w = widest();
    return w + (24 - w % 16) % 16;
  }
};

// Parameters (weights of type T) or their gradients (float), every tensor
// [F, M, ...] contiguous at the padded widths.
template <class W>
struct Net {
  W* enc_w[MAX_L];
  float* enc_b[MAX_L];
  W* wmu;
  float* bmu;
  W* wlv;
  float* blv;
  W* dec_w[MAX_L];
  float* dec_b[MAX_L];
  W* vm;
  float* cm;
  float* lvo;
  float* alpha;
};

template <class T>
struct Batch {
  const T* x;            // [F, M, B, DM]
  const T* c;            // [F, B, Cp]
  const float* eps;      // [F, B, Z]
  const float* rm;       // [F, B]
  const float* n;        // [F]
};

template <class T>
struct Scratch {
  float* enc0_part;      // [enc0_splits, F, M, B, H_0] (wide)
  T* act_enc[MAX_L];     // a_{l+1}   [F, M, B, H_l]
  float* mus;            // [F, M, B, Zp]
  float* lvs;
  float* fmu;            // fused     [F, B, Z]
  float* flgv;
  T* z;                  // [F, B, Zp]
  float* kl_rows;        // [F, B]
  T* act_dec[MAX_L];     // g_{l+1}   [F, M, B, HR_l]
  float* dmean;          // [F, M, B, DM]
  float* e_lvo;          // dlvo terms [F, M, B, DM]
  float* ll_rows;        // [col_groups, F, M, B]
  float* dg_part;        // [col_groups, F, M, B, HR_{L-1}] (wide)
  float* dy_dec[MAX_L];  // [F, M, B, HR_l]
  float* dz;             // [F, M, B, Zp]
  float* dmus;           // [F, M, B, Zp]
  float* dlvs;
  float* ds_rows;        // [F, B, M]
  float* dz_enc[MAX_L];  // [F, M, B, H_l]
  float* part;           // [split, grads] weight-gradient partials
};

// ---- A operands ---------------------------------------------------------------

// Rows of an activation tile in shared memory (ld a multiple of 4).
struct ASmem {
  const float* h;
  int ld;
};

// Rows of [p | q] in device memory: p's first P columns, then q; the
// product starts at column koff; rows past `rows` read as zero.
template <class T>
struct AGlobal {
  const T* p;
  const T* q;
  int P, ldp, ldq, rows, koff;
};

__device__ __forceinline__ const float* a_rows(const ASmem& a, const float*,
                                               int r, int k0) {
  return a.h + r * a.ld + k0;
}
template <class T>
__device__ __forceinline__ const float* a_rows(const AGlobal<T>&,
                                               const float* as, int r, int) {
  return as + r * LDA;
}

// One 16-byte group per thread: TM rows x BK / 4 groups = THREADS.
template <class T>
__device__ __forceinline__ void stage_a(float* as, const AGlobal<T>& a,
                                        int k0, int K) {
  const int r = threadIdx.x / (BK / 4);
  const int g = threadIdx.x % (BK / 4);
  const int k = k0 + 4 * g;
  const bool ok = r < a.rows && k < K;
  const T* src = a.p;
  if (ok) {
    const int kg = a.koff + k;
    src = kg < a.P ? a.p + (size_t)r * a.ldp + kg
                   : a.q + (size_t)r * a.ldq + (kg - a.P);
  }
  Ld<T>::tile4(as + r * LDA + 4 * g, src, ok);
}
__device__ __forceinline__ void stage_a(float*, const ASmem&, int, int) {}

// The weight tile of chunk k0 and column block n0: [BK][LDW] of W[k][n]
// (forward) or [BN][LDA] of W[n][k] (backward); out of range zero-filled.
template <int MODE, class T>
__device__ __forceinline__ void stage_w(float* ws, const T* w, int ld, int k0,
                                        int K, int n0, int N) {
  if (MODE == NN) {
    for (int e = threadIdx.x; e < BK * (BN / 4); e += THREADS) {
      const int kk = e / (BN / 4);
      const int g = e % (BN / 4);
      const int k = k0 + kk;
      const int n = n0 + 4 * g;
      const bool ok = k < K && n < N;
      Ld<T>::tile4(ws + kk * LDW + 4 * g, ok ? w + (size_t)k * ld + n : w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BN * (BK / 4); e += THREADS) {
      const int nn = e / (BK / 4);
      const int g = e % (BK / 4);
      const int n = n0 + nn;
      const int k = k0 + 4 * g;
      const bool ok = n < N && k < K;
      Ld<T>::tile4(ws + nn * LDA + 4 * g, ok ? w + (size_t)n * ld + k : w, ok);
    }
  }
}

// One staged chunk of the FFMA product: acc[i][j] over rows
// 16 wr + lr + 4 i and columns 32 wc + 4 lc + j (forward) or
// 32 wc + lc + 8 j (backward).
template <int MODE>
__device__ __forceinline__ void chunk_ffma(float (&acc)[RM][RN],
                                           const float* const (&ap)[RM],
                                           const float* ws, int kc,
                                           const Lanes& ln) {
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 4) {
    float4 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(ap[i] + kk);
    }
    if (MODE == NN) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + (kk + q) * LDW + 32 * ln.wc + 4 * ln.lc);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float ai = comp(av[i], q);
          acc[i][0] = fmaf(ai, wv.x, acc[i][0]);
          acc[i][1] = fmaf(ai, wv.y, acc[i][1]);
          acc[i][2] = fmaf(ai, wv.z, acc[i][2]);
          acc[i][3] = fmaf(ai, wv.w, acc[i][3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + (32 * ln.wc + ln.lc + 8 * j) * LDA + kk);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][j] = fmaf(av[i].x, wv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, wv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, wv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, wv.w, acc[i][j]);
        }
      }
    }
  }
}

// One staged chunk of the tensor-core product: acc[nt][c] is the mma
// accumulator of the warp's n8 tile nt, rows 16 wr + g + 8 (c / 2), columns
// 32 wc + 8 nt + 2 t + c % 2. a0 and a1 are the rows 16 wr + g and + 8; kc
// is 16 or 32.
template <int MODE>
__device__ __forceinline__ void chunk_mma(float (&acc)[RM][RN],
                                          const float* a0, const float* a1,
                                          const float* ws, int kc,
                                          const Lanes& ln) {
  for (int ks = 0; ks < kc; ks += 16) {
    const int k = ks + 2 * ln.t;
    const unsigned a[4] = {pack2(a0 + k), pack2(a1 + k), pack2(a0 + k + 8),
                           pack2(a1 + k + 8)};
#pragma unroll
    for (int nt = 0; nt < RM; ++nt) {
      const int n = 32 * ln.wc + 8 * nt + ln.g;
      unsigned b0, b1;
      if (MODE == NN) {
        b0 = pack2(ws[k * LDW + n], ws[(k + 1) * LDW + n]);
        b1 = pack2(ws[(k + 8) * LDW + n], ws[(k + 9) * LDW + n]);
      } else {
        b0 = pack2(ws + n * LDA + k);
        b1 = pack2(ws + n * LDA + k + 8);
      }
      mma16816(acc[nt], a, b0, b1);
    }
  }
}

// out[r, n] = sum_{k < K} a(r, k) w(k, n) over the tile's TM rows, n < N,
// handed to epi(slot, r, n, value), slot indexing the thread's rows (at
// most RM). N and K are multiples of 4 (of 16 in bf16). `stage` holds
// STAGES stages. Ends with __syncthreads, so the next product may read
// what epi wrote.
template <int MODE, class T, class AOp, class Epi>
__device__ void product(const AOp& a, const T* w, int ldw, int N, int K,
                        float* stage, Epi& epi) {
  constexpr bool MMA = UseMma<T>::value;
  const Lanes ln;
  const int nchunks = (K + BK - 1) / BK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    }
    // output (i, j) of this thread: its row slot, row and column
    auto where = [&](int i, int j, int& slot, int& r, int& n) {
      if (MMA) {
        slot = j >> 1;
        r = 16 * ln.wr + ln.g + 8 * slot;
        n = n0 + 32 * ln.wc + 8 * i + 2 * ln.t + (j & 1);
      } else {
        slot = i;
        r = 16 * ln.wr + ln.lr + 4 * i;
        n = n0 + 32 * ln.wc + (MODE == NN ? 4 * ln.lc + j : ln.lc + 8 * j);
      }
    };
    stage_a(stage, a, 0, K);
    stage_w<MODE>(stage + TM * LDA, w, ldw, 0, K, n0, N);
    cp_async_commit();
    for (int c = 0; c < nchunks; ++c) {
      const float* cur = stage + (c & 1) * STAGE_FLOATS;
      if (c + 1 < nchunks) {
        float* nxt = stage + ((c + 1) & 1) * STAGE_FLOATS;
        stage_a(nxt, a, (c + 1) * BK, K);
        stage_w<MODE>(nxt + TM * LDA, w, ldw, (c + 1) * BK, K, n0, N);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int k0 = c * BK;
      const int kc = min(BK, K - k0);
      const float* ws = cur + TM * LDA;
      if (n0 + 32 * ln.wc >= N) {
        // none of this warp's 32 columns exists: it only keeps the barriers
      } else if (MMA) {
        chunk_mma<MODE>(acc, a_rows(a, cur, 16 * ln.wr + ln.g, k0),
                        a_rows(a, cur, 16 * ln.wr + ln.g + 8, k0), ws, kc, ln);
      } else {
        const float* ap[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          ap[i] = a_rows(a, cur, 16 * ln.wr + ln.lr + 4 * i, k0);
        }
        chunk_ffma<MODE>(acc, ap, ws, kc, ln);
      }
      __syncthreads();
    }
    // what the epilogue reads from memory, for all 16 outputs before any
    // of them is stored: the loads overlap instead of queueing behind the
    // stores (asking for them before the last chunk's products was tried
    // and was no faster: it costs registers in the inner loop)
    typename Epi::Pre pre[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        int slot, r, n;
        where(i, j, slot, r, n);
        if (n < N) pre[i][j] = epi.load(r, n);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        int slot, r, n;
        where(i, j, slot, r, n);
        if (n < N) epi(slot, r, n, acc[i][j], pre[i][j]);
      }
    }
  }
  __syncthreads();
}

// Four consecutive stored elements as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
template <class T> __device__ __forceinline__ float4 rnd4(const float4& v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

// use(e, load(e)) for e < total, strided over the block's threads, U
// elements a thread at a time with their loads issued together.
template <int U, class Load, class Use>
__device__ __forceinline__ void tile_for(int total, Load load, Use use) {
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) v[u] = load(e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) use(e, v[u]);
    }
  }
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}
// Four floats stored as T.
__device__ __forceinline__ void st4(float* p, const float4& v) { at4(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4& v) {
  uint2 raw;
  raw.x = pack2(v.x, v.y);
  raw.y = pack2(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The step back through a LeakyReLU layer for a row tile: v = da * lrelu'(a)
// from the stored activation a [rows, N]; v stored to dy (valid rows) and,
// rounded to T, into the shared tile dyt. Ends with __syncthreads.
template <class T>
__device__ void back_through_lrelu(const float* da, float* dyt, int ld,
                                   const T* act, float* dy, int N, int rows) {
  const int N4 = N / 4;
  tile_for<4>(
      TM * N4,
      [&](int e) {
        const int r = e / N4;
        return r < rows ? ld4(act + (size_t)r * N + (e % N4) * 4) : zero4();
      },
      [&](int e, const float4& a) {
        const int r = e / N4;
        const int n = (e % N4) * 4;
        float4 v = zero4();
        if (r < rows) {
          const float4 g = ld4(da + r * ld + n);
          v = make_float4(g.x * dleaky(a.x), g.y * dleaky(a.y),
                          g.z * dleaky(a.z), g.w * dleaky(a.w));
          at4(dy + (size_t)r * N + n) = v;
        }
        at4(dyt + r * ld + n) = rnd4<T>(v);
      });
  __syncthreads();
}

// The sum over a tile's columns of what each thread gathered per row slot
// in a product's epilogue (`part`): lanes that share a row first, then the
// 4 warps across, in a fixed order. red is [TM][4] floats of shared memory;
// rows[r] is complete after the closing __syncthreads.
template <class T>
__device__ void row_sums(const float* part, float* red, float* rows) {
  const Lanes ln;
  if (UseMma<T>::value) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v = part[s];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (ln.t == 0) red[(16 * ln.wr + ln.g + 8 * s) * 4 + ln.wc] = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float v = part[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (ln.lc == 0) red[(16 * ln.wr + ln.lr + 4 * i) * 4 + ln.wc] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    const float* r = red + threadIdx.x * 4;
    rows[threadIdx.x] = ((r[0] + r[1]) + r[2]) + r[3];
  }
  __syncthreads();
}

// ---- epilogues -------------------------------------------------------------

// An epilogue has load(r, n), what it reads from memory for one output,
// and operator()(slot, r, n, value, loaded).

// A hidden layer: lrelu(v + b), rounded to T, into a shared tile and into
// the stored activation (valid rows).
template <class T>
struct ActOut {
  float* h;
  int ld;
  const float* b;
  T* g;      // [rows, N]
  int N;
  int rows;
  typedef float Pre;
  __device__ float load(int, int n) const { return b[n]; }
  __device__ void operator()(int, int r, int n, float v, float bias) {
    const T a = from_f<T>(leaky(v + bias));
    h[r * ld + n] = to_f(a);
    if (r < rows) g[(size_t)r * N + n] = a;
  }
};

// A head or a partial product: v (+ b) into a row-major [rows, N] output.
struct RowsOut {
  const float* b;   // may be null
  float* out;
  int N;
  int rows;
  typedef float Pre;
  __device__ float load(int, int n) const { return b ? b[n] : 0.f; }
  __device__ void operator()(int, int r, int n, float v, float bias) {
    if (r < rows) out[(size_t)r * N + n] = v + bias;
  }
};

// A product into a shared tile (set, or added to what is there), no bias.
struct ToSmem {
  float* h;
  int ld;
  bool add;
  typedef float Pre;
  __device__ float load(int r, int n) const {
    return add ? h[r * ld + n] : 0.f;
  }
  __device__ void operator()(int, int r, int n, float v, float was) {
    h[r * ld + n] = v + was;
  }
};

// The mean head of one 128-wide column chunk: the masked Gaussian NLL terms
// (summed per thread and row), dmean and the dlvo terms stored, dmean
// rounded to T into a shared tile for dg.
template <class T>
struct NllChunk {
  const T* x;          // the tile's rows of x, stride DM
  const float* cm;
  const float* lvo;
  const float* rm;     // the tile's rows of the row mask
  float* dmean;        // the tile's rows, stride DM
  float* e_lvo;
  float* dm;           // shared [TM][DMS]
  int DM, c0, width, rows;
  float inv_n;
  float part[RM];
  typedef float Pre;
  __device__ float load(int r, int n) const {
    const int col = c0 + n;
    return (r < rows && col < width) ? to_f(x[(size_t)r * DM + col]) : 0.f;
  }
  __device__ void operator()(int i, int r, int n, float v, float xv) {
    const int col = c0 + n;
    float dmv = 0.f;
    float ev = 0.f;
    if (r < rows && col < width) {
      const float lv = lvo[col];
      const float q = expf(-lv);
      const float d = xv - (v + cm[col]);
      const float m = rm[r];
      part[i] += m * (-0.5f * d * d * q - 0.5f * lv - HALF_LOG_2PI);
      dmv = -(m * q * d) * inv_n;
      ev = m * (0.5f * d * d * q - 0.5f);
    }
    if (r < rows) {
      dmean[(size_t)r * DM + col] = dmv;
      e_lvo[(size_t)r * DM + col] = ev;
    }
    dm[r * DMS + n] = rnd<T>(dmv);
  }
};

// Where a (row tile, modality, fold) block stands.
struct Tile {
  int f, m, row0, rows;
  size_t fm, frow, fmrow;
  // A block of a (row tile, modality, fold) grid. The grid's linear order
  // is read as (tile, fold, rank), the modalities ranked by width, widest
  // first: the heaviest blocks start first and share their SM with a light
  // one of the second wave, not with each other.
  static __device__ Tile of_grid(const Dims& d) {
    const int lin =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const int tiles = gridDim.x;
    return Tile(d, lin % tiles, d.order[lin / (tiles * d.F)],
                (lin / tiles) % d.F);
  }
  __device__ Tile(const Dims& d, int tile, int m_, int f_) {
    f = f_;
    m = m_;
    row0 = tile * TM;
    rows = min(TM, d.B - row0);
    fm = (size_t)f * d.M + m;
    frow = (size_t)f * d.B + row0;
    fmrow = fm * d.B + row0;
  }
};

// ---- 1. encoder forward ------------------------------------------------------

// One K split of the first encoder layer's product (wide route): the raw
// partial sums, no bias.
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
enc0_split_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  const int fm = blockIdx.z;
  const Tile t(d, blockIdx.x, fm % d.M, fm / d.M);
  const int split = blockIdx.y;
  const int K = d.kin(0);
  const int N = d.H[0];
  const int kb = split * d.enc0_kper;
  const int ke = min(K, kb + d.enc0_kper);
  const AGlobal<T> in{bt.x + t.fmrow * d.DM, bt.c + t.frow * d.Cp, d.DM, d.DM,
                      d.Cp, t.rows, kb};
  RowsOut epi{nullptr,
              s.enc0_part +
                  (((size_t)split * d.F * d.M + t.fm) * d.B + t.row0) * N,
              N, t.rows};
  product<NN>(in, net.enc_w[0] + (t.fm * K + kb) * N, N, N, ke - kb, smem,
              epi);
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
enc_fwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  const int ld = d.tile_ld();
  float* h0 = smem + STAGES * STAGE_FLOATS;
  float* h1 = h0 + TM * ld;
  const Tile t = Tile::of_grid(d);

  const float* cur = nullptr;
  for (int l = 0; l < d.L; ++l) {
    const int K = d.kin(l);
    const int N = d.H[l];
    float* out = (l % 2 == 0) ? h0 : h1;
    const float* b = net.enc_b[l] + t.fm * N;
    T* act = s.act_enc[l] + t.fmrow * N;
    const T* w = net.enc_w[l] + t.fm * K * N;
    if (l == 0 && d.wide) {
      // the K splits' partials, summed in split order
      const size_t per = (size_t)d.F * d.M * d.B * N;
      const float* part = s.enc0_part + t.fmrow * N;
      const int N4 = N / 4;
      const int splits = d.enc0_splits;
      tile_for<2>(
          TM * N4,
          [&](int e) {
            const int r = e / N4;
            float4 v = zero4();
            if (r < t.rows) {
              const float* at = part + (size_t)r * N + (e % N4) * 4;
              for (int k = 0; k < splits; ++k) v = add4(v, ld4(at + k * per));
            }
            return v;
          },
          [&](int e, const float4& v) {
            const int r = e / N4;
            const int n = (e % N4) * 4;
            const float4 bias = ld4(b + n);
            const float4 a = rnd4<T>(make_float4(
                leaky(v.x + bias.x), leaky(v.y + bias.y), leaky(v.z + bias.z),
                leaky(v.w + bias.w)));
            at4(out + r * ld + n) = a;
            if (r < t.rows) st4(act + (size_t)r * N + n, a);
          });
      __syncthreads();
    } else {
      ActOut<T> epi{out, ld, b, act, N, t.rows};
      if (l == 0) {
        const AGlobal<T> in{bt.x + t.fmrow * d.DM, bt.c + t.frow * d.Cp, d.DM,
                            d.DM, d.Cp, t.rows, 0};
        product<NN>(in, w, N, N, K, stage, epi);
      } else {
        product<NN>(ASmem{cur, ld}, w, N, N, K, stage, epi);
      }
    }
    cur = out;
  }
  const int HL = d.H[d.L - 1];
  RowsOut mu{net.bmu + t.fm * d.Zp, s.mus + t.fmrow * d.Zp, d.Zp, t.rows};
  product<NN>(ASmem{cur, ld}, net.wmu + t.fm * HL * d.Zp, d.Zp, d.Zp, HL,
              stage, mu);
  RowsOut lv{net.blv + t.fm * d.Zp, s.lvs + t.fmrow * d.Zp, d.Zp, t.rows};
  product<NN>(ASmem{cur, ld}, net.wlv + t.fm * HL * d.Zp, d.Zp, d.Zp, HL,
              stage, lv);
}

// ---- 2. fusion + reparameterization + KL ----------------------------------

// gPoE weights: softmax of alpha[f] (max-shifted, as the TPU kernel).
__device__ inline void softmax_alpha(const float* alpha, int M, float* s) {
  float amax = alpha[0];
  for (int m = 1; m < M; ++m) amax = fmaxf(amax, alpha[m]);
  float sum = 0.f;
  for (int m = 0; m < M; ++m) {
    s[m] = expf(alpha[m] - amax);
    sum += s[m];
  }
  for (int m = 0; m < M; ++m) s[m] = s[m] / sum;
}

// The fused (mu, lgv) of one row and latent dim from the experts' stats.
__device__ inline void fuse_one(int combine, int M, const float* mus,
                         const float* lvs, const float* s, float& mu,
                         float& lgv) {
  if (M == 1) {
    mu = mus[0];
    lgv = lvs[0];
  } else if (combine == MOE) {
    float smu = 0.f, var = 0.f;
    for (int m = 0; m < M; ++m) {
      smu += mus[m];
      var += expf(lvs[m]);
    }
    mu = smu / M;
    lgv = logf(var / M);
  } else if (combine == MOPOE) {
    float tsum = 0.f, tmu = 0.f, smu = 0.f, svar = 0.f;
    for (int m = 0; m < M; ++m) {
      const float v = expf(lvs[m]);
      const float t = 1.f / v;
      tsum += t;
      tmu += t * mus[m];
      smu += mus[m];
      svar += v;
    }
    const float mu_p = tmu / tsum;
    mu = (smu + mu_p) / (M + 1);
    lgv = logf((svar + 1.f / tsum) / (M + 1));
  } else {  // poe / gpoe over precisions
    float P = 0.f, pmu = 0.f;
    for (int m = 0; m < M; ++m) {
      const float p = s[m] * expf(-lvs[m]);
      P += p;
      pmu += p * mus[m];
    }
    mu = pmu / P;
    lgv = -logf(P);
  }
}

// The fusion passes give a row to ROW_LANES lanes of a warp: lane j takes
// the latent dims j, j + ROW_LANES, ...; the row's sums over the latent
// dims are folded across the lanes in a fixed order.
__device__ __forceinline__ float row_fold(float v) {
#pragma unroll
  for (int off = ROW_LANES / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
fuse_fwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  const int f = blockIdx.y;
  const int b = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_LANES;
  const int lane = threadIdx.x % ROW_LANES;
  const bool live = b < d.B;
  const int M = d.M;
  const int Z = d.Z;
  const int Zp = d.Zp;
  float sw[MAX_M];
  for (int m = 0; m < M; ++m) sw[m] = 1.f;
  if (d.combine == GPOE) softmax_alpha(net.alpha + (size_t)f * M, M, sw);
  const size_t fb = (size_t)f * d.B + b;
  float kl = 0.f;
  for (int k = lane; live && k < Zp; k += ROW_LANES) {
    if (k >= Z) {
      s.z[fb * Zp + k] = from_f<T>(0.f);
      continue;
    }
    float mus[MAX_M], lvs[MAX_M];
    for (int m = 0; m < M; ++m) {
      const size_t at = (((size_t)f * M + m) * d.B + b) * Zp + k;
      mus[m] = s.mus[at];
      lvs[m] = s.lvs[at];
    }
    float mu, lgv;
    fuse_one(d.combine, M, mus, lvs, sw, mu, lgv);
    const float half = expf(0.5f * lgv);
    s.z[fb * Zp + k] = from_f<T>(mu + bt.eps[fb * Z + k] * half);
    s.fmu[fb * Z + k] = mu;
    s.flgv[fb * Z + k] = lgv;
    kl += 1.f + lgv - mu * mu - expf(lgv);
  }
  kl = row_fold(kl);
  if (live && lane == 0) s.kl_rows[fb] = -0.5f * kl;
}

// ---- 3. decoder forward, mean head + NLL, decoder backward -----------------

// Shared memory of the decoder passes: the stages, three activation tiles
// of the widest hidden layer and the dmean tile.
struct DecSmem {
  float* stage;
  float* buf[3];
  float* dm;       // [TM][DMS]
  int ld;
  __device__ DecSmem(float* smem, const Dims& d) {
    ld = d.tile_ld();
    stage = smem;
    buf[0] = smem + STAGES * STAGE_FLOATS;
    buf[1] = buf[0] + TM * ld;
    buf[2] = buf[1] + TM * ld;
    dm = buf[2] + TM * ld;
  }
};

// The forward chain on [z | c]; returns the tile holding g_L.
template <class T>
__device__ const float* dec_forward(const Dims& d, const Net<const T>& net,
                                    const Batch<T>& bt, const Scratch<T>& s,
                                    const Tile& t, const DecSmem& sm) {
  const AGlobal<T> in{s.z + t.frow * d.Zp, bt.c + t.frow * d.Cp, d.Zp, d.Zp,
                      d.Cp, t.rows, 0};
  const float* cur = nullptr;
  for (int l = 0; l < d.L; ++l) {
    const int K = d.kdec(l);
    const int N = d.hr(l);
    float* out = sm.buf[l % 2];
    ActOut<T> epi{out, sm.ld, net.dec_b[l] + t.fm * N,
                  s.act_dec[l] + t.fmrow * N, N, t.rows};
    const T* w = net.dec_w[l] + t.fm * K * N;
    if (l == 0) {
      product<NN>(in, w, N, N, K, sm.stage, epi);
    } else {
      product<NN>(ASmem{cur, sm.ld}, w, N, N, K, sm.stage, epi);
    }
    cur = out;
  }
  return cur;
}

// The mean head over columns [c_lo, c_hi) in chunks of BN: the NLL terms,
// dmean and the dlvo terms of those columns, dg = dmean Vm^T over them into
// sm.buf[2], and their share of the per-row ll into ll_rows.
template <class T>
__device__ void mean_head(const Dims& d, const Net<const T>& net,
                          const Batch<T>& bt, const Scratch<T>& s,
                          const Tile& t, const DecSmem& sm, const float* gl,
                          int c_lo, int c_hi, float* ll_rows) {
  const int tid = threadIdx.x;
  const int HL = d.hr(d.L - 1);
  const int width = d.dims[t.m];   // columns past it are padding: skipped
  float* dg = sm.buf[2];
  const T* vm = net.vm + t.fm * HL * d.DM;
  NllChunk<T> nll{bt.x + t.fmrow * d.DM, net.cm + t.fm * d.DM,
                  net.lvo + t.fm * d.DM, bt.rm + t.frow,
                  s.dmean + t.fmrow * d.DM, s.e_lvo + t.fmrow * d.DM, sm.dm,
                  d.DM, 0, width, t.rows, 1.f / bt.n[t.f], {}};
#pragma unroll
  for (int i = 0; i < RM; ++i) nll.part[i] = 0.f;
  bool first = true;
  for (int c0 = c_lo; c0 < c_hi; c0 += BN) {
    const int ncols = min(BN, c_hi - c0);
    if (c0 >= width) {
      // a chunk of padding: dmean and the dlvo terms are zero
      for (int e = tid; e < t.rows * ncols; e += THREADS) {
        const size_t at = (t.fmrow + e / ncols) * d.DM + c0 + e % ncols;
        s.dmean[at] = 0.f;
        s.e_lvo[at] = 0.f;
      }
      continue;
    }
    nll.c0 = c0;
    product<NN>(ASmem{gl, sm.ld}, vm + c0, d.DM, ncols, HL, sm.stage, nll);
    ToSmem acc{dg, sm.ld, !first};
    product<NT>(ASmem{sm.dm, DMS}, vm + c0, d.DM, HL, ncols, sm.stage, acc);
    first = false;
  }
  if (first) {
    for (int e = tid; e < TM * HL; e += THREADS) {
      dg[(e / HL) * sm.ld + e % HL] = 0.f;
    }
    __syncthreads();
  }
  // per-row ll (the stages are free: every product is done)
  float* red = sm.stage;
  float* sums = red + TM * 4;
  row_sums<T>(nll.part, red, sums);
  if (tid < t.rows) ll_rows[t.fmrow + tid] = sums[tid];
}

// The decoder backward chain from dg in sm.buf[2]: dy_l = dg * lrelu'(g_{l+1})
// stored, dg = dy_l V_l^T, down to dz_m.
template <class T>
__device__ void dec_backward(const Dims& d, const Net<const T>& net,
                             const Scratch<T>& s, const Tile& t,
                             const DecSmem& sm) {
  const int ld = sm.ld;
  int g_at = 2, y_at = 0, n_at = 1;
  for (int l = d.L - 1; l >= 0; --l) {
    const int N = d.hr(l);
    const int K = d.kdec(l);
    const float* gcur = sm.buf[g_at];
    float* dyt = sm.buf[y_at];
    const T* act = s.act_dec[l] + t.fmrow * N;
    float* dy = s.dy_dec[l] + t.fmrow * N;
    back_through_lrelu<T>(gcur, dyt, ld, act, dy, N, t.rows);
    const T* w = net.dec_w[l] + t.fm * K * N;
    if (l > 0) {
      ToSmem epi{sm.buf[n_at], ld, false};
      product<NT>(ASmem{dyt, ld}, w, N, K, N, sm.stage, epi);
      const int tmp = g_at;
      g_at = n_at;
      n_at = tmp;
    } else {
      // the z rows of d[z | c]
      RowsOut epi{nullptr, s.dz + t.fmrow * d.Zp, d.Zp, t.rows};
      product<NT>(ASmem{dyt, ld}, w, N, d.Zp, N, sm.stage, epi);
    }
  }
}

// The fused route's pass 3: all of the above for one row tile.
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
dec_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  const DecSmem sm(smem, d);
  const Tile t = Tile::of_grid(d);
  const float* gl = dec_forward(d, net, bt, s, t, sm);
  mean_head(d, net, bt, s, t, sm, gl, 0, d.DM, s.ll_rows);
  dec_backward(d, net, s, t, sm);
}

// The wide route's passes 3a, 3b, 3c.
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
dec_fwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  const DecSmem sm(smem, d);
  const Tile t = Tile::of_grid(d);
  dec_forward(d, net, bt, s, t, sm);
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
mean_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  const DecSmem sm(smem, d);
  const int fm = blockIdx.z;
  const Tile t(d, blockIdx.x, fm % d.M, fm / d.M);
  const int group = blockIdx.y;
  const int tid = threadIdx.x;
  const int HL = d.hr(d.L - 1);
  // g_L of this row tile from the workspace
  float* gl = sm.buf[0];
  const T* act = s.act_dec[d.L - 1] + t.fmrow * HL;
  const int H4 = HL / 4;
  tile_for<4>(
      TM * H4,
      [&](int e) { return e / H4 < t.rows ? ld4(act + 4 * e) : zero4(); },
      [&](int e, const float4& v) {
        at4(gl + (e / H4) * sm.ld + (e % H4) * 4) = v;
      });
  __syncthreads();
  const int c_lo = group * d.cols_per_group;
  const int c_hi = min(d.DM, c_lo + d.cols_per_group);
  const size_t per = (size_t)d.F * d.M * d.B;
  mean_head(d, net, bt, s, t, sm, gl, c_lo, c_hi, s.ll_rows + group * per);
  // this group's partial of dg
  float* out = s.dg_part + (group * per + t.fmrow) * HL;
  const float* dg = sm.buf[2];
  for (int e = tid; e < t.rows * H4; e += THREADS) {
    at4(out + 4 * e) = ld4(dg + (e / H4) * sm.ld + (e % H4) * 4);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
dec_bwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  const DecSmem sm(smem, d);
  const Tile t = Tile::of_grid(d);
  const int HL = d.hr(d.L - 1);
  // dg: the column groups' partials, summed in group order
  const size_t per = (size_t)d.F * d.M * d.B * HL;
  const float* part = s.dg_part + t.fmrow * HL;
  float* dg = sm.buf[2];
  const int H4 = HL / 4;
  const int groups = d.col_groups;
  tile_for<2>(
      TM * H4,
      [&](int e) {
        float4 v = zero4();
        if (e / H4 < t.rows) {
          for (int g = 0; g < groups; ++g) {
            v = add4(v, ld4(part + g * per + 4 * e));
          }
        }
        return v;
      },
      [&](int e, const float4& v) {
        at4(dg + (e / H4) * sm.ld + (e % H4) * 4) = v;
      });
  __syncthreads();
  dec_backward(d, net, s, t, sm);
}

// ---- 4. fusion backward -------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
fuse_bwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  const int f = blockIdx.y;
  const int b = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_LANES;
  const int lane = threadIdx.x % ROW_LANES;
  const bool live = b < d.B;
  const int M = d.M;
  const int Z = d.Z;
  const int Zp = d.Zp;
  const float Mf = (float)M;
  float sw[MAX_M];
  for (int m = 0; m < M; ++m) sw[m] = 1.f;
  const bool gpoe = d.combine == GPOE && M > 1;
  if (d.combine == GPOE) softmax_alpha(net.alpha + (size_t)f * M, M, sw);
  float ds[MAX_M];
  for (int m = 0; m < M; ++m) ds[m] = 0.f;
  const size_t fb = (size_t)f * d.B + b;
  const float rmv = live ? bt.rm[fb] : 0.f;
  const float inv_n = 1.f / bt.n[f];
  for (int k = lane; live && k < Zp; k += ROW_LANES) {
    float dmus[MAX_M], dlvs[MAX_M];
    if (k >= Z) {
      for (int m = 0; m < M; ++m) dmus[m] = dlvs[m] = 0.f;
    } else {
      float mus[MAX_M], lvs[MAX_M];
      float dz = 0.f;
      for (int m = 0; m < M; ++m) {
        const size_t at = (((size_t)f * M + m) * d.B + b) * Zp + k;
        mus[m] = s.mus[at];
        lvs[m] = s.lvs[at];
        dz += s.dz[at];
      }
      const float mu = s.fmu[fb * Z + k];
      const float lgv = s.flgv[fb * Z + k];
      const float half = expf(0.5f * lgv);
      const float dmu = dz + Mf * rmv * mu * inv_n;
      const float dlgv = 0.5f * dz * bt.eps[fb * Z + k] * half -
                         0.5f * Mf * rmv * (1.f - expf(lgv)) * inv_n;
      if (M == 1) {
        dmus[0] = dmu;
        dlvs[0] = dlgv;
      } else if (d.combine == MOE) {
        float var = 0.f;
        for (int m = 0; m < M; ++m) var += expf(lvs[m]);
        var = var / M;
        const float dvar = dlgv / var;
        for (int m = 0; m < M; ++m) {
          dmus[m] = dmu / M;
          dlvs[m] = (dvar / M) * expf(lvs[m]);
        }
      } else if (d.combine == MOPOE) {
        float vars[MAX_M], ts[MAX_M];
        float tsum = 0.f, tmu = 0.f, svar = 0.f;
        for (int m = 0; m < M; ++m) {
          vars[m] = expf(lvs[m]);
          ts[m] = 1.f / vars[m];
          tsum += ts[m];
          tmu += ts[m] * mus[m];
          svar += vars[m];
        }
        const float mu_p = tmu / tsum;
        const float var = (svar + 1.f / tsum) / (M + 1);
        const float dvar = dlgv / var;
        const float dmu_p = dmu / (M + 1);
        const float dvar_p = dvar / (M + 1);
        const float dtsum = -dvar_p / (tsum * tsum) - dmu_p * mu_p / tsum;
        for (int m = 0; m < M; ++m) {
          dmus[m] = dmu / (M + 1) + dmu_p * ts[m] / tsum;
          const float dt = dmu_p * mus[m] / tsum + dtsum;
          dlvs[m] = (dvar / (M + 1) - dt * ts[m] * ts[m]) * vars[m];
        }
      } else {  // poe / gpoe
        float ps[MAX_M];
        float P = 0.f;
        for (int m = 0; m < M; ++m) {
          ps[m] = sw[m] * expf(-lvs[m]);
          P += ps[m];
        }
        const float dP = -dlgv / P - dmu * mu / P;
        for (int m = 0; m < M; ++m) {
          const float dp = dmu * mus[m] / P + dP;
          dmus[m] = dmu * ps[m] / P;
          dlvs[m] = -dp * ps[m];
          if (gpoe) ds[m] += dp * expf(-lvs[m]);
        }
      }
    }
    for (int m = 0; m < M; ++m) {
      const size_t at = (((size_t)f * M + m) * d.B + b) * Zp + k;
      s.dmus[at] = dmus[m];
      s.dlvs[at] = dlvs[m];
    }
  }
  for (int m = 0; m < M; ++m) {
    const float v = row_fold(ds[m]);
    if (live && lane == 0) s.ds_rows[fb * M + m] = v;
  }
}

// ---- 5. encoder backward chain ------------------------------------------------

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
enc_bwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  const int ld = d.tile_ld();
  float* da = smem + STAGES * STAGE_FLOATS;
  float* dzt = da + TM * ld;
  const Tile t = Tile::of_grid(d);
  const int Zp = d.Zp;

  // da = dmu Wmu^T + dlv Wlv^T, [dmu | dlv] rounded to T in dzt
  const int HL = d.H[d.L - 1];
  const int Z4 = 2 * Zp / 4;
  tile_for<2>(
      TM * Z4,
      [&](int e) {
        const int r = e / Z4;
        const int k = (e % Z4) * 4;
        if (r >= t.rows) return zero4();
        return k < Zp ? ld4(s.dmus + (t.fmrow + r) * Zp + k)
                      : ld4(s.dlvs + (t.fmrow + r) * Zp + (k - Zp));
      },
      [&](int e, const float4& v) {
        at4(dzt + (e / Z4) * ld + (e % Z4) * 4) = rnd4<T>(v);
      });
  __syncthreads();
  {
    ToSmem set{da, ld, false};
    product<NT>(ASmem{dzt, ld}, net.wmu + t.fm * HL * Zp, Zp, HL, Zp, stage,
                set);
    ToSmem add{da, ld, true};
    product<NT>(ASmem{dzt + Zp, ld}, net.wlv + t.fm * HL * Zp, Zp, HL, Zp,
                stage, add);
  }
  for (int l = d.L - 1; l >= 0; --l) {
    const int N = d.H[l];
    const int K = d.kin(l);
    const T* act = s.act_enc[l] + t.fmrow * N;
    float* dz = s.dz_enc[l] + t.fmrow * N;
    back_through_lrelu<T>(da, dzt, ld, act, dz, N, t.rows);
    if (l > 0) {
      ToSmem epi{da, ld, false};
      product<NT>(ASmem{dzt, ld}, net.enc_w[l] + t.fm * K * N, N, K, N, stage,
                  epi);
    }
  }
}

// ---- 6. weight gradients ------------------------------------------------------

// One output of the weight-gradient pass, per (fold, modality):
// out[K, N] = scale * sum_rows A[row, k] dY[row, n] (a product), or
// out[N] = scale * sum_rows dY[row, n] (a column sum; A unused). A is the
// rows of [a | a2] (a2 from column `a_cols` on; a2 per fold only); strides
// are per fold and per modality.
struct Job {
  const void* a;
  const void* a2;
  const float* dy;
  float* out;
  long long a_f, a_m, a2_f, dy_f, dy_m;
  int a_ld, a2_ld, a_cols, dy_ld;
  int K, N;
  int colsum;       // 1: column sum
  int round_dy;     // 1: dY rounded to T in the product
  int scale_n;      // 1: scaled by -1/n (dlvo)
  int tiles;        // output tiles of this job
};

struct Jobs {
  Job j[MAX_JOBS];
  int count;
  int total_tiles;
};

constexpr int WK = 32;   // output rows (k) per weight-gradient tile
constexpr int WR = 32;   // batch rows per staged chunk
constexpr int WSTAGE = WR * LDA + WR * LDW;

// Rows r0.. of the job's A columns k0.. ([WR][LDA]) and dY columns n0..
// ([WR][LDW]) into one stage; out of range zero-filled.
template <class T>
__device__ __forceinline__ void stage_wgrad(float* st, const Job& jb,
                                            const T* a, const T* a2,
                                            const float* dy, int r0, int r_hi,
                                            int k0, int n0) {
  {
    const int rr = threadIdx.x / (WK / 4);
    const int g = threadIdx.x % (WK / 4);
    const int r = r0 + rr;
    const int k = k0 + 4 * g;
    const bool ok = r < r_hi && k < jb.K;
    const T* src = a;
    if (ok) {
      src = k < jb.a_cols ? a + (size_t)r * jb.a_ld + k
                          : a2 + (size_t)r * jb.a2_ld + (k - jb.a_cols);
    }
    Ld<T>::tile4(st + rr * LDA + 4 * g, src, ok);
  }
  float* ys = st + WR * LDA;
  for (int e = threadIdx.x; e < WR * (BN / 4); e += THREADS) {
    const int rr = e / (BN / 4);
    const int g = e % (BN / 4);
    const int r = r0 + rr;
    const int col = n0 + 4 * g;
    const bool ok = r < r_hi && col < jb.N;
    Ld<T>::tile4_f32(ys + rr * LDW + 4 * g,
                     ok ? dy + (size_t)r * jb.dy_ld + col : dy, ok,
                     jb.round_dy != 0);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 3)
wgrad_kernel(Dims d, Jobs jobs, const float* n, float* part_base,
             float* grad_base, long long grad_count) {
  __shared__ __align__(16) float stage[STAGES * WSTAGE];
  int t = blockIdx.x;
  int ji = 0;
  while (ji < jobs.count - 1 && t >= jobs.j[ji].tiles) {
    t -= jobs.j[ji].tiles;
    ++ji;
  }
  const Job& jb = jobs.j[ji];
  const int split = blockIdx.y;
  const size_t fm = blockIdx.z;
  const size_t f = fm / d.M;
  const size_t m = fm % d.M;
  const int r_lo = split * d.split_rows;
  const int r_hi = min(d.B, r_lo + d.split_rows);
  const float* dy = jb.dy + f * jb.dy_f + m * jb.dy_m;
  const float scale = jb.scale_n ? -1.f / n[f] : 1.f;
  // outputs go to the gradient, or to this split's partial of it
  float* out = jb.out + fm * (size_t)jb.K * jb.N;
  if (gridDim.y > 1) {
    out = part_base + (size_t)split * grad_count + (out - grad_base);
  }
  const int tid = threadIdx.x;

  if (jb.colsum) {
    // one thread a column, the rows added in order; 16 loads are asked for
    // before the first is added (with one load in flight at a time these
    // blocks were the pass's longest)
    const int col = t * THREADS + tid;
    if (col < jb.N) {
      const float* at = dy + col;
      float sum = 0.f;
      int r = r_lo;
      for (; r + 16 <= r_hi; r += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = at[(size_t)(r + u) * jb.dy_ld];
#pragma unroll
        for (int u = 0; u < 16; ++u) sum += v[u];
      }
      for (; r < r_hi; ++r) sum += at[(size_t)r * jb.dy_ld];
      out[col] = sum * scale;
    }
    return;
  }

  const T* a = static_cast<const T*>(jb.a) + f * jb.a_f + m * jb.a_m;
  const T* a2 = static_cast<const T*>(jb.a2) + f * jb.a2_f;
  const int n_tiles = (jb.N + BN - 1) / BN;
  const int k0 = (t / n_tiles) * WK;
  const int n0 = (t % n_tiles) * BN;
  // the warp's 16 k x 32 n of the tile; per thread 4 k x 4 n (FFMA: rows
  // kw + 4 lr + i, columns nw + 4 lc + j) or the mma accumulators of its 4
  // n8 tiles (rows kw + g + 8 (c / 2), columns nw + 8 nt + 2 t + c % 2)
  constexpr bool MMA = UseMma<T>::value;
  const Lanes ln;
  const int kw = 16 * ln.wr;
  const int nw = 32 * ln.wc;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
  const int nchunks = (r_hi - r_lo + WR - 1) / WR;
  stage_wgrad<T>(stage, jb, a, a2, dy, r_lo, r_hi, k0, n0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const float* cur = stage + (c & 1) * WSTAGE;
    if (c + 1 < nchunks) {
      stage_wgrad<T>(stage + ((c + 1) & 1) * WSTAGE, jb, a, a2, dy,
                     r_lo + (c + 1) * WR, r_hi, k0, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ys = cur + WR * LDA;
    if (MMA) {
      // A of the mma is A^T of the tile: element (k, r) at cur[r][k]
#pragma unroll
      for (int rs = 0; rs < WR; rs += 16) {
        const float* ar = cur + (rs + 2 * ln.t) * LDA + kw + ln.g;
        const unsigned af[4] = {
            pack2(ar[0], ar[LDA]), pack2(ar[8], ar[LDA + 8]),
            pack2(ar[8 * LDA], ar[9 * LDA]),
            pack2(ar[8 * LDA + 8], ar[9 * LDA + 8])};
#pragma unroll
        for (int nt = 0; nt < RM; ++nt) {
          const float* yr = ys + (rs + 2 * ln.t) * LDW + nw + 8 * nt + ln.g;
          mma16816(acc[nt], af, pack2(yr[0], yr[LDW]),
                   pack2(yr[8 * LDW], yr[9 * LDW]));
        }
      }
    } else {
#pragma unroll 8
      for (int rr = 0; rr < WR; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(
            cur + rr * LDA + kw + 4 * ln.lr);
        const float4 yv = *reinterpret_cast<const float4*>(
            ys + rr * LDW + nw + 4 * ln.lc);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float ai = comp(av, i);
          acc[i][0] = fmaf(ai, yv.x, acc[i][0]);
          acc[i][1] = fmaf(ai, yv.y, acc[i][1]);
          acc[i][2] = fmaf(ai, yv.z, acc[i][2]);
          acc[i][3] = fmaf(ai, yv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
  if (MMA) {
#pragma unroll
    for (int nt = 0; nt < RM; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + kw + ln.g + 8 * h;
        const int col = n0 + nw + 8 * nt + 2 * ln.t;
        if (k < jb.K && col < jb.N) {
          *reinterpret_cast<float2*>(out + (size_t)k * jb.N + col) =
              make_float2(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int k = k0 + kw + 4 * ln.lr + i;
      const int col = n0 + nw + 4 * ln.lc;
      if (k < jb.K && col < jb.N) {
        *reinterpret_cast<float4*>(out + (size_t)k * jb.N + col) =
            make_float4(acc[i][0] * scale, acc[i][1] * scale,
                        acc[i][2] * scale, acc[i][3] * scale);
      }
    }
  }
}

// out[i] = sum over k < split of part[k * count + i], in order of k.
static __global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int split,
                                  long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

// ---- 7. losses and dalpha ---------------------------------------------------

// The sum of v over the block's THREADS threads, in a fixed order (lanes
// folded by shuffles, then the 8 warps in turn); every thread gets it.
__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) out += red[w];
  __syncthreads();
  return out;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
finish_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s,
              float* dalpha, float* losses) {
  __shared__ float red[THREADS / 32];
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int M = d.M;
  const float n = bt.n[f];
  const size_t fB = (size_t)f * d.B;
  float v = 0.f;
  for (int b = tid; b < d.B; b += THREADS) v += bt.rm[fB + b] * s.kl_rows[fB + b];
  const float kl = block_sum(v, red) / n;
  const size_t per = (size_t)d.F * M * d.B;
  float ll = 0.f;
  for (int m = 0; m < M; ++m) {
    v = 0.f;
    for (int b = tid; b < d.B; b += THREADS) {
      for (int g = 0; g < d.col_groups; ++g) {
        v += s.ll_rows[g * per + ((size_t)f * M + m) * d.B + b];
      }
    }
    ll += block_sum(v, red) / n;
  }
  float ds[MAX_M];
  const bool gpoe = d.combine == GPOE && M > 1;
  if (gpoe) {
    for (int m = 0; m < M; ++m) {
      v = 0.f;
      for (int b = tid; b < d.B; b += THREADS) v += s.ds_rows[(fB + b) * M + m];
      ds[m] = block_sum(v, red);
    }
  }
  if (tid != 0) return;
  losses[f * 3 + 0] = M * kl - ll;
  losses[f * 3 + 1] = M * kl;
  losses[f * 3 + 2] = ll;
  float* da = dalpha + (size_t)f * M;
  if (gpoe) {
    float sw[MAX_M];
    softmax_alpha(net.alpha + (size_t)f * M, M, sw);
    float total = 0.f;
    for (int m = 0; m < M; ++m) total += sw[m] * ds[m];
    for (int m = 0; m < M; ++m) da[m] = sw[m] * (ds[m] - total);
  } else {
    for (int m = 0; m < M; ++m) da[m] = 0.f;
  }
}

// ---- host side ----------------------------------------------------------------

inline size_t dec_smem(const Dims& d) {
  return ((size_t)STAGES * STAGE_FLOATS + 3 * (size_t)TM * d.tile_ld() +
          TM * DMS) * sizeof(float);
}
inline size_t enc_smem(const Dims& d) {
  return ((size_t)STAGES * STAGE_FLOATS + 2 * (size_t)TM * d.tile_ld()) *
         sizeof(float);
}
inline size_t split_smem() { return (size_t)STAGES * STAGE_FLOATS * sizeof(float); }

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The route and its splits. `route` 0 picks from the shapes: when the
// row-owned grid (row tiles x modalities x folds) is less than one block an
// SM, the wide dimension goes to the grid, aiming at two blocks an SM (what
// an SM holds of these kernels), as far as there are 32-deep chunks (first
// encoder layer, at least 8 a block) or 128-wide column chunks (mean head,
// at least 2 a block) to share out; 1 forces the fused route; a larger
// value forces the wide route aiming at that many blocks a launch.
inline void plan(Dims& d, int route) {
  const int blocks = ceil_div(d.B, TM) * d.M * d.F;
  int want = 1;
  if (route > 1) want = ceil_div(route, blocks);
  if (route == 0 && blocks < SMS) want = ceil_div(2 * SMS, blocks);
  const int kchunks = ceil_div(d.kin(0), BK);
  const int cchunks = ceil_div(d.DM, BN);
  // forced (measurements): 4 chunks of K and 1 column chunk a block
  const int kmin = route > 1 ? 4 : 8;
  const int cmin = route > 1 ? 1 : 2;
  int ksplit = want < kchunks / kmin ? want : kchunks / kmin;
  int groups = want < cchunks / cmin ? want : cchunks / cmin;
  if (ksplit < 1) ksplit = 1;
  if (groups < 1) groups = 1;
  d.wide = (route > 1 || ksplit > 1 || groups > 1) ? 1 : 0;
  d.enc0_kper = ceil_div(kchunks, ksplit) * BK;
  d.enc0_splits = ceil_div(d.kin(0), d.enc0_kper);
  d.cols_per_group = ceil_div(cchunks, groups) * BN;
  d.col_groups = ceil_div(d.DM, d.cols_per_group);
}

// The parsed int table (see mmnm_train_step); false if out of range or a
// padded width is not a multiple of `align` (4 in fp32, 16 in bf16).
inline bool parse_dims(const int* ints, int align, Dims& d) {
  d.F = ints[0];
  d.M = ints[1];
  d.B = ints[2];
  d.L = ints[3];
  d.Z = ints[4];
  d.Zp = ints[5];
  d.Cp = ints[6];
  d.DM = ints[7];
  d.combine = ints[8];
  d.split_rows = ints[9];
  const int route = ints[10];
  if (d.F <= 0 || d.M <= 0 || d.M > MAX_M || d.B <= 0 || d.L <= 0 ||
      d.L > MAX_L || d.Z <= 0 || d.Zp < d.Z || d.Zp % align || d.Cp < 0 ||
      d.Cp % align || d.DM <= 0 || d.DM % align || d.combine < 0 ||
      d.combine > 3 || d.split_rows <= 0 || route < 0) {
    return false;
  }
  for (int m = 0; m < d.M; ++m) {
    d.dims[m] = ints[11 + m];
    if (d.dims[m] <= 0 || d.dims[m] > d.DM) return false;
  }
  for (int l = 0; l < d.L; ++l) {
    d.H[l] = ints[11 + d.M + l];
    if (d.H[l] <= 0 || d.H[l] % align) return false;
  }
  for (int m = 0; m < d.M; ++m) d.order[m] = m;
  for (int i = 1; i < d.M; ++i) {      // stable insertion sort, widest first
    const int m = d.order[i];
    int j = i;
    for (; j > 0 && d.dims[d.order[j - 1]] < d.dims[m]; --j) {
      d.order[j] = d.order[j - 1];
    }
    d.order[j] = m;
  }
  plan(d, route);
  return true;
}

// Floats of every gradient but alpha (which comes last), summed.
inline long long grad_floats(const Dims& d) {
  long long per = 0;
  for (int l = 0; l < d.L; ++l) per += (long long)d.kin(l) * d.H[l] + d.H[l];
  const int hl = d.H[d.L - 1];
  per += 2LL * (hl * d.Zp + d.Zp);
  for (int l = 0; l < d.L; ++l) per += (long long)d.kdec(l) * d.hr(l) + d.hr(l);
  per += (long long)d.hr(d.L - 1) * d.DM + 2LL * d.DM;
  return per * d.F * d.M;
}

inline int n_splits(const Dims& d) { return (d.B + d.split_rows - 1) / d.split_rows; }

// Carves the workspace; returns its size in bytes (ptr may be null).
template <class T>
size_t carve(const Dims& d, char* base, Scratch<T>& s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t fmb = (size_t)d.F * d.M * d.B;
  const size_t fb = (size_t)d.F * d.B;
  s.enc0_part = reinterpret_cast<float*>(
      take(d.wide ? d.enc0_splits * fmb * d.H[0] * 4 : 0));
  for (int l = 0; l < d.L; ++l) {
    s.act_enc[l] = reinterpret_cast<T*>(take(fmb * d.H[l] * sizeof(T)));
  }
  s.mus = reinterpret_cast<float*>(take(fmb * d.Zp * 4));
  s.lvs = reinterpret_cast<float*>(take(fmb * d.Zp * 4));
  s.fmu = reinterpret_cast<float*>(take(fb * d.Z * 4));
  s.flgv = reinterpret_cast<float*>(take(fb * d.Z * 4));
  s.z = reinterpret_cast<T*>(take(fb * d.Zp * sizeof(T)));
  s.kl_rows = reinterpret_cast<float*>(take(fb * 4));
  for (int l = 0; l < d.L; ++l) {
    s.act_dec[l] = reinterpret_cast<T*>(take(fmb * d.hr(l) * sizeof(T)));
  }
  s.dmean = reinterpret_cast<float*>(take(fmb * d.DM * 4));
  s.e_lvo = reinterpret_cast<float*>(take(fmb * d.DM * 4));
  s.ll_rows = reinterpret_cast<float*>(take(d.col_groups * fmb * 4));
  s.dg_part = reinterpret_cast<float*>(
      take(d.wide ? d.col_groups * fmb * d.hr(d.L - 1) * 4 : 0));
  for (int l = 0; l < d.L; ++l) {
    s.dy_dec[l] = reinterpret_cast<float*>(take(fmb * d.hr(l) * 4));
  }
  s.dz = reinterpret_cast<float*>(take(fmb * d.Zp * 4));
  s.dmus = reinterpret_cast<float*>(take(fmb * d.Zp * 4));
  s.dlvs = reinterpret_cast<float*>(take(fmb * d.Zp * 4));
  s.ds_rows = reinterpret_cast<float*>(take(fb * d.M * 4));
  for (int l = 0; l < d.L; ++l) {
    s.dz_enc[l] = reinterpret_cast<float*>(take(fmb * d.H[l] * 4));
  }
  const int splits = n_splits(d);
  s.part = reinterpret_cast<float*>(
      take(splits > 1 ? (size_t)splits * grad_floats(d) * 4 : 0));
  return off;
}

// The job table of the weight-gradient pass.
template <class T>
Jobs make_jobs(const Dims& d, const Batch<T>& bt, const Scratch<T>& s,
               const Net<float>& g) {
  Jobs jobs;
  jobs.count = 0;
  jobs.total_tiles = 0;
  const long long B = d.B;
  const long long MB = (long long)d.M * B;
  auto product = [&](const void* a, long long a_f, long long a_m, int a_ld,
                     int a_cols, const void* a2, long long a2_f, int a2_ld,
                     const float* dy, int K, int N, float* out) {
    Job j{};
    j.a = a;
    j.a_f = a_f;
    j.a_m = a_m;
    j.a_ld = a_ld;
    j.a_cols = a_cols;
    j.a2 = a2 ? a2 : a;
    j.a2_f = a2_f;
    j.a2_ld = a2_ld;
    j.dy = dy;
    j.dy_ld = N;
    j.dy_f = MB * N;
    j.dy_m = B * N;
    j.K = K;
    j.N = N;
    j.out = out;
    j.round_dy = 1;
    j.tiles = ((K + WK - 1) / WK) * ((N + BN - 1) / BN);
    jobs.j[jobs.count++] = j;
    jobs.total_tiles += j.tiles;
  };
  auto colsum = [&](const float* dy, int N, float* out, int scale_n) {
    Job j{};
    j.dy = dy;
    j.dy_ld = N;
    j.dy_f = MB * N;
    j.dy_m = B * N;
    j.K = 1;
    j.N = N;
    j.out = out;
    j.colsum = 1;
    j.scale_n = scale_n;
    j.tiles = (N + THREADS - 1) / THREADS;
    jobs.j[jobs.count++] = j;
    jobs.total_tiles += j.tiles;
  };
  // an activation [F, M, B, w] as A
  auto act = [&](const T* a, int w, const float* dy, int N, float* out) {
    product(a, MB * w, B * w, w, w, nullptr, 0, 0, dy, w, N, out);
  };
  for (int l = 0; l < d.L; ++l) {
    const int N = d.H[l];
    if (l == 0) {
      product(bt.x, MB * d.DM, B * d.DM, d.DM, d.DM, bt.c, B * d.Cp, d.Cp,
              s.dz_enc[0], d.DM + d.Cp, N, g.enc_w[0]);
    } else {
      act(s.act_enc[l - 1], d.H[l - 1], s.dz_enc[l], N, g.enc_w[l]);
    }
    colsum(s.dz_enc[l], N, g.enc_b[l], 0);
  }
  const int hl = d.H[d.L - 1];
  act(s.act_enc[d.L - 1], hl, s.dmus, d.Zp, g.wmu);
  colsum(s.dmus, d.Zp, g.bmu, 0);
  act(s.act_enc[d.L - 1], hl, s.dlvs, d.Zp, g.wlv);
  colsum(s.dlvs, d.Zp, g.blv, 0);
  for (int l = 0; l < d.L; ++l) {
    const int N = d.hr(l);
    if (l == 0) {
      // [z | c]: both per fold only
      product(s.z, B * d.Zp, 0, d.Zp, d.Zp, bt.c, B * d.Cp, d.Cp, s.dy_dec[0],
              d.Zp + d.Cp, N, g.dec_w[0]);
    } else {
      act(s.act_dec[l - 1], d.hr(l - 1), s.dy_dec[l], N, g.dec_w[l]);
    }
    colsum(s.dy_dec[l], N, g.dec_b[l], 0);
  }
  act(s.act_dec[d.L - 1], d.hr(d.L - 1), s.dmean, d.DM, g.vm);
  colsum(s.dmean, d.DM, g.cm, 0);
  colsum(s.e_lvo, d.DM, g.lvo, 1);
  return jobs;
}

template <class W>
void parse_net(void* const* p, const Dims& d, Net<W>& net) {
  int i = 0;
  for (int l = 0; l < d.L; ++l) {
    net.enc_w[l] = static_cast<W*>(p[i++]);
    net.enc_b[l] = static_cast<float*>(p[i++]);
  }
  net.wmu = static_cast<W*>(p[i++]);
  net.bmu = static_cast<float*>(p[i++]);
  net.wlv = static_cast<W*>(p[i++]);
  net.blv = static_cast<float*>(p[i++]);
  for (int l = 0; l < d.L; ++l) {
    net.dec_w[l] = static_cast<W*>(p[i++]);
    net.dec_b[l] = static_cast<float*>(p[i++]);
  }
  net.vm = static_cast<W*>(p[i++]);
  net.cm = static_cast<float*>(p[i++]);
  net.lvo = static_cast<float*>(p[i++]);
  net.alpha = static_cast<float*>(p[i++]);
}

inline int net_count(const Dims& d) { return 4 * d.L + 8; }

// cudaFuncAttributeMaxDynamicSharedMemorySize, set when `kernel` asks on the
// current device for more than it was given there before, and not on every
// one of a step's launches. Kernels of both operand types share one
// function type, so the table is keyed by the kernel's address.
inline cudaError_t ensure_smem(const void* kernel, size_t bytes) {
  constexpr int MAX_KERNELS = 32;
  constexpr int MAX_DEVICES = 64;
  struct Entry {
    const void* kernel;
    int have[MAX_DEVICES];
  };
  static Entry table[MAX_KERNELS];
  static int used = 0;
  static std::mutex guard;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(guard);
  Entry* entry = nullptr;
  for (int i = 0; i < used; ++i) {
    if (table[i].kernel == kernel) entry = &table[i];
  }
  if (entry == nullptr) {
    if (used == MAX_KERNELS) return cudaErrorInvalidValue;
    entry = &table[used++];
    entry->kernel = kernel;
  }
  if ((int)bytes <= entry->have[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) entry->have[dev] = (int)bytes;
  return err;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory.
template <class K, class... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t err = ensure_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <class T>
int run(void* const* ptrs, const Dims& d, cudaStream_t stream) {
  Batch<T> bt{static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
              static_cast<const float*>(ptrs[2]),
              static_cast<const float*>(ptrs[3]),
              static_cast<const float*>(ptrs[4])};
  Net<const T> net;
  parse_net(ptrs + 5, d, net);
  Net<float> g;
  parse_net(ptrs + 5 + net_count(d), d, g);
  float* losses = static_cast<float*>(ptrs[5 + 2 * net_count(d)]);
  char* work = static_cast<char*>(ptrs[6 + 2 * net_count(d)]);
  Scratch<T> s;
  carve<T>(d, work, s);

  const int row_tiles = ceil_div(d.B, TM);
  const dim3 tiles(row_tiles, d.M, d.F);
  const dim3 rows(ceil_div(d.B, ROWS_PER_BLOCK), d.F);
  cudaError_t err;
#define MMNM_LAUNCH(...)                                   \
  if ((err = launch(__VA_ARGS__)) != cudaSuccess) return (int)err

  if (d.wide) {
    MMNM_LAUNCH(enc0_split_kernel<T>, dim3(row_tiles, d.enc0_splits, d.F * d.M),
                THREADS, split_smem(), stream, d, net, bt, s);
  }
  MMNM_LAUNCH(enc_fwd_kernel<T>, tiles, THREADS, enc_smem(d), stream, d, net,
              bt, s);
  MMNM_LAUNCH(fuse_fwd_kernel<T>, rows, ROW_THREADS, 0, stream, d, net, bt, s);
  if (d.wide) {
    MMNM_LAUNCH(dec_fwd_kernel<T>, tiles, THREADS, dec_smem(d), stream, d, net,
                bt, s);
    MMNM_LAUNCH(mean_kernel<T>, dim3(row_tiles, d.col_groups, d.F * d.M),
                THREADS, dec_smem(d), stream, d, net, bt, s);
    MMNM_LAUNCH(dec_bwd_kernel<T>, tiles, THREADS, dec_smem(d), stream, d, net,
                bt, s);
  } else {
    MMNM_LAUNCH(dec_kernel<T>, tiles, THREADS, dec_smem(d), stream, d, net, bt,
                s);
  }
  MMNM_LAUNCH(fuse_bwd_kernel<T>, rows, ROW_THREADS, 0, stream, d, net, bt, s);
  MMNM_LAUNCH(enc_bwd_kernel<T>, tiles, THREADS, enc_smem(d), stream, d, net,
              bt, s);

  const Jobs jobs = make_jobs<T>(d, bt, s, g);
  const int splits = n_splits(d);
  const long long count = grad_floats(d);
  MMNM_LAUNCH(wgrad_kernel<T>, dim3(jobs.total_tiles, splits, d.F * d.M),
              THREADS, 0, stream, d, jobs, bt.n, s.part, g.enc_w[0], count);
  if (splits > 1) {
    const long long want = (count + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    MMNM_LAUNCH(sum_splits_kernel, dim3(blocks), 256, 0, stream, s.part,
                g.enc_w[0], splits, count);
  }
  MMNM_LAUNCH(finish_kernel<T>, dim3(d.F), THREADS, 0, stream, d, net, bt, s,
              g.alpha, losses);
#undef MMNM_LAUNCH
  return 0;
}

}  // namespace mmnm_ts
