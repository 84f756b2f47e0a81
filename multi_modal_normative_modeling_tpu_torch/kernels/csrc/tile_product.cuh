// The fp32 product routine of encoder.cu, decoder_nll.cu and
// pred_deviation.cu.
//
// A block of 256 threads owns 32 rows x 128 columns of an output: 8 warps
// as 2 x 4 tiles of 16 rows x 32 columns, a lane a 4 x 4 tile, every
// accumulator in a register for the whole reduction (64 FFMA for 8 128-bit
// shared-memory loads of one wavefront each; the layout is
// train_step.cuh's, whose products these kernels do not share because they
// read the modules' own unpadded tensors). The A operand (32 rows of an
// activation, or a dmean tile) lies whole in shared memory and is read in
// place. The weights stream from device memory in 32-deep chunks through a
// ring of three slots filled by cp.async: chunks s + 1 and s + 2 are in
// flight while chunk s is multiplied (one chunk is about 0.6 us of FFMA, less
// than a trip to L2 under load, so one chunk of lead is not enough), and one
// __syncthreads a chunk is enough: chunk s + 2 is asked for after the
// barrier of step s, into the slot that step s - 1 read, which every thread
// has left by then. The ring runs over the flattened (column block, chunk)
// sequence of a product, so the first chunks of a column block are fetched
// during the last chunks and the epilogue of the one before it.
//
// The modules' tensors are not padded: a weight row of K floats starts on a
// 16-byte boundary only when K is a multiple of 4 (H = 110 gives 8 bytes,
// Z + C = 39 gives 4). The copies are 16, 8 or 4 bytes wide, the widest the
// tensor's address and row length allow (`copy_width`); what lies past the
// matrix is zero-filled by the copy itself. A padded copy made by the
// wrapper was the alternative: the weights change every training step, so
// it would cost a launch and a write and a read of every weight per call to
// save copy instructions that the FFMA hide (16 4-byte copies a thread for
// 512 FFMA at the narrowest).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mmnm_tp {

constexpr int TM = 32;            // rows of a block's tile
constexpr int BN = 128;           // columns of a block's tile
constexpr int BK = 32;            // reduction depth of one streamed chunk
constexpr int THREADS = 256;
constexpr int RM = 4;             // rows a lane owns
constexpr int RN = 4;             // columns a lane owns
constexpr int LDA = BK + 4;       // row stride of a [BN][BK] slot (W[n][k])
constexpr int LDW = BN + 4;       // row stride of a [BK][BN] slot (W[k][n])
constexpr int DMS = BN + 8;       // row stride of a [TM][BN] tile (8 mod 16)
constexpr int SLOT_FLOATS = BN * LDA;   // the larger of the two slot shapes
constexpr int SLOTS = 3;
constexpr int RING_FLOATS = SLOTS * SLOT_FLOATS;

// Row stride of an activation tile of `width` columns: a multiple of 4 that
// is 8 mod 16, so the rows a warp reads as float4 fall in distinct banks.
__host__ __device__ inline int tile_ld(int width) {
  return width + (24 - width % 16) % 16;
}

// Floats per cp.async for a matrix at `p` whose rows are `ld` floats apart.
inline int copy_width(const void* p, int ld) {
  const uintptr_t a = (uintptr_t)p;
  if (a % 16 == 0 && ld % 4 == 0) return 4;
  if (a % 8 == 0 && ld % 2 == 0) return 2;
  return 1;
}

// Where a thread stands: (wr, wc) its warp's (TM / 2) x 32 tile, (lr, lc)
// its lane's row and column group there.
struct Lanes {
  int wr, wc, lr, lc;
  __device__ Lanes() {
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    wr = w >> 2;
    wc = w & 3;
    lr = lane >> 3;
    lc = lane & 7;
  }
  // row i (< RM) of this lane within the tile
  __device__ int row(int i) const { return (TM / 2) * wr + lr + 4 * i; }
  // column j (< RN) within the tile when the weights are W[n][k]
  __device__ int col_nt(int j) const { return 32 * wc + lc + 8 * j; }
  // column j within the tile when the weights are W[k][n]
  __device__ int col_nn(int j) const { return 32 * wc + 4 * lc + j; }
};

// VEC floats from device to shared memory; !ok zero-fills and reads nothing
// (src must still be an aligned address).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 * VEC : 0;
  if (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  } else if (VEC == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A [R][C] block of the row-major matrix w (row stride ld) starting at
// (r0, c0) into a slot of row stride S; entries at rows >= r_end or columns
// >= c_end are zero. c0, c_end and ld are multiples of VEC.
template <int VEC, int R, int C, int S>
__device__ __forceinline__ void stage_block(float* slot, const float* w,
                                            int ld, int r0, int r_end, int c0,
                                            int c_end) {
  constexpr int G = C / VEC;
  for (int e = threadIdx.x; e < R * G; e += THREADS) {
    const int rr = e / G;
    const int g = e % G;
    const int r = r0 + rr;
    const int c = c0 + VEC * g;
    const bool ok = r < r_end && c < c_end;
    cp_async<VEC>(slot + rr * S + VEC * g,
                  ok ? w + (size_t)r * ld + c : w, ok);
  }
}

// Chunk [n0, n0 + BN) x [k0, k0 + BK) of W[N][K] (rows ldw floats apart)
// as slot[n][k].
__device__ __forceinline__ void stage_nt(float* slot, const float* w, int ldw,
                                         int K, int vec, int n0, int N,
                                         int k0) {
  if (vec == 4) {
    stage_block<4, BN, BK, LDA>(slot, w, ldw, n0, N, k0, K);
  } else if (vec == 2) {
    stage_block<2, BN, BK, LDA>(slot, w, ldw, n0, N, k0, K);
  } else {
    stage_block<1, BN, BK, LDA>(slot, w, ldw, n0, N, k0, K);
  }
}

// Chunk [k0, k0 + BK) x [n0, n0 + BN) of W[K][N] (rows k < k_end) as
// slot[k][n].
__device__ __forceinline__ void stage_nn(float* slot, const float* w, int N,
                                         int vec, int k0, int k_end, int n0) {
  if (vec == 4) {
    stage_block<4, BK, BN, LDW>(slot, w, N, k0, k_end, n0, N);
  } else if (vec == 2) {
    stage_block<2, BK, BN, LDW>(slot, w, N, k0, k_end, n0, N);
  } else {
    stage_block<1, BK, BN, LDW>(slot, w, N, k0, k_end, n0, N);
  }
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
}

// acc[i][j] += sum_{kk < kc} a[row(i)][kk] slot[col_nt(j)][kk]; kc a
// multiple of 4, ap[i] the lane's rows of A at the chunk's first k.
__device__ __forceinline__ void chunk_nt(float (&acc)[RM][RN],
                                         const float* const (&ap)[RM],
                                         const float* slot, int kc,
                                         const Lanes& ln) {
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 4) {
    float4 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(ap[i] + kk);
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(
          slot + ln.col_nt(j) * LDA + kk);
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

// acc[i][j] += sum_{kk < kc} a[row(i)][kk] slot[kk][col_nn(j)].
__device__ __forceinline__ void chunk_nn(float (&acc)[RM][RN],
                                         const float* const (&ap)[RM],
                                         const float* slot, int kc,
                                         const Lanes& ln) {
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 4) {
    float4 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(ap[i] + kk);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 wv = *reinterpret_cast<const float4*>(
          slot + (kk + q) * LDW + ln.col_nn(0));
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ai = comp(av[i], q);
        acc[i][0] = fmaf(ai, wv.x, acc[i][0]);
        acc[i][1] = fmaf(ai, wv.y, acc[i][1]);
        acc[i][2] = fmaf(ai, wv.z, acc[i][2]);
        acc[i][3] = fmaf(ai, wv.w, acc[i][3]);
      }
    }
  }
}

// Column blocks first, first + stride, ... (`count` of them, BN wide) of
// out = a . w^T: a [TM][K] in shared memory (row stride lda, a multiple of
// 4; columns K .. roundup4(K) hold finite values), w [N][K] in device
// memory, its rows ldw floats apart (ldw > K: a window of K columns of a
// wider matrix, `vec` then that of the window's first address). After the last chunk of column block b, epi(n0, acc) gets the
// lane's 4 x 4 sums at rows ln.row(i) and columns n0 + ln.col_nt(j), n0 the
// block's first column. cp.async groups the caller committed before the
// call (a tile of A) have landed, and are visible, when the first chunk is
// multiplied. Ends with __syncthreads: what the epilogues wrote to shared
// memory is visible and the ring is free.
template <class Epi>
__device__ __forceinline__ void product_nt(const float* a, int lda,
                                           const float* w, int ldw, int K,
                                           int N, int vec, int first,
                                           int stride, int count, float* ring,
                                           Epi& epi) {
  const Lanes ln;
  const int nk = (K + BK - 1) / BK;
  const int total = nk * count;
  // every step commits a group, an empty one past the end, so that
  // wait_group<1> always means: all but the newest group have landed
  auto fetch = [&](int s) {
    if (s < total) {
      stage_nt(ring + (s % SLOTS) * SLOT_FLOATS, w, ldw, K, vec,
               (first + (s / nk) * stride) * BN, N, (s % nk) * BK);
    }
    cp_async_commit();
  };
  const float* arow[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) arow[i] = a + ln.row(i) * lda;
  float acc[RM][RN];
  fetch(0);
  fetch(1);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    fetch(s + 2);
    const int c = s % nk;
    const int n0 = (first + (s / nk) * stride) * BN;
    if (c == 0) zero(acc);
    // a warp none of whose 32 columns exists only keeps the barriers
    const bool live = n0 + 32 * ln.wc < N;
    if (live) {
      const int k0 = c * BK;
      const int kc = (min(BK, K - k0) + 3) & ~3;
      const float* ap[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) ap[i] = arow[i] + k0;
      chunk_nt(acc, ap, ring + (s % SLOTS) * SLOT_FLOATS, kc, ln);
      if (c == nk - 1) epi(n0, acc);
    }
  }
  __syncthreads();
}

// The same for a whole matrix w [N][K].
template <class Epi>
__device__ __forceinline__ void product_nt(const float* a, int lda,
                                           const float* w, int K, int N,
                                           int vec, int first, int stride,
                                           int count, float* ring, Epi& epi) {
  product_nt(a, lda, w, K, K, N, vec, first, stride, count, ring, epi);
}

// One linear layer of every fold: w [F, n, k] (nn.Linear's [out, in] per
// fold), b [F, n]; vec floats per cp.async of a row of w.
struct Layer {
  const float* w;
  const float* b;
  int n;
  int k;
  int vec;
};

constexpr int MAX_LAYERS = 8;
struct Layers {
  Layer l[MAX_LAYERS];
};

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.01f * v;
}

// Epilogue of a hidden layer: (LeakyReLU of) v + b into the next
// activation tile.
struct ToAct {
  float* out;
  int ld;
  const float* b;
  int N;
  bool act;
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      if (n >= N) continue;
      const float bias = b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float v = acc[i][j] + bias;
        out[ln.row(i) * ld + n] = act ? leaky(v) : v;
      }
    }
  }
};

// True in every thread of the last block to arrive at `counter` (of
// `total` blocks); the counter is left at 0 for the next launch. What the
// other blocks wrote to device memory before arriving is visible to the
// last one when it reads with __ldcg. Integer arrivals only: the sums that
// follow have one owner and a fixed order.
__device__ inline bool arrive_last(unsigned* counter, unsigned total) {
  __shared__ unsigned ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    ticket = atomicAdd(counter, 1u);
    if (ticket == total - 1) *counter = 0u;
  }
  __syncthreads();
  const bool last = ticket == total - 1;
  if (last) __threadfence();
  return last;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set when a launch asks for
// more than this device was given before (`have` is the kernel's own table,
// one entry a device) and not on every launch.
constexpr int MAX_DEVICES = 64;
template <class Kernel>
inline cudaError_t ensure_smem(Kernel kernel, size_t bytes,
                               int (&have)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((int)bytes <= have[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have[dev] = (int)bytes;
  return err;
}

}  // namespace mmnm_tp
