// Row-tile MLP building blocks of encoder.cu (pred_deviation.cu and
// decoder_nll.cu build on tile_product.cuh).
//
// One CTA owns TM rows of one fold and runs a whole chain of small linear
// layers on them: the first layer reads its input straight from device
// memory, every later layer reads the previous activation from shared
// memory, and only the heads write to device memory. A layer is a loop over
// BN-wide column blocks of its output; each block loops over the K dimension
// in BK-deep chunks staged in shared memory, so the input width is not
// bounded by shared memory (PPMI rows are 3485 features plus covariates).
//
// Arithmetic is plain fp32 FFMA (no TF32): the chains are tiny (hidden
// widths ~110, latent 10), so the bound is latency and device-memory reads
// of x and the weights, not tensor-core throughput.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mmnm {

constexpr int TM = 32;             // batch rows per CTA
constexpr int BN = 64;             // output columns per pass
constexpr int BK = 32;             // K chunk staged in shared memory
constexpr int GROUPS = 16;         // 16 row groups x 16 column groups
constexpr int THREADS = GROUPS * GROUPS;
constexpr int RM = TM / GROUPS;    // rows per thread
constexpr int RN = BN / GROUPS;    // columns per thread
constexpr int MAX_LAYERS = 8;

// One linear layer of every fold: w [F, n, k] (row-major, nn.Linear's
// [out, in] per fold), b [F, n].
struct Layer {
  const float* w;
  const float* b;
  int n;
  int k;
};

struct Layers {
  Layer l[MAX_LAYERS];
};

struct Stage {
  float a[TM][BK + 1];   // input chunk, rows x k
  float wt[BK][BN + 1];  // weight chunk, transposed: k x n
};

// Row r, column k of the concatenation [p | q] of two row-major matrices
// p [rows, P] and q [rows, Q]; rows past `rows` read as zero. This is the
// first layer's input (x|c in the encoder, z|c in the decoder) without a
// concatenated copy in device memory.
struct ConcatRows {
  const float* p;
  const float* q;
  int P;
  int Q;
  int rows;
  __device__ float operator()(int r, int k) const {
    if (r >= rows) return 0.f;
    return k < P ? p[(size_t)r * P + k] : q[(size_t)r * Q + (k - P)];
  }
};

// Row r, column k of an activation tile held in shared memory.
struct SmemRows {
  const float* h;
  int ld;
  __device__ float operator()(int r, int k) const { return h[r * ld + k]; }
};

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.01f * v;
}

// Epilogue: store into a shared-memory activation tile (LeakyReLU if act).
struct ToSmem {
  float* h;
  int ld;
  bool act;
  __device__ void operator()(int, int r, int n, float v) {
    h[r * ld + n] = act ? leaky(v) : v;
  }
};

// Epilogue: store the valid rows into a row-major [rows, ld] output.
struct ToGlobal {
  float* out;
  int ld;
  int rows;
  __device__ void operator()(int, int r, int n, float v) {
    if (r < rows) out[(size_t)r * ld + n] = v;
  }
};

// out[TM, N] = a[TM, K] . w[N, K]^T + b, handed to epi(i, r, n, value) for
// every column n < N; i indexes the thread's RM rows. Thread (tr, tc) owns
// rows tr + GROUPS*i and columns tc + GROUPS*j of each column block.
template <class A, class Epi>
__device__ void tile_layer(const A& a, const float* __restrict__ w,
                           const float* __restrict__ b, int N, int K,
                           Stage& st, Epi& epi) {
  const int tid = threadIdx.x;
  const int tr = tid / GROUPS;
  const int tc = tid % GROUPS;
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = tid; e < TM * BK; e += THREADS) {
        const int r = e / BK;
        const int kk = e % BK;
        st.a[r][kk] = (k0 + kk < K) ? a(r, k0 + kk) : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int nn = e / BK;
        const int kk = e % BK;
        const int n = n0 + nn;
        const int k = k0 + kk;
        st.wt[kk][nn] = (n < N && k < K) ? w[(size_t)n * K + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[RM];
        float wv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = st.a[tr + GROUPS * i][kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) wv[j] = st.wt[kk][tc + GROUPS * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + tc + GROUPS * j;
        if (n < N) epi(i, tr + GROUPS * i, n, acc[i][j] + b[n]);
      }
    }
  }
  // the next layer stages what this one's epilogue wrote
  __syncthreads();
}

// Fold f's slice of a layer's weights and bias.
__device__ __forceinline__ const float* fold_w(const Layer& ly, int f) {
  return ly.w + (size_t)f * ly.n * ly.k;
}
__device__ __forceinline__ const float* fold_b(const Layer& ly, int f) {
  return ly.b + (size_t)f * ly.n;
}

// Runs layers [0, n_hidden) on the tile, ping-ponging between h0 and h1.
// Returns the tile holding the last activation, or nullptr when there are
// no hidden layers (the heads then read the input directly).
template <class A>
__device__ const float* run_hidden(const A& in, const Layers& L, int n_hidden,
                                   int f, bool act, Stage& st, float* h0,
                                   float* h1, int ld) {
  const float* cur = nullptr;
  for (int l = 0; l < n_hidden; ++l) {
    const Layer& ly = L.l[l];
    float* out = (l % 2 == 0) ? h0 : h1;
    ToSmem epi{out, ld, act};
    if (cur == nullptr) {
      tile_layer(in, fold_w(ly, f), fold_b(ly, f), ly.n, ly.k, st, epi);
    } else {
      tile_layer(SmemRows{cur, ld}, fold_w(ly, f), fold_b(ly, f), ly.n, ly.k,
                 st, epi);
    }
    cur = out;
  }
  return cur;
}

// A head layer (no activation) on the last hidden activation.
template <class A, class Epi>
__device__ void run_head(const A& in, const float* cur, int ld,
                         const Layer& ly, int f, Stage& st, Epi& epi) {
  if (cur == nullptr) {
    tile_layer(in, fold_w(ly, f), fold_b(ly, f), ly.n, ly.k, st, epi);
  } else {
    tile_layer(SmemRows{cur, ld}, fold_w(ly, f), fold_b(ly, f), ly.n, ly.k,
               st, epi);
  }
}

// Dynamic shared memory of a CTA whose widest hidden layer is `ld`.
inline size_t smem_bytes(int ld) {
  return sizeof(Stage) + 2 * (size_t)TM * ld * sizeof(float);
}

// Fills L with `count` layers whose output widths are `widths`, chained
// from an input of width k_in; returns the widest of the first n_hidden.
inline int chain_layers(Layers& L, int count, int n_hidden,
                        const float* const* w, const float* const* b,
                        const int* widths, int k_in) {
  int k = k_in;
  int widest = 1;
  for (int l = 0; l < count; ++l) {
    L.l[l].w = w[l];
    L.l[l].b = b[l];
    L.l[l].n = widths[l];
    L.l[l].k = k;
    if (l < n_hidden) {
      k = widths[l];
      if (widths[l] > widest) widest = widths[l];
    }
  }
  return widest;
}

}  // namespace mmnm
