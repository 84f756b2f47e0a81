// Fused conditional encoder for every fold of a k-fold model at once.
//
// Replaces the Pallas kernel multi_modal_normative_modeling_tpu/kernels/
// mlp.py::fused_encoder (_encoder_kernel): concat(x, c) -> hidden linears
// (+LeakyReLU 0.01 when non_linear) -> mu and logvar heads.
//
// What bounds it on an H100: operations (12 us of fp32 FFMA at 67 TFLOP/s
// for 1024 rows of 3485 features against 4 us for the bytes of x), and
// nearly all of them are the first layer's, whose reduction is as long as
// the input is wide while its output is one 128-column block. So the design
// has to spread that one reduction over the card. What it does:
//   * a grid of (row tile of 32, K split, fold). Block (t, s, f) copies
//     columns [s k_per, (s + 1) k_per) of its rows of [x | c] into shared
//     memory with cp.async (c joins at column D: no concatenated copy is
//     ever made in device memory) and multiplies them against the same
//     columns of the first layer's weights through tile_product.cuh
//     (weights streamed through the cp.async ring, sums in registers). The
//     wrapper's plan picks the splits: as many as fill the card at two
//     blocks an SM, which also bounds the slice a block holds;
//   * with one split the block goes on through the chain. With more, every
//     block writes its raw partial sums to scratch [split, F, B, N0] and
//     the last block of a (row tile, fold) to arrive (an integer ticket, no
//     float atomics) adds them in split order, adds the bias, applies the
//     activation and runs the rest of the chain: two calls give bit-equal
//     results;
//   * the rest of the chain (hidden to hidden, the two heads) runs on
//     activation tiles in shared memory, which are the products' A operand
//     in place; only mu and logvar go to device memory. The second
//     activation tile lies over the input slice, which is dead by then;
//   * the two heads are 2 Z columns (20 of a 128-column tile): as two
//     products they would be eight chunk steps with two of eight warps at
//     work. Where their weights fit the ring they are copied there whole
//     and every thread takes one row and every eighth column, straight
//     from the activation tile;
//   * without a hidden layer the two heads read [x | c] themselves, and the
//     split applies to them (N0 = 2 Z: mu's columns, then logvar's).
#include "tile_product.cuh"

namespace mmnm {
namespace {

using namespace mmnm_tp;

// Source columns [lo, hi) of the tile's rows of src (rows ld floats apart)
// to a[r][dst0 + (s - lo)] for r < TM; rows past `rows` become zero. lo,
// hi, dst0 and ld are multiples of VEC and src is aligned to it.
template <int VEC>
__device__ __forceinline__ void stage_cols(float* a, int lda, int dst0,
                                           const float* src, int ld, int rows,
                                           int lo, int hi) {
  const int groups = (hi - lo) / VEC;
  // a warp a row, a lane a group: no division by a run-time width
  for (int r = threadIdx.x >> 5; r < TM; r += THREADS / 32) {
    const bool ok = r < rows;
    const float* from = ok ? src + (size_t)r * ld + lo : src;
    float* to = a + r * lda + dst0;
    for (int g = threadIdx.x & 31; g < groups; g += 32) {
      cp_async<VEC>(to + VEC * g, ok ? from + VEC * g : src, ok);
    }
  }
}

// n floats at p (16-byte aligned, n a multiple of 4) become zero.
__device__ __forceinline__ void zero_floats(float* p, int n) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int e = threadIdx.x; e < n / 4; e += THREADS) {
    q[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void stage_cols(float* a, int lda, int dst0,
                                           const float* src, int ld, int rows,
                                           int lo, int hi, int vec) {
  if (vec == 4) {
    stage_cols<4>(a, lda, dst0, src, ld, rows, lo, hi);
  } else if (vec == 2) {
    stage_cols<2>(a, lda, dst0, src, ld, rows, lo, hi);
  } else {
    stage_cols<1>(a, lda, dst0, src, ld, rows, lo, hi);
  }
}

// Epilogue of a head: v + b to device memory.
struct ToGlobal {
  float* out;          // the tile's first row, column 0
  const float* b;
  int N;
  int rows;
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      if (n >= N) continue;
      const float bias = b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ln.row(i);
        if (r < rows) out[(size_t)r * N + n] = acc[i][j] + bias;
      }
    }
  }
};

// Epilogue of a split first layer: the raw sums to the split's partials.
struct ToPart {
  float* out;          // the tile's first row, this product's first column
  int ld;              // N0
  int N;
  int rows;
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ln.row(i);
        if (r < rows) out[(size_t)r * ld + n] = acc[i][j];
      }
    }
  }
};

// Row stride of the heads' weights [2 Z][K] in the ring: 4 mod 32, so that
// eight rows read as float4 fall in distinct banks.
__host__ __device__ inline int heads_ld(int K) {
  return (K + 31) / 32 * 32 + 4;
}

template <int VEC>
__device__ __forceinline__ void stage_heads(float* wt, int ldw,
                                            const float* wm, const float* wl,
                                            int Z, int K) {
  const int groups = K / VEC;
  for (int n = threadIdx.x >> 5; n < 2 * Z; n += THREADS / 32) {
    const float* row = n < Z ? wm + (size_t)n * K : wl + (size_t)(n - Z) * K;
    for (int g = threadIdx.x & 31; g < groups; g += 32) {
      cp_async<VEC>(wt + n * ldw + VEC * g, row + VEC * g, true);
    }
  }
}

// Both heads at once from the activation tile `act` [TM][ld] (zero past its
// K columns): their weights [2 Z][K] go to `wt` (the ring, free by now), a
// thread takes one row and the columns g, g + 8, ... of mu's Z and logvar's
// Z. `mu` and `lv` point at the tile's first row.
__device__ __forceinline__ void heads_direct(const float* act, int ld,
                                             float* wt, const Layer& lm,
                                             const Layer& ll, int f, int Z,
                                             int rows, float* mu, float* lv) {
  const int K = lm.k;
  const int K4 = (K + 3) & ~3;
  const int ldw = heads_ld(K);
  const float* wm = lm.w + (size_t)f * Z * K;
  const float* wl = ll.w + (size_t)f * Z * K;
  for (int e = threadIdx.x; e < 2 * Z * (K4 - K); e += THREADS) {
    wt[(e / (K4 - K)) * ldw + K + e % (K4 - K)] = 0.f;
  }
  const int vec = min(lm.vec, ll.vec);
  if (vec == 4) {
    stage_heads<4>(wt, ldw, wm, wl, Z, K);
  } else if (vec == 2) {
    stage_heads<2>(wt, ldw, wm, wl, Z, K);
  } else {
    stage_heads<1>(wt, ldw, wm, wl, Z, K);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int g = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < TM; r += THREADS / 8) {
    const float* a = act + r * ld;
    for (int n0 = 0; n0 < 2 * Z; n0 += 32) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + g + 8 * j;
        wp[j] = wt + (n < 2 * Z ? n : 0) * ldw;
      }
      for (int k = 0; k < K4; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(wp[j] + k);
          acc[j] = fmaf(av.x, wv.x, acc[j]);
          acc[j] = fmaf(av.y, wv.y, acc[j]);
          acc[j] = fmaf(av.z, wv.z, acc[j]);
          acc[j] = fmaf(av.w, wv.w, acc[j]);
        }
      }
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + g + 8 * j;
        if (n < Z) {
          mu[(size_t)r * Z + n] = acc[j] + lm.b[(size_t)f * Z + n];
        } else if (n < 2 * Z) {
          lv[(size_t)r * Z + n - Z] = acc[j] + ll.b[(size_t)f * Z + n - Z];
        }
      }
    }
  }
}

// Dynamic shared memory: the ring; `first`, the slice [TM][lda] of [x | c]
// and later an activation tile [TM][ld]; `second`, an activation tile.
__global__ void __launch_bounds__(THREADS, 2)
encoder_kernel(const float* __restrict__ x, const float* __restrict__ c,
               float* __restrict__ mu, float* __restrict__ lv, float* scratch,
               int B, int D, int C, int Z, Layers L, int n_hidden,
               int non_linear, int k_per, int lda, int ld, int first_floats,
               int vec_x, int vec_c, int direct_heads) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* first = ring + RING_FLOATS;
  float* second = first + first_floats;

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int f = blockIdx.z;
  const int F = gridDim.z;
  const int row0 = tile * TM;
  const int rows = min(TM, B - row0);
  const size_t frow = (size_t)f * B + row0;
  const int K = D + C;
  const int k_lo = split * k_per;
  const int k_hi = min(K, k_lo + k_per);
  const int kw = k_hi - k_lo;
  const bool act = non_linear != 0;

  // the block's columns of [x | c]
  if (k_lo < D) {
    stage_cols(first, lda, 0, x + frow * D, D, rows, k_lo, min(D, k_hi),
               vec_x);
  }
  if (k_hi > D) {
    const int lo = max(k_lo, D);
    stage_cols(first, lda, lo - k_lo, c + frow * C, C, rows, lo - D, k_hi - D,
               vec_c);
  }
  cp_async_commit();
  // every other entry of both regions zero, so that what a product reads
  // past a layer's width is finite
  for (int r = threadIdx.x >> 5; r < TM; r += THREADS / 32) {
    for (int k = kw + (threadIdx.x & 31); k < lda; k += 32) {
      first[r * lda + k] = 0.f;
    }
  }
  zero_floats(first + TM * lda, first_floats - TM * lda);
  zero_floats(second, TM * ld);

  // the layers that read [x | c]: the first hidden layer, or both heads
  const int n_first = n_hidden > 0 ? 1 : 2;
  const int N0 = n_hidden > 0 ? L.l[0].n : 2 * Z;
  float* part = scratch + (size_t)F * gridDim.x;   // [splits, F, B, N0]
  for (int q = 0; q < n_first; ++q) {
    const Layer& ly = L.l[q];
    const float* w = ly.w + (size_t)f * ly.n * K + k_lo;
    const float* b = ly.b + (size_t)f * ly.n;
    const int blocks = (ly.n + BN - 1) / BN;
    if (splits > 1) {
      ToPart epi{part + (((size_t)split * F) * B + frow) * N0 + q * Z, N0,
                 ly.n, rows};
      product_nt(first, lda, w, K, kw, ly.n, ly.vec, 0, 1, blocks, ring, epi);
    } else if (n_hidden > 0) {
      ToAct epi{second, ld, b, ly.n, act};
      product_nt(first, lda, w, K, kw, ly.n, ly.vec, 0, 1, blocks, ring, epi);
    } else {
      ToGlobal epi{(q == 0 ? mu : lv) + frow * Z, b, Z, rows};
      product_nt(first, lda, w, K, kw, ly.n, ly.vec, 0, 1, blocks, ring, epi);
    }
  }

  if (splits > 1) {
    unsigned* tickets = reinterpret_cast<unsigned*>(scratch);
    if (!arrive_last(tickets + (size_t)f * gridDim.x + tile, splits)) return;
    // the tile's rows of a split's partials are `count` floats in a row.
    // A thread sums four entries at a time, eight splits' loads of each in
    // flight together, and adds them in split order (a split past the last
    // adds 0, which changes nothing)
    const int count = rows * N0;
    const float* mine = part + frow * N0;
    const size_t per_split = (size_t)F * B * N0;
    for (int e0 = threadIdx.x; e0 < count; e0 += 4 * THREADS) {
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q0 = 0; q0 < splits; q0 += 8) {
        float v[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = e0 + i * THREADS;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            v[i][j] = (e < count && q0 + j < splits)
                          ? __ldcg(mine + (q0 + j) * per_split + e)
                          : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) sum[i] += v[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + i * THREADS;
        if (e >= count) continue;
        const int r = e / N0;
        const int n = e % N0;
        if (n_hidden > 0) {
          const float v0 = sum[i] + L.l[0].b[(size_t)f * N0 + n];
          second[r * ld + n] = act ? leaky(v0) : v0;
        } else if (n < Z) {
          mu[(frow + r) * Z + n] = sum[i] + L.l[0].b[(size_t)f * Z + n];
        } else {
          lv[(frow + r) * Z + n - Z] =
              sum[i] + L.l[1].b[(size_t)f * Z + n - Z];
        }
      }
    }
  }
  if (n_hidden == 0) return;

  // `first` turns from the input slice into an activation tile
  if (n_hidden > 1) zero_floats(first, TM * ld);
  __syncthreads();
  float* cur = second;
  float* nxt = first;
  for (int l = 1; l < n_hidden; ++l) {
    const Layer& ly = L.l[l];
    ToAct epi{nxt, ld, ly.b + (size_t)f * ly.n, ly.n, act};
    product_nt(cur, ld, ly.w + (size_t)f * ly.n * ly.k, ly.k, ly.n, ly.vec, 0,
               1, (ly.n + BN - 1) / BN, ring, epi);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (direct_heads) {
    heads_direct(cur, ld, ring, L.l[n_hidden], L.l[n_hidden + 1], f, Z, rows,
                 mu + frow * Z, lv + frow * Z);
    return;
  }
  for (int q = 0; q < 2; ++q) {
    const Layer& ly = L.l[n_hidden + q];
    ToGlobal epi{(q == 0 ? mu : lv) + frow * Z, ly.b + (size_t)f * Z, Z, rows};
    product_nt(cur, ld, ly.w + (size_t)f * Z * ly.k, ly.k, Z, ly.vec, 0, 1,
               (Z + BN - 1) / BN, ring, epi);
  }
}

int have[MAX_DEVICES];

// Floats of the region that holds the input slice, then an activation tile.
int first_region(int k_per, int ld) {
  const int lda = tile_ld(k_per);
  return TM * (lda > ld ? lda : ld);
}

size_t smem_bytes(int k_per, int ld) {
  return (RING_FLOATS + (size_t)first_region(k_per, ld) + TM * ld) *
         sizeof(float);
}

}  // namespace
}  // namespace mmnm

// The tile constants and the shared memory the Python plan mirrors:
// out = {TM, BN, BK, bytes} for a slice of k_per columns and a widest hidden
// layer `widest` (1 without a hidden layer).
extern "C" void mmnm_encoder_sizes(int k_per, int widest, long long* out) {
  using namespace mmnm;
  out[0] = TM;
  out[1] = BN;
  out[2] = BK;
  out[3] = (long long)smem_bytes(k_per, tile_ld(widest));
}

// x [F, B, D], c [F, B, C] -> mu, lv [F, B, Z]. w, b and widths hold
// n_hidden + 2 layers: the hidden layers, then the mu head and the logvar
// head (widths Z). The reduction over D + C is cut into `splits` slices of
// k_per columns (a multiple of the chunk depth; every slice holds a column).
// With splits > 1 `scratch` holds F * ceil(B / 32) tickets (zero before the
// first launch; every launch leaves them zero) and then splits * F * B * N0
// partials, N0 the first hidden width, or 2 Z without a hidden layer.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int mmnm_encoder(const float* x, const float* c, float* mu,
                            float* lv, float* scratch, int F, int B, int D,
                            int C, int Z, int n_hidden,
                            const float* const* w, const float* const* b,
                            const int* widths, int non_linear, int splits,
                            int k_per, void* stream) {
  using namespace mmnm;
  const int K = D + C;
  if (n_hidden < 0 || n_hidden + 2 > MAX_LAYERS || F <= 0 || B <= 0 ||
      D <= 0 || C < 0 || Z <= 0 || splits < 1 || k_per <= 0 ||
      k_per % BK != 0 || (long long)k_per * splits < K ||
      (long long)k_per * (splits - 1) >= K ||
      (splits > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L;
  int k = K;
  int widest = 1;
  for (int l = 0; l < n_hidden + 2; ++l) {
    // a split's window starts a multiple of BK floats into a row: as
    // aligned as the row itself
    L.l[l] = Layer{w[l], b[l], widths[l], k, copy_width(w[l], k)};
    if (l < n_hidden) {
      k = widths[l];
      widest = k > widest ? k : widest;
    }
  }
  const int vec_x = copy_width(x, D);
  // c lands at column D of the slice, so D bounds its copies' width too
  int vec_c = C > 0 ? copy_width(c, C) : 1;
  while (D % vec_c != 0) vec_c /= 2;
  const int ld = tile_ld(widest);
  // the heads straight from the last activation tile where their weights
  // fit the ring; as two products where not
  const int direct_heads =
      n_hidden > 0 && 2 * (long long)Z * heads_ld(k) <= RING_FLOATS;
  const size_t smem = smem_bytes(k_per, ld);
  cudaError_t err = ensure_smem(encoder_kernel, smem, have);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TM - 1) / TM, splits, F);
  encoder_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, c, mu, lv, scratch, B, D, C, Z, L, n_hidden, non_linear, k_per,
      tile_ld(k_per), ld, first_region(k_per, ld), vec_x, vec_c, direct_heads);
  return (int)cudaGetLastError();
}

extern "C" const char* mmnm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
