// Fused decode + deviation for every fold of a k-fold model at once.
//
// Replaces the Pallas kernel multi_modal_normative_modeling_tpu/kernels/
// deviation.py::fused_pred_deviation (_kernel): concat(z, c) -> reversed
// hidden linears (+LeakyReLU) -> mean head [B, D], and per row
// dev[b] = sum_d (x[b, d] - mean[b, d])^2 / D.
//
// With x and dev null it is the decoder's mean alone, and replaces the
// Pallas kernel multi_modal_normative_modeling_tpu/kernels/mlp.py::
// fused_decoder_mean (_decoder_kernel) too.
//
// What bounds it on an H100: operations at every shape the test stage has
// (12 us of fp32 FFMA at 67 TFLOP/s for 1024 x 3485 against 9 us for the
// bytes of x, recon and the mean head), but not by much: the design has to
// fill the card and keep the FFMA pipe fed, no more. What it does:
//   * a grid of (row tile of 32, column group, fold). Column groups exist
//     only where row tiles x folds would leave SMs empty (1024 PPMI rows
//     are 32 row tiles for 132 SMs): group q owns the mean head's 128-wide
//     column chunks q, q + G, ...; the wrapper picks G so a launch has up
//     to two blocks an SM. Each block recomputes the small hidden chain for
//     its rows (13 k of a PPMI row's 397 k multiply-adds) rather than take
//     a larger row tile, which would leave fewer blocks;
//   * activations stay in shared memory and are the products' A operand in
//     place; weights stream through tile_product.cuh's cp.async ring, the
//     sums in registers;
//   * recon is stored and x read straight from the lanes' registers: 8
//     neighbouring lanes cover 32 contiguous bytes of a row, a whole
//     sector. Rows of 3485 floats start on 4-byte boundaries only, so wider
//     accesses are not on offer there;
//   * a row's squared errors fold by shuffles over the lanes that share it,
//     then over the 4 column warps in order. With column groups each block
//     writes its rows' partials to scratch [G, F, B] and the last block of
//     a (row tile, fold) to arrive (an integer ticket) adds them in group
//     order: dev is bit-equal from call to call.
#include "tile_product.cuh"

namespace mmnm {
namespace {

using namespace mmnm_tp;

constexpr int MAX_LAYERS = 8;

// One linear layer of every fold: w [F, n, k] (nn.Linear's [out, in] per
// fold), b [F, n]; vec floats per cp.async of a row of w.
struct Layer {
  const float* w;
  const float* b;
  int n;
  int k;
  int vec;
};

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

// Epilogue of the mean head: store recon, add (x - mean)^2 to the lane's
// row sums.
struct ReconDeviation {
  float* recon;        // the tile's first row, column 0
  const float* x;      // likewise, or null
  const float* b;
  int D;
  int rows;
  float part[RM];
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
    float xv[RM][RN];
    if (x != nullptr) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + ln.col_nt(j);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = ln.row(i);
          xv[i][j] = (n < D && r < rows) ? x[(size_t)r * D + n] : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      if (n >= D) continue;
      const float bias = b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ln.row(i);
        if (r >= rows) continue;
        const float v = acc[i][j] + bias;
        recon[(size_t)r * D + n] = v;
        if (x != nullptr) {
          const float d = xv[i][j] - v;
          part[i] = fmaf(d, d, part[i]);
        }
      }
    }
  }
};

// Dynamic shared memory: the ring, two activation tiles [TM][ld], TM x 4
// floats for the row sums.
__global__ void __launch_bounds__(THREADS, 2)
pred_deviation_kernel(const float* __restrict__ z, const float* __restrict__ c,
                      const float* __restrict__ x, float* __restrict__ recon,
                      float* __restrict__ dev, float* scratch,
                      int B, int Z, int C, int D, Layers L, int n_hidden,
                      int non_linear, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* act0 = ring + RING_FLOATS;
  float* act1 = act0 + TM * ld;
  float* red = act1 + TM * ld;

  const Lanes ln;
  const int tile = blockIdx.x;
  const int grp = blockIdx.y;
  const int groups = gridDim.y;
  const int f = blockIdx.z;
  const int F = gridDim.z;
  const int row0 = tile * TM;
  const int rows = min(TM, B - row0);
  const size_t frow = (size_t)f * B + row0;

  // [z | c] of the tile's rows; every other entry of both tiles zero, so
  // the columns a product reads past a layer's width are finite
  const int K0 = Z + C;
  for (int e = threadIdx.x; e < 2 * TM * ld; e += THREADS) {
    const int r = e / ld;
    const int k = e % ld;
    float v = 0.f;
    if (r < rows && k < K0) {
      v = k < Z ? z[(frow + r) * Z + k] : c[(frow + r) * C + (k - Z)];
    }
    act0[e] = v;
  }
  __syncthreads();

  float* cur = act0;
  float* nxt = act1;
  for (int l = 0; l < n_hidden; ++l) {
    const Layer& ly = L.l[l];
    ToAct epi{nxt, ld, ly.b + (size_t)f * ly.n, ly.n, non_linear != 0};
    product_nt(cur, ld, ly.w + (size_t)f * ly.n * ly.k, ly.k, ly.n, ly.vec, 0,
               1, (ly.n + BN - 1) / BN, ring, epi);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  const Layer& head = L.l[n_hidden];
  ReconDeviation epi{recon + frow * D, x ? x + frow * D : nullptr,
                     head.b + (size_t)f * D, D, rows, {0.f, 0.f, 0.f, 0.f}};
  const int chunks = (D + BN - 1) / BN;
  product_nt(cur, ld, head.w + (size_t)f * D * head.k, head.k, D, head.vec,
             grp, groups, (chunks - grp + groups - 1) / groups, ring, epi);
  if (dev == nullptr) return;

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float s = epi.part[i];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (ln.lc == 0) red[ln.row(i) * 4 + ln.wc] = s;
  }
  __syncthreads();
  float mine = 0.f;
  if (threadIdx.x < TM) {
    const float* r = red + threadIdx.x * 4;
    mine = ((r[0] + r[1]) + r[2]) + r[3];
  }
  if (groups == 1) {
    if (threadIdx.x < rows) dev[frow + threadIdx.x] = mine / (float)D;
    return;
  }
  unsigned* tickets = reinterpret_cast<unsigned*>(scratch);
  float* part = scratch + (size_t)F * gridDim.x;   // [G, F, B]
  if (threadIdx.x < rows) {
    part[((size_t)grp * F) * B + frow + threadIdx.x] = mine;
  }
  if (!arrive_last(tickets + (size_t)f * gridDim.x + tile, groups)) return;
  if (threadIdx.x < rows) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) {
      s += __ldcg(part + ((size_t)q * F) * B + frow + threadIdx.x);
    }
    dev[frow + threadIdx.x] = s / (float)D;
  }
}

int have[MAX_DEVICES];

size_t smem_bytes(int ld) {
  return (RING_FLOATS + 2 * (size_t)TM * ld + TM * 4) * sizeof(float);
}

}  // namespace
}  // namespace mmnm

// The tile constants and the shared memory the Python plan mirrors:
// out = {TM, BN, bytes} for a widest activation (input or hidden) `widest`.
extern "C" void mmnm_pred_deviation_sizes(int widest, long long* out) {
  using namespace mmnm;
  out[0] = TM;
  out[1] = BN;
  out[2] = (long long)smem_bytes(tile_ld(widest));
}

// z [F, B, Z], c [F, B, C], x [F, B, D] -> recon [F, B, D], dev [F, B];
// x and dev both null: recon alone (the decoder mean).
// w, b and widths hold n_hidden + 1 layers: the hidden layers, then the
// mean head (width D). `groups` (>= 1) divides the mean head's column
// chunks over blocks; above 1 (and with dev) `scratch` holds F * ceil(B /
// 32) tickets (zero before the first launch; every launch leaves them zero)
// and then groups * F * B partials. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mmnm_pred_deviation(const float* z, const float* c,
                                   const float* x, float* recon, float* dev,
                                   float* scratch, int F, int B, int Z, int C,
                                   int D, int n_hidden,
                                   const float* const* w,
                                   const float* const* b, const int* widths,
                                   int non_linear, int groups, void* stream) {
  using namespace mmnm;
  const int chunks = (D + BN - 1) / BN;
  if (n_hidden < 0 || n_hidden + 1 > MAX_LAYERS || F <= 0 || B <= 0 ||
      D <= 0 || groups < 1 || groups > chunks) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L;
  int k = Z + C;
  int widest = k;
  for (int l = 0; l <= n_hidden; ++l) {
    L.l[l] = Layer{w[l], b[l], widths[l], k, copy_width(w[l], k)};
    if (l < n_hidden) {
      k = widths[l];
      widest = k > widest ? k : widest;
    }
  }
  const int ld = tile_ld(widest);
  const size_t smem = smem_bytes(ld);
  cudaError_t err = ensure_smem(pred_deviation_kernel, smem, have);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TM - 1) / TM, groups, F);
  pred_deviation_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      z, c, x, recon, dev, scratch, B, Z, C, D, L, n_hidden, non_linear, ld);
  return (int)cudaGetLastError();
}
