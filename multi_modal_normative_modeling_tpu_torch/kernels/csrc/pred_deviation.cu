// Fused decode + deviation for every fold of a k-fold model at once.
//
// Replaces the Pallas kernel multi_modal_normative_modeling_tpu/kernels/
// deviation.py::fused_pred_deviation (_kernel): concat(z, c) -> reversed
// hidden linears (+LeakyReLU) -> mean head [B, D], and per row
// dev[b] = sum_d (x[b, d] - mean[b, d])^2 / D.
//
// Same decomposition as encoder.cu: one CTA per (row tile, fold), the first
// layer reads z and c from device memory, hidden activations stay in shared
// memory. The mean head loops over D in column blocks: each block writes its
// slice of recon and adds its squared errors to per-thread row partials, so
// the [B, D] error matrix never exists. The partials are reduced across the
// 16 column threads of a row with warp shuffles in a fixed order, so dev is
// deterministic. Unlike the single-block TPU kernel there is no row-count
// limit: rows are tiled over the grid. What bounds it on an H100: the reads
// of x and the writes of recon ([B, D] each), plus the mean head's weights.
//
// With x and dev null it is the decoder's mean alone, and replaces the
// Pallas kernel multi_modal_normative_modeling_tpu/kernels/mlp.py::
// fused_decoder_mean (_decoder_kernel) too.
#include "tile_mlp.cuh"

namespace mmnm {

// Epilogue of the mean head: store recon, accumulate (x - mean)^2 per row.
struct ReconDeviation {
  float* recon;
  const float* x;
  int D;
  int rows;
  float part[RM];
  __device__ void operator()(int i, int r, int n, float v) {
    if (r < rows) {
      recon[(size_t)r * D + n] = v;
      if (x != nullptr) {
        const float d = x[(size_t)r * D + n] - v;
        part[i] = fmaf(d, d, part[i]);
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS)
pred_deviation_kernel(const float* __restrict__ z, const float* __restrict__ c,
                      const float* __restrict__ x, float* __restrict__ recon,
                      float* __restrict__ dev, int B, int Z, int C, int D,
                      Layers L, int n_hidden, int non_linear, int ld) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* h0 = smem + sizeof(Stage) / sizeof(float);
  float* h1 = h0 + TM * ld;

  const int f = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, B - row0);
  const size_t frow = (size_t)f * B + row0;

  const ConcatRows in{z + frow * Z, c + frow * C, Z, C, rows};
  const float* cur = run_hidden(in, L, n_hidden, f, non_linear != 0, st, h0,
                                h1, ld);
  ReconDeviation epi{recon + frow * D, x ? x + frow * D : nullptr, D, rows,
                     {}};
#pragma unroll
  for (int i = 0; i < RM; ++i) epi.part[i] = 0.f;
  run_head(in, cur, ld, L.l[n_hidden], f, st, epi);
  if (dev == nullptr) return;

  // the GROUPS column threads of a row are consecutive lanes of one warp
  const int tr = threadIdx.x / GROUPS;
  const int tc = threadIdx.x % GROUPS;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float s = epi.part[i];
#pragma unroll
    for (int off = GROUPS / 2; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    const int r = tr + GROUPS * i;
    if (tc == 0 && r < rows) dev[frow + r] = s / (float)D;
  }
}

}  // namespace mmnm

// z [F, B, Z], c [F, B, C], x [F, B, D] -> recon [F, B, D], dev [F, B];
// x and dev both null: recon alone (the decoder mean).
// w, b and widths hold n_hidden + 1 layers: the hidden layers, then the
// mean head (width D). Launches on `stream` and returns cudaGetLastError().
extern "C" int mmnm_pred_deviation(const float* z, const float* c,
                                   const float* x, float* recon, float* dev,
                                   int F, int B, int Z, int C, int D,
                                   int n_hidden, const float* const* w,
                                   const float* const* b, const int* widths,
                                   int non_linear, void* stream) {
  using namespace mmnm;
  if (n_hidden < 0 || n_hidden + 1 > MAX_LAYERS || F <= 0 || B <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L;
  const int ld = chain_layers(L, n_hidden + 1, n_hidden, w, b, widths, Z + C);
  const size_t smem = smem_bytes(ld);
  cudaError_t err = cudaFuncSetAttribute(
      pred_deviation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TM - 1) / TM, F);
  pred_deviation_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      z, c, x, recon, dev, B, Z, C, D, L, n_hidden, non_linear, ld);
  return (int)cudaGetLastError();
}
