// Fused conditional encoder for every fold of a k-fold model at once.
//
// Replaces the Pallas kernel multi_modal_normative_modeling_tpu/kernels/
// mlp.py::fused_encoder (_encoder_kernel): concat(x, c) -> hidden linears
// (+LeakyReLU 0.01 when non_linear) -> mu and logvar heads.
//
// Grid: (row tiles of TM rows, folds). The fold axis takes the place of the
// JAX package's vmap over folds; weights are fold-stacked [F, n, k]. The
// first layer reads x and c straight from device memory (column < D reads x,
// the rest reads c), hidden activations stay in shared memory in fp32, and
// only mu and logvar are written back. What bounds it on an H100: one read
// of x and of each fold's weights per row tile, and the latency of a chain
// of dependent small products; the TPU version's 128-lane padding and VMEM
// budget do not carry over, bounds checks take their place.
#include "tile_mlp.cuh"

namespace mmnm {

__global__ void __launch_bounds__(THREADS)
encoder_kernel(const float* __restrict__ x, const float* __restrict__ c,
               float* __restrict__ mu, float* __restrict__ lv, int B, int D,
               int C, int Z, Layers L, int n_hidden, int non_linear, int ld) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* h0 = smem + sizeof(Stage) / sizeof(float);
  float* h1 = h0 + TM * ld;

  const int f = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, B - row0);
  const size_t frow = (size_t)f * B + row0;

  const ConcatRows in{x + frow * D, c + frow * C, D, C, rows};
  const float* cur = run_hidden(in, L, n_hidden, f, non_linear != 0, st, h0,
                                h1, ld);
  ToGlobal to_mu{mu + frow * Z, Z, rows};
  run_head(in, cur, ld, L.l[n_hidden], f, st, to_mu);
  ToGlobal to_lv{lv + frow * Z, Z, rows};
  run_head(in, cur, ld, L.l[n_hidden + 1], f, st, to_lv);
}

}  // namespace mmnm

// x [F, B, D], c [F, B, C] -> mu, lv [F, B, Z]. w, b and widths hold
// n_hidden + 2 layers: the hidden layers, then the mu head and the logvar
// head (widths Z). Launches on `stream` and returns cudaGetLastError().
extern "C" int mmnm_encoder(const float* x, const float* c, float* mu,
                            float* lv, int F, int B, int D, int C, int Z,
                            int n_hidden, const float* const* w,
                            const float* const* b, const int* widths,
                            int non_linear, void* stream) {
  using namespace mmnm;
  if (n_hidden < 0 || n_hidden + 2 > MAX_LAYERS || F <= 0 || B <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L;
  const int ld = chain_layers(L, n_hidden + 2, n_hidden, w, b, widths, D + C);
  const size_t smem = smem_bytes(ld);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TM - 1) / TM, F);
  encoder_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, c, mu, lv, B, D, C, Z, L, n_hidden, non_linear, ld);
  return (int)cudaGetLastError();
}

extern "C" const char* mmnm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
