// Fused decoder mean head + masked Gaussian NLL, forward and backward, for
// every fold of a k-fold model at once.
//
// Replaces the Pallas kernel pair multi_modal_normative_modeling_tpu/kernels/
// decoder_nll.py (_fwd_kernel and _bwd_kernel, the custom VJP of
// decoder_nll). Per fold f, with g [B, H] the last decoder activation,
// W [D, H], b [D], lvo [D], x [B, D], a row mask and n = max(sum(mask), 1):
//
//   mean = g . W^T + b
//   ll   = sum_r mask_r sum_d (-(x - mean)^2 e^-lvo / 2 - lvo / 2
//                              - log(2 pi) / 2) / n
//
// and, given the cotangent gbar of ll, with
// dmean = mask q (x - mean) gbar / n and q = e^-lvo:
//
//   dg = dmean . W,   dW = dmean^T . g,   db = sum_r dmean,
//   dlvo = sum_r mask (q (x - mean)^2 / 2 - 1 / 2) gbar / n.
//
// What it keeps out of device memory is the point of the op: no [B, D]
// mean, residual or dmean is ever written. Every pass recomputes the means
// of a 32 x 64 (row, column) tile with the row-tile product of tile_mlp.cuh
// and consumes the tile in shared memory. Device memory sees reads of g, x
// and W and writes of the narrow outputs.
//
// The TPU kernels run their grid in order and accumulate ll, dW, db and dlvo
// in place across row tiles. CUDA blocks run in no order, and atomics would
// make the trajectory differ from run to run, so every sum here has one
// owner and a fixed order:
//   * forward: block (row tile, split s, fold) sums its column chunks
//     s, s + S, ... into one partial (a fixed-order tree over the block);
//     a second kernel sums a fold's partials in a fixed order and divides
//     by n;
//   * dg: block (row tile, split s, fold) owns dg of its rows over column
//     chunks s, s + S, ...: the dmean tile times the W chunk, accumulated
//     in shared memory;
//   * dW, db, dlvo: block (column tile, split s, fold) owns those columns
//     over row tiles s, s + S, ...: dmean^T times the g tile, accumulated in
//     shared memory (db and dlvo in one thread per column).
// A split S > 1 writes per-split partials to scratch and a last kernel sums
// them in split order; the wrapper picks S so a launch fills the card (one
// PPMI fold is 8 row tiles of 256 rows, far fewer blocks than 132 SMs).
// Two identical calls give bit-identical results.
//
// What bounds it on an H100: the chained FFMA of the recomputed mean (plain
// fp32, no tensor cores) and shared-memory loads of the two backward
// products; the reads of x and W are a few MB.
#include "tile_mlp.cuh"

namespace mmnm {
namespace {

constexpr float HALF_LOG_2PI = 0.9189385332046727f;
constexpr int DM_LD = BN + 1;  // row stride of a dmean tile in shared memory

__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// Epilogue of the forward: the masked log-likelihood terms of a tile,
// summed per thread. x, lvo and mask point at the tile's first row and
// column.
struct NllTerms {
  const float* x;
  const float* lvo;
  const float* mask;
  int D;
  int rows;
  float part;
  __device__ void operator()(int, int r, int n, float v) {
    if (r < rows) {
      const float lv = lvo[n];
      const float d = x[(size_t)r * D + n] - v;
      part += mask[r] * (-0.5f * d * d * expf(-lv) - 0.5f * lv - HALF_LOG_2PI);
    }
  }
};

// Epilogue of the backward: dmean of a tile into shared memory, and, when
// `e` is set, the per-element dlvo terms beside it. Rows past `rows` are 0.
struct DmeanTile {
  float* dm;
  float* e;
  const float* x;
  const float* lvo;
  const float* mask;
  int D;
  int rows;
  float scale;  // gbar / n
  __device__ void operator()(int, int r, int n, float v) {
    float dmv = 0.f;
    float ev = 0.f;
    if (r < rows) {
      const float lv = lvo[n];
      const float q = expf(-lv);
      const float d = x[(size_t)r * D + n] - v;
      const float m = mask[r];
      dmv = m * q * d * scale;
      ev = m * (0.5f * d * d * q - 0.5f);
    }
    dm[r * DM_LD + n] = dmv;
    if (e != nullptr) e[r * DM_LD + n] = ev;
  }
};

struct Operands {
  const float* g;     // [F, B, H]
  const float* w;     // [F, D, H]
  const float* b;     // [F, D]
  const float* lvo;   // [F, D]
  const float* x;     // [F, B, D]
  const float* mask;  // [F, B]
  const float* n;     // [F]
  int B;
  int H;
  int D;
};

__global__ void __launch_bounds__(THREADS)
nll_fwd_kernel(Operands op, float* __restrict__ part, int split) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* red = smem + sizeof(Stage) / sizeof(float);

  const int f = blockIdx.z;
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, op.B - row0);
  const size_t frow = (size_t)f * op.B + row0;
  const float* wf = op.w + (size_t)f * op.D * op.H;
  const float* bf = op.b + (size_t)f * op.D;
  const float* lf = op.lvo + (size_t)f * op.D;

  const ConcatRows in{op.g + frow * op.H, nullptr, op.H, 0, rows};
  NllTerms epi{nullptr, nullptr, op.mask + frow, op.D, rows, 0.f};
  const int chunks = (op.D + BN - 1) / BN;
  for (int j = s; j < chunks; j += split) {
    const int c0 = j * BN;
    epi.x = op.x + frow * op.D + c0;
    epi.lvo = lf + c0;
    tile_layer(in, wf + (size_t)c0 * op.H, bf + c0, min(BN, op.D - c0), op.H,
               st, epi);
  }
  const float total = block_sum(epi.part, red);
  if (threadIdx.x == 0) {
    part[((size_t)f * gridDim.x + blockIdx.x) * split + s] = total;
  }
}

// ll[f] = (sum of fold f's `count` partials, in a fixed order) / n[f].
__global__ void nll_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ n,
                                  float* __restrict__ ll, int count) {
  const int f = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += 32) {
    s += part[(size_t)f * count + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (threadIdx.x == 0) ll[f] = s / n[f];
}

// dg of one row tile over column chunks s, s + split, ...; writes
// out[s, f, rows, H].
__global__ void __launch_bounds__(THREADS)
nll_dg_kernel(Operands op, const float* __restrict__ gbar,
              float* __restrict__ out, int split) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* dm = smem + sizeof(Stage) / sizeof(float);  // [TM][DM_LD]
  float* wc = dm + TM * DM_LD;                       // [BN][H] W chunk
  float* acc = wc + BN * op.H;                       // [TM][H] dg

  const int H = op.H;
  const int f = blockIdx.z;
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, op.B - row0);
  const size_t frow = (size_t)f * op.B + row0;
  const float* wf = op.w + (size_t)f * op.D * H;
  const float* bf = op.b + (size_t)f * op.D;
  const float* lf = op.lvo + (size_t)f * op.D;

  for (int e = threadIdx.x; e < TM * H; e += THREADS) acc[e] = 0.f;
  const ConcatRows in{op.g + frow * H, nullptr, H, 0, rows};
  DmeanTile epi{dm, nullptr, nullptr, nullptr, op.mask + frow, op.D, rows,
                gbar[f] / op.n[f]};
  const int chunks = (op.D + BN - 1) / BN;
  for (int j = s; j < chunks; j += split) {
    const int c0 = j * BN;
    const int ncols = min(BN, op.D - c0);
    const float* wchunk = wf + (size_t)c0 * H;
    for (int e = threadIdx.x; e < ncols * H; e += THREADS) wc[e] = wchunk[e];
    epi.x = op.x + frow * op.D + c0;
    epi.lvo = lf + c0;
    // ends with __syncthreads: dm and wc are complete
    tile_layer(in, wchunk, bf + c0, ncols, H, st, epi);
    for (int e = threadIdx.x; e < TM * H; e += THREADS) {
      const int r = e / H;
      const int h = e % H;
      float sum = 0.f;
      for (int k = 0; k < ncols; ++k) {
        sum = fmaf(dm[r * DM_LD + k], wc[k * H + h], sum);
      }
      acc[e] += sum;
    }
    __syncthreads();
  }
  float* dst = out + ((size_t)s * gridDim.z * op.B + frow) * H;
  for (int e = threadIdx.x; e < rows * H; e += THREADS) dst[e] = acc[e];
}

// dW, db and dlvo of one column tile over row tiles s, s + split, ...;
// writes dw[s, f, cols, H], db[s, f, cols] and dlvo[s, f, cols].
__global__ void __launch_bounds__(THREADS)
nll_dw_kernel(Operands op, const float* __restrict__ gbar,
              float* __restrict__ dw, float* __restrict__ db,
              float* __restrict__ dlvo, int split) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* dm = smem + sizeof(Stage) / sizeof(float);  // [TM][DM_LD]
  float* et = dm + TM * DM_LD;                       // [TM][DM_LD] dlvo terms
  float* gt = et + TM * DM_LD;                       // [TM][H] g tile
  float* acc = gt + TM * op.H;                       // [BN][H] dW

  const int H = op.H;
  const int f = blockIdx.z;
  const int s = blockIdx.y;
  const int c0 = blockIdx.x * BN;
  const int ncols = min(BN, op.D - c0);
  const float* wf = op.w + (size_t)f * op.D * H;
  const float* bf = op.b + (size_t)f * op.D;
  const float* lf = op.lvo + (size_t)f * op.D;
  const float scale = gbar[f] / op.n[f];

  for (int e = threadIdx.x; e < BN * H; e += THREADS) acc[e] = 0.f;
  float db_acc = 0.f;  // thread c < ncols owns column c's db and dlvo
  float lv_acc = 0.f;
  const int tiles = (op.B + TM - 1) / TM;
  for (int t = s; t < tiles; t += split) {
    const int row0 = t * TM;
    const int rows = min(TM, op.B - row0);
    const size_t frow = (size_t)f * op.B + row0;
    const float* gsrc = op.g + frow * H;
    for (int e = threadIdx.x; e < TM * H; e += THREADS) {
      gt[e] = (e / H < rows) ? gsrc[e] : 0.f;
    }
    __syncthreads();
    DmeanTile epi{dm, et, op.x + frow * op.D + c0, lf + c0, op.mask + frow,
                  op.D, rows, scale};
    // ends with __syncthreads: dm and et are complete
    tile_layer(SmemRows{gt, H}, wf + (size_t)c0 * H, bf + c0, ncols, H, st,
               epi);
    for (int e = threadIdx.x; e < ncols * H; e += THREADS) {
      const int c = e / H;
      const int h = e % H;
      float sum = 0.f;
#pragma unroll 8
      for (int r = 0; r < TM; ++r) {
        sum = fmaf(dm[r * DM_LD + c], gt[r * H + h], sum);
      }
      acc[e] += sum;
    }
    if (threadIdx.x < ncols) {
      for (int r = 0; r < TM; ++r) {
        db_acc += dm[r * DM_LD + threadIdx.x];
        lv_acc += et[r * DM_LD + threadIdx.x];
      }
    }
    __syncthreads();
  }
  const size_t col = (size_t)s * gridDim.z * op.D + (size_t)f * op.D + c0;
  float* dst = dw + col * H;
  for (int e = threadIdx.x; e < ncols * H; e += THREADS) dst[e] = acc[e];
  if (threadIdx.x < ncols) {
    db[col + threadIdx.x] = db_acc;
    dlvo[col + threadIdx.x] = lv_acc * scale;
  }
}

// out[i] = sum over k < split of part[k * count + i], in order of k.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int split,
                                  size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

int sum_splits(const float* part, float* out, int split, size_t count,
               cudaStream_t stream) {
  const int threads = 256;
  const size_t want = (count + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  sum_splits_kernel<<<blocks, threads, 0, stream>>>(part, out, split, count);
  return (int)cudaGetLastError();
}

size_t dg_smem(int H) {
  return sizeof(Stage) + (TM * DM_LD + (size_t)(BN + TM) * H) * sizeof(float);
}

size_t dw_smem(int H) {
  return sizeof(Stage) +
         (2 * TM * DM_LD + (size_t)(TM + BN) * H) * sizeof(float);
}

bool bad_shape(int F, int B, int H, int D) {
  return F <= 0 || B <= 0 || H <= 0 || D <= 0;
}

}  // namespace
}  // namespace mmnm

// Forward: ll [F]. `part` is scratch of F * ceil(B / 32) * split floats;
// split (>= 1) divides a row tile's ceil(D / 64) column chunks over blocks.
extern "C" int mmnm_decoder_nll_fwd(const float* g, const float* w,
                                    const float* b, const float* lvo,
                                    const float* x, const float* mask,
                                    const float* n, float* part, float* ll,
                                    int F, int B, int H, int D, int split,
                                    void* stream) {
  using namespace mmnm;
  if (bad_shape(F, B, H, D) || split < 1) return (int)cudaErrorInvalidValue;
  const Operands op{g, w, b, lvo, x, mask, n, B, H, D};
  const size_t smem = sizeof(Stage) + THREADS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nll_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + TM - 1) / TM;
  const dim3 grid(tiles, split, F);
  auto s = (cudaStream_t)stream;
  nll_fwd_kernel<<<grid, THREADS, smem, s>>>(op, part, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nll_reduce_kernel<<<F, 32, 0, s>>>(part, n, ll, tiles * split);
  return (int)cudaGetLastError();
}

// Backward: dg [F, B, H], dw [F, D, H], db [F, D], dlvo [F, D] from the
// cotangent gbar [F]. dg_split divides a row tile's column chunks, dw_split
// a column tile's row tiles, over blocks; with a split above 1 the partials
// go to the *_part scratch ([split, ...] each) and are summed in split
// order, otherwise the scratch pointers are unused.
extern "C" int mmnm_decoder_nll_bwd(
    const float* g, const float* w, const float* b, const float* lvo,
    const float* x, const float* mask, const float* n, const float* gbar,
    float* dg, float* dw, float* db, float* dlvo, float* dg_part,
    float* dw_part, float* db_part, float* dlvo_part, int F, int B, int H,
    int D, int dg_split, int dw_split, void* stream) {
  using namespace mmnm;
  if (bad_shape(F, B, H, D) || dg_split < 1 || dw_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Operands op{g, w, b, lvo, x, mask, n, B, H, D};
  auto s = (cudaStream_t)stream;
  int rc;

  size_t smem = dg_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      nll_dg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dg_grid((B + TM - 1) / TM, dg_split, F);
  nll_dg_kernel<<<dg_grid, THREADS, smem, s>>>(
      op, gbar, dg_split > 1 ? dg_part : dg, dg_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dg_split > 1) {
    rc = sum_splits(dg_part, dg, dg_split, (size_t)F * B * H, s);
    if (rc != 0) return rc;
  }

  smem = dw_smem(H);
  err = cudaFuncSetAttribute(
      nll_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 dw_grid((D + BN - 1) / BN, dw_split, F);
  const bool parts = dw_split > 1;
  nll_dw_kernel<<<dw_grid, THREADS, smem, s>>>(
      op, gbar, parts ? dw_part : dw, parts ? db_part : db,
      parts ? dlvo_part : dlvo, dw_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (parts) {
    const size_t cols = (size_t)F * D;
    rc = sum_splits(dw_part, dw, dw_split, cols * H, s);
    if (rc == 0) rc = sum_splits(db_part, db, dw_split, cols, s);
    if (rc == 0) rc = sum_splits(dlvo_part, dlvo, dw_split, cols, s);
    if (rc != 0) return rc;
  }
  return 0;
}
