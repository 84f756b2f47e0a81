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
// mean, residual or dmean is ever written.
//
// What bounds it on an H100: operations. A pair is 6 B H D FLOP of plain
// fp32 FFMA (8.8 us at 67 TFLOP/s for one PPMI fold, 256 x 110 x 3485)
// against a few MB of reads. Tensor cores stay out: one TF32 pass keeps
// three digits, and a three-pass split held the gradient check of the
// train-step kernels but not their 20-step trajectory check. What the
// design does about it:
//   * every product keeps its sums in registers (tile_product.cuh): the
//     mean and dg = dmean . W as 4 x 4 tiles a lane over streamed W
//     chunks, dW = dmean^T . g as an 8 x 8 tile a lane straight from the
//     dmean and g tiles in shared memory (64 FFMA for 4 128-bit loads);
//   * the mean is computed twice a pair, not three times: one backward
//     kernel takes each (column chunk, row tile) dmean tile once for dg,
//     dW, db and dlvo;
//   * e^-lvo is taken once a column and lane, db and dlvo are column sums
//     over the lanes' registers folded by shuffles;
//   * a pair is three launches: forward, backward, one sum of the
//     partials.
//
// CUDA blocks run in no order, and float atomics would make the trajectory
// differ from run to run, so every sum has one owner and a fixed order:
//   * forward: block (row tile, split s, fold) walks column chunks s,
//     s + S, ... with its g tile resident and writes one partial; the last
//     block of a fold to arrive (an integer ticket) sums the fold's
//     partials in index order and divides by n;
//   * backward: block (column chunk, row split s, fold x h block) walks row
//     tiles s, s + S, ...; per tile it writes dg of (tile, chunk) to the
//     chunk's partial and adds the tile's dW into its split's partial, which
//     no other block touches; db and dlvo stay in registers until the end;
//   * the sum kernel adds the dg partials in chunk order and the dW, db,
//     dlvo partials in split order. With one chunk (D <= 128) or one split
//     the backward writes the output itself.
// Two identical calls give bit-identical results.
//
// H wider than 128 goes to the grid as h blocks: each recomputes the mean
// over all of H and owns 128 columns of dg and dW.
#include "tile_product.cuh"

namespace mmnm {
namespace {

using namespace mmnm_tp;

constexpr float HALF_LOG_2PI = 0.9189385332046727f;

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
  int vec_g;          // floats per cp.async of g's rows
  int vec_w;          // and of W's
};

// Rows [row0, row0 + TM) of g (zero past `rows`) into tile[TM][ld], as one
// cp.async group.
__device__ __forceinline__ void stage_g(float* tile, int ld, const float* g, int H, int vec,
                        int rows) {
  const int Hp = (H + 3) & ~3;
  for (int h0 = 0; h0 < Hp; h0 += BN) {
    // a [TM][BN] block at a time: the tile's stride is not a template value
    for (int e = threadIdx.x; e < TM * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4);
      const int h = h0 + 4 * (e % (BN / 4));
      if (h >= Hp) continue;
      float* dst = tile + r * ld + h;
      const float* src = g + (size_t)r * H + h;
      if (vec == 4) {
        cp_async<4>(dst, r < rows ? src : g, r < rows);
      } else if (vec == 2) {
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const bool ok = r < rows && h + q < H;
          cp_async<2>(dst + q, ok ? src + q : g, ok);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = r < rows && h + q < H;
          cp_async<1>(dst + q, ok ? src + q : g, ok);
        }
      }
    }
  }
  cp_async_commit();
}

// Columns roundup4(H) .. ld of a g tile, which stage_g never writes: zero,
// so that what a product reads past H is finite.
__device__ void zero_pad(float* tile, int ld, int H) {
  const int Hp = (H + 3) & ~3;
  const int pad = ld - Hp;
  for (int e = threadIdx.x; e < TM * pad; e += THREADS) {
    tile[(e / pad) * ld + Hp + e % pad] = 0.f;
  }
}

__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// Epilogue of the forward: the masked log-likelihood terms of a 32 x 128
// tile, summed per thread.
struct NllTerms {
  const float* x;      // the tile's first row, column 0
  const float* b;
  const float* lvo;
  const float* mask;   // the tile's first row
  int D;
  int rows;
  float part;
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
    float xv[RM][RN];
    float bias[RN], lv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      const bool col_ok = n < D;
      bias[j] = col_ok ? b[n] : 0.f;
      lv[j] = col_ok ? lvo[n] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ln.row(i);
        xv[i][j] = (col_ok && r < rows) ? x[(size_t)r * D + n] : 0.f;
      }
    }
    float m[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = ln.row(i) < rows ? mask[ln.row(i)] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      if (n0 + ln.col_nt(j) >= D) continue;
      const float q = expf(-lv[j]);
      const float base = -0.5f * lv[j] - HALF_LOG_2PI;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (ln.row(i) < rows) {
          const float d = xv[i][j] - (acc[i][j] + bias[j]);
          part += m[i] * (-0.5f * d * d * q + base);
        }
      }
    }
  }
};

// Forward. Dynamic shared memory: the ring, the g tile [TM][ld], THREADS
// floats for the block sum.
__global__ void __launch_bounds__(THREADS, 2)
nll_fwd_kernel(Operands op, float* part, unsigned* tickets, float* __restrict__ ll,
               int split, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* gt = ring + RING_FLOATS;
  float* red = gt + TM * ld;

  const int f = blockIdx.z;
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, op.B - row0);
  const size_t frow = (size_t)f * op.B + row0;

  zero_pad(gt, ld, op.H);
  // lands with the product's first chunk
  stage_g(gt, ld, op.g + frow * op.H, op.H, op.vec_g, rows);

  NllTerms epi{op.x + frow * op.D, op.b + (size_t)f * op.D,
               op.lvo + (size_t)f * op.D, op.mask + frow, op.D, rows, 0.f};
  const int chunks = (op.D + BN - 1) / BN;
  const int mine = (chunks - s + split - 1) / split;
  product_nt(gt, ld, op.w + (size_t)f * op.D * op.H, op.H, op.D, op.vec_w, s,
             split, mine, ring, epi);
  const float total = block_sum(epi.part, red);
  const int per_fold = gridDim.x * split;
  if (threadIdx.x == 0) {
    part[(size_t)f * per_fold + blockIdx.x * split + s] = total;
  }
  if (!arrive_last(tickets + f, per_fold)) return;
  float v = 0.f;
  for (int i = threadIdx.x; i < per_fold; i += THREADS) {
    v += __ldcg(part + (size_t)f * per_fold + i);
  }
  v = block_sum(v, red);
  if (threadIdx.x == 0) ll[f] = v / op.n[f];
}

// Epilogue of the backward's mean: dmean of the tile into shared memory
// (zero at rows past `rows`), and the lane's column sums of dmean and of
// the dlvo terms added to db[j] and dl[j].
struct DmeanTile {
  float* dm;           // [TM][DMS]
  const float* x;      // the tile's first row, column 0
  const float* b;
  const float* lvo;
  const float* mask;
  int D;
  int rows;
  float scale;         // gbar / n
  float db[RN];
  float dl[RN];
  __device__ void operator()(int n0, const float (&acc)[RM][RN]) {
    const Lanes ln;
    float xv[RM][RN];
    float bias[RN], lv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + ln.col_nt(j);
      const bool col_ok = n < D;
      bias[j] = col_ok ? b[n] : 0.f;
      lv[j] = col_ok ? lvo[n] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ln.row(i);
        xv[i][j] = (col_ok && r < rows) ? x[(size_t)r * D + n] : 0.f;
      }
    }
    float m[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = ln.row(i) < rows ? mask[ln.row(i)] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const bool col_ok = n0 + ln.col_nt(j) < D;
      const float q = expf(-lv[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float dmv = 0.f;
        if (col_ok && ln.row(i) < rows) {
          const float d = xv[i][j] - (acc[i][j] + bias[j]);
          dmv = m[i] * q * d * scale;
          db[j] += dmv;
          dl[j] += m[i] * (0.5f * d * d * q - 0.5f);
        }
        dm[ln.row(i) * DMS + ln.col_nt(j)] = dmv;
      }
    }
  }
};

// Backward. Dynamic shared memory: the ring, the g tile [TM][ld], the dmean
// tile [TM][DMS], 2 x 2 x BN floats for the column sums.
//
// part_dg [chunks, F, B, H] (or dg itself with one chunk), part_dw
// [split, F, D, H], part_db and part_dl [split, F, D] (or the outputs with
// one split).
__global__ void __launch_bounds__(THREADS, 2)
nll_bwd_kernel(Operands op, const float* __restrict__ gbar, int gbar_stride,
               float* __restrict__ part_dg, float* __restrict__ part_dw,
               float* __restrict__ part_db, float* __restrict__ part_dl,
               int split, int hblocks, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* gt = ring + RING_FLOATS;
  float* dm = gt + TM * ld;
  float* cs = dm + TM * DMS;

  const Lanes ln;
  const int H = op.H;
  const int D = op.D;
  const int chunk = blockIdx.x;
  const int s = blockIdx.y;
  const int f = blockIdx.z / hblocks;
  const int h0 = (blockIdx.z % hblocks) * BN;
  const int F = gridDim.z / hblocks;
  const int c0 = chunk * BN;
  const int ncols = min(BN, D - c0);
  const float* wf = op.w + (size_t)f * D * H;
  const float scale = gbar[(size_t)f * gbar_stride] / op.n[f];

  zero_pad(gt, ld, H);
  // columns past ncols are never written: they stay zero
  for (int e = threadIdx.x; e < TM * DMS; e += THREADS) dm[e] = 0.f;
  __syncthreads();

  DmeanTile epi{dm, nullptr, op.b + (size_t)f * D, op.lvo + (size_t)f * D,
                nullptr, D, 0, scale, {0.f, 0.f, 0.f, 0.f},
                {0.f, 0.f, 0.f, 0.f}};
  // this thread's 8 x 8 tile of dW: columns c0 + 4 ty + 64 half + u
  // (u < 4), h0 + 4 tx + 64 b + v (v < 4)
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* my_dw = part_dw + ((size_t)s * F + f) * D * H;

  const int tiles = (op.B + TM - 1) / TM;
  bool first_tile = true;
  for (int t = s; t < tiles; t += split) {
    const int row0 = t * TM;
    const int rows = min(TM, op.B - row0);
    const size_t frow = (size_t)f * op.B + row0;
    // the last tile's readers are past the barrier that ended its dW loop;
    // the tile lands with the product's first chunk
    stage_g(gt, ld, op.g + frow * H, H, op.vec_g, rows);

    epi.x = op.x + frow * D;
    epi.mask = op.mask + frow;
    epi.rows = rows;
    // ends with __syncthreads: the dmean tile is complete
    product_nt(gt, ld, wf, H, D, op.vec_w, chunk, 1, 1, ring, epi);

    // dg[rows, h0 .. h0 + BN) of this (tile, chunk): dmean . W[c0 .., h]
    {
      float acc[RM][RN];
      zero(acc);
      const int nsteps = (ncols + BK - 1) / BK;
      auto fetch = [&](int q) {
        if (q < nsteps) {
          stage_nn(ring + (q % SLOTS) * SLOT_FLOATS, wf, H, op.vec_w,
                   c0 + q * BK, c0 + ncols, h0);
        }
        cp_async_commit();
      };
      const float* arow[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) arow[i] = dm + ln.row(i) * DMS;
      fetch(0);
      fetch(1);
      for (int q = 0; q < nsteps; ++q) {
        cp_async_wait<1>();
        __syncthreads();
        fetch(q + 2);
        if (h0 + 32 * ln.wc < H) {
          const float* ap[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) ap[i] = arow[i] + q * BK;
          chunk_nn(acc, ap, ring + (q % SLOTS) * SLOT_FLOATS, BK, ln);
        }
      }
      float* dst = part_dg + ((size_t)chunk * F * op.B + frow) * H;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int h = h0 + ln.col_nn(j);
          if (ln.row(i) < rows && h < H) {
            dst[(size_t)ln.row(i) * H + h] = acc[i][j];
          }
        }
      }
    }

    // dW[c0 .., h0 ..] += dmean^T . g over the tile's rows, both operands
    // in shared memory; the lane's 8 x 8 tile as two halves of 4 columns x
    // 8 h, so that 32 sums and their operands fit the registers of two
    // blocks an SM
    if (h0 + 4 * tx < H) {   // g's tile is zero past H
      const float* gp = gt + h0 + 4 * tx;
      const bool hi = h0 + 64 + 4 * tx < ld;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int col0 = 4 * ty + 64 * half;
        if (col0 >= ncols) break;
        float acc[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
        }
        const float* dp = dm + col0;
#pragma unroll 4
        for (int r = 0; r < TM; ++r) {
          const float4 d0 = *reinterpret_cast<const float4*>(dp + r * DMS);
          const float4 g0 = *reinterpret_cast<const float4*>(gp + r * ld);
          const float4 g1 =
              hi ? *reinterpret_cast<const float4*>(gp + r * ld + 64)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
          const float dv[4] = {d0.x, d0.y, d0.z, d0.w};
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              acc[u][v] = fmaf(dv[u], gv[v], acc[u][v]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (col0 + u >= ncols) continue;
          float* dst = my_dw + (size_t)(c0 + col0 + u) * H;
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int h = h0 + 4 * tx + 64 * (v >> 2) + (v & 3);
            if (h >= H) continue;
            // this thread alone ever touches dst[h]
            dst[h] = first_tile ? acc[u][v] : dst[h] + acc[u][v];
          }
        }
      }
    }
    first_tile = false;
    // the next tile's g and dmean overwrite what the dW loop read
    __syncthreads();
  }

  // db and dlvo of this chunk: the 4 lanes that share a column fold by
  // shuffles, then the two row warps in order
  if (h0 != 0) return;
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    float v = epi.db[j];
    float e = epi.dl[j];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    e += __shfl_xor_sync(0xffffffffu, e, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    e += __shfl_xor_sync(0xffffffffu, e, 16);
    if (ln.lr == 0) {
      cs[(ln.wr * 2 + 0) * BN + ln.col_nt(j)] = v;
      cs[(ln.wr * 2 + 1) * BN + ln.col_nt(j)] = e;
    }
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    const size_t at = ((size_t)s * F + f) * D + c0 + threadIdx.x;
    part_db[at] = cs[threadIdx.x] + cs[2 * BN + threadIdx.x];
    part_dl[at] = (cs[BN + threadIdx.x] + cs[3 * BN + threadIdx.x]) * scale;
  }
}

// out[i] = sum over k < count of part[k * size + i], in order of k, for the
// (at most four) jobs of a backward, all in one launch.
struct SumJobs {
  const float* part[4];
  float* out[4];
  int count[4];
  size_t size[4];
  size_t end[4];   // running ends of the jobs in the flat index space
  int jobs;
};

__global__ void sum_parts_kernel(SumJobs js) {
  const size_t total = js.end[js.jobs - 1];
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    int j = 0;
    while (i >= js.end[j]) ++j;
    const size_t at = i - (j == 0 ? 0 : js.end[j - 1]);
    const float* p = js.part[j] + at;
    float v = 0.f;
    for (int k = 0; k < js.count[j]; ++k) v += p[(size_t)k * js.size[j]];
    js.out[j][at] = v;
  }
}

bool bad_shape(int F, int B, int H, int D) {
  return F <= 0 || B <= 0 || H <= 0 || D <= 0;
}

size_t fwd_smem(int H) {
  return (RING_FLOATS + (size_t)TM * tile_ld(H) + THREADS) * sizeof(float);
}

size_t bwd_smem(int H) {
  return (RING_FLOATS + (size_t)TM * tile_ld(H) + TM * DMS + 4 * BN) *
         sizeof(float);
}

Operands operands(const float* g, const float* w, const float* b,
                  const float* lvo, const float* x, const float* mask,
                  const float* n, int B, int H, int D) {
  return Operands{g, w, b, lvo, x, mask, n, B, H, D, copy_width(g, H),
                  copy_width(w, H)};
}

int fwd_have[MAX_DEVICES];
int bwd_have[MAX_DEVICES];

}  // namespace
}  // namespace mmnm

// The tile constants and shared-memory sizes the Python plans mirror:
// out = {TM, BN, forward bytes, backward bytes} for hidden width H.
extern "C" void mmnm_decoder_nll_sizes(int H, long long* out) {
  using namespace mmnm;
  out[0] = TM;
  out[1] = BN;
  out[2] = (long long)fwd_smem(H);
  out[3] = (long long)bwd_smem(H);
}

// Forward: ll [F]. `scratch` holds F tickets (zero before the first launch;
// every launch leaves them zero) and then F * ceil(B / 32) * split partials;
// split (>= 1) divides a row tile's ceil(D / 128) column chunks over blocks.
extern "C" int mmnm_decoder_nll_fwd(const float* g, const float* w,
                                    const float* b, const float* lvo,
                                    const float* x, const float* mask,
                                    const float* n, float* scratch, float* ll,
                                    int F, int B, int H, int D, int split,
                                    void* stream) {
  using namespace mmnm;
  if (bad_shape(F, B, H, D) || split < 1) return (int)cudaErrorInvalidValue;
  const Operands op = operands(g, w, b, lvo, x, mask, n, B, H, D);
  const size_t smem = fwd_smem(H);
  cudaError_t err = ensure_smem(nll_fwd_kernel, smem, fwd_have);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TM - 1) / TM, split, F);
  nll_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      op, scratch + F, reinterpret_cast<unsigned*>(scratch), ll, split,
      tile_ld(H));
  return (int)cudaGetLastError();
}

// Backward: dg [F, B, H], dw [F, D, H], db [F, D], dlvo [F, D] from the
// cotangent gbar (fold f's at gbar[f * gbar_stride]: autograd hands the
// gradient of a sum over folds as one value with stride 0). `split` (>= 1) divides the row tiles over blocks.
// `scratch` holds, in this order and only where needed: with more than one
// column chunk the dg partials [chunks, F, B, H]; with split > 1 the dW
// partials [split, F, D, H], then db's and dlvo's [split, F, D] each.
extern "C" int mmnm_decoder_nll_bwd(
    const float* g, const float* w, const float* b, const float* lvo,
    const float* x, const float* mask, const float* n, const float* gbar,
    int gbar_stride, float* dg, float* dw, float* db, float* dlvo,
    float* scratch, int F, int B, int H, int D, int split, void* stream) {
  using namespace mmnm;
  // a split without a row tile would leave its partials unwritten
  if (bad_shape(F, B, H, D) || split < 1 || split > (B + TM - 1) / TM ||
      gbar_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Operands op = operands(g, w, b, lvo, x, mask, n, B, H, D);
  auto s = (cudaStream_t)stream;
  const int chunks = (D + BN - 1) / BN;
  const int hblocks = (H + BN - 1) / BN;
  const size_t n_dg = (size_t)F * B * H;
  const size_t n_dw = (size_t)F * D * H;
  const size_t n_db = (size_t)F * D;

  SumJobs js{};
  float* at = scratch;
  auto job = [&](float* out, int count, size_t size) -> float* {
    if (count == 1) return out;
    float* part = at;
    at += (size_t)count * size;
    const int j = js.jobs++;
    js.part[j] = part;
    js.out[j] = out;
    js.count[j] = count;
    js.size[j] = size;
    js.end[j] = (j == 0 ? 0 : js.end[j - 1]) + size;
    return part;
  };
  float* p_dg = job(dg, chunks, n_dg);
  float* p_dw = job(dw, split, n_dw);
  float* p_db = job(db, split, n_db);
  float* p_dl = job(dlvo, split, n_db);

  const size_t smem = bwd_smem(H);
  cudaError_t err = ensure_smem(nll_bwd_kernel, smem, bwd_have);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(chunks, split, F * hblocks);
  nll_bwd_kernel<<<grid, THREADS, smem, s>>>(op, gbar, gbar_stride, p_dg, p_dw,
                                             p_db, p_dl, split, hblocks,
                                             tile_ld(H));
  err = cudaGetLastError();
  if (err != cudaSuccess || js.jobs == 0) return (int)err;
  const size_t total = js.end[js.jobs - 1];
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 2048 ? want : 2048);
  sum_parts_kernel<<<blocks, threads, 0, s>>>(js);
  return (int)cudaGetLastError();
}
