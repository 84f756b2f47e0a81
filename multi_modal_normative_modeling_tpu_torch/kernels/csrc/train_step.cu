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
// modality's parameters alone are 377 KB, so here the step is seven
// launches, each a grid over (row tile, modality, fold) or over folds:
//
//   1. enc_fwd   (tile, m, f): the encoder chain; stores a_1..a_L, mu, lv
//   2. fuse_fwd  (rows, f):    fusion, z, the per-row KL term
//   3. dec       (tile, m, f): the decoder chain, the mean head in 64-wide
//                column chunks with the NLL terms and dmean, dg = dmean Vm^T
//                accumulated over the chunks, then the decoder backward chain
//                down to dz_m (stores g_1..g_L, dmean, dy_l, dz_m)
//   4. fuse_bwd  (rows, f):    sum_m dz_m, reparam + KL backward, fusion
//                backward to dmu_m, dlv_m, the per-row gpoe dalpha terms
//   5. enc_bwd   (tile, m, f): the encoder backward chain (stores dz_l)
//   6. wgrad     (tile, split, f*M + m): every weight gradient A^T dY and
//                every bias-like column sum, each output tile owned by one
//                block that loops over the rows of its split
//   7. finish    (f):          the losses and dalpha, sums in a fixed order
//
// No atomics: every sum has one owner and a fixed order, so two calls give
// bit-identical results. With split > 1 (K6's batch tiles) the weight
// gradients are per-split partials summed in split order by one more
// launch.
//
// Operands of type T (float, or __nv_bfloat16 for K6's bf16 path): the
// batch x and c, the weight matrices, and the stored activations a_l, g_l
// and z. Every product multiplies fp32 values converted from T (a product
// of two bf16 values is exact in fp32) and accumulates in fp32. Gradient
// intermediates (dmean, dy_l, dz_l, dmu_m, dlv_m) are stored fp32 and
// rounded to T where a product reads them, as the TPU kernel casts them
// before its bf16 dots; biases, lvo, alpha, fusion, KL, reparam, the NLL
// and all gradients stay fp32.
//
// LeakyReLU's derivative comes from the sign of the stored activation
// (lrelu preserves sign). Padded feature columns of a modality narrower
// than d_max are skipped by the NLL (its width masks them), so their dmean
// and dlvo terms are exactly zero; rows whose mask is 0 contribute nothing.
//
// What bounds it on an H100: at flagship widths, latency (seven dependent
// launches of small products, FFMA from shared memory, no tensor cores);
// at PPMI width the mean head and the first encoder layer, whose products
// stream the x block and the [H, 3485] weights per row tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace mmnm_ts {

constexpr int TM = 32;           // rows per block of the row-owned passes
constexpr int BN = 64;           // output columns per product pass
constexpr int BK = 32;           // reduction chunk staged in shared memory
constexpr int GROUPS = 16;       // 16 row groups x 16 column groups
constexpr int THREADS = GROUPS * GROUPS;
constexpr int RM = TM / GROUPS;  // rows per thread
constexpr int RN = BN / GROUPS;  // columns per thread
constexpr int MAX_L = 3;
constexpr int MAX_M = 8;
constexpr int MAX_JOBS = 4 * MAX_L + 8;
constexpr int ROW_THREADS = 128;  // threads (one per row) of the fusion passes
constexpr float HALF_LOG_2PI = 0.9189385332046727f;

enum Combine { POE = 0, GPOE = 1, MOE = 2, MOPOE = 3 };

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

struct Dims {
  int F, M, B, L, Z, C, DM;
  int combine;
  int split_rows;         // rows per weight-gradient split
  int dims[MAX_M];        // each modality's true width (<= DM)
  int H[MAX_L];           // encoder hidden widths
  __device__ __host__ int kin(int l) const { return l == 0 ? DM + C : H[l - 1]; }
  __device__ __host__ int hr(int l) const { return H[L - 1 - l]; }
  __device__ __host__ int kdec(int l) const { return l == 0 ? Z + C : hr(l - 1); }
  __device__ __host__ int widest() const {
    int w = 1;
    for (int l = 0; l < L; ++l) w = H[l] > w ? H[l] : w;
    return w;
  }
};

// Parameters (weights of type T) or their gradients (float), every tensor
// [F, M, ...] contiguous.
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
  const T* c;            // [F, B, C]
  const float* eps;      // [F, B, Z]
  const float* rm;       // [F, B]
  const float* n;        // [F]
};

template <class T>
struct Scratch {
  T* act_enc[MAX_L];     // a_{l+1}   [F, M, B, H_l]
  float* mus;            // [F, M, B, Z]
  float* lvs;
  float* fmu;            // fused     [F, B, Z]
  float* flgv;
  T* z;                  // [F, B, Z]
  float* kl_rows;        // [F, B]
  T* act_dec[MAX_L];     // g_{l+1}   [F, M, B, HR_l]
  float* dmean;          // [F, M, B, DM]
  float* e_lvo;          // dlvo terms [F, M, B, DM]
  float* ll_rows;        // [F, M, B]
  float* dy_dec[MAX_L];  // [F, M, B, HR_l]
  float* dz;             // [F, M, B, Z]
  float* dmus;           // [F, M, B, Z]
  float* dlvs;
  float* ds_rows;        // [F, B, M]
  float* dz_enc[MAX_L];  // [F, M, B, H_l]
  float* part;           // [split, grads] weight-gradient partials
};

struct Stage {
  float a[TM][BK + 1];   // input chunk, rows x k
  float w[BK][BN + 1];   // weight chunk, k x n
};

// ---- operand accessors --------------------------------------------------

// Rows of [x | c]: x of stride ldx (its first P columns), then c; rows past
// `rows` read as zero.
template <class T>
struct Concat {
  const T* x;
  const T* c;
  int P, ldx, ldc, rows;
  __device__ float operator()(int r, int k) const {
    if (r >= rows) return 0.f;
    return k < P ? to_f(x[(size_t)r * ldx + k])
                 : to_f(c[(size_t)r * ldc + (k - P)]);
  }
};

struct SmemRows {
  const float* h;
  int ld;
  __device__ float operator()(int r, int k) const { return h[r * ld + k]; }
};

// Rows of [p | q] (fp32, both of width P) rounded to T.
template <class T>
struct RoundedCat {
  const float* p;
  const float* q;
  int P, rows;
  __device__ float operator()(int r, int k) const {
    if (r >= rows) return 0.f;
    return rnd<T>(k < P ? p[(size_t)r * P + k] : q[(size_t)r * P + (k - P)]);
  }
};

// w(k, n) of a forward product: W [K, ld] row-major (offset by col0).
template <class T>
struct WFwd {
  const T* w;
  int ld;
  __device__ float operator()(int k, int n) const {
    return to_f(w[(size_t)k * ld + n]);
  }
};

// w(k, n) of a backward product dy W^T: W [N, ld] row-major, so
// w(k, n) = W[n, k].
template <class T>
struct WBwd {
  const T* w;
  int ld;
  __device__ float operator()(int k, int n) const {
    return to_f(w[(size_t)n * ld + k]);
  }
};

// [Wmu | Wlv]^T of the heads' backward: k < Z reads Wmu[n, k], else
// Wlv[n, k - Z].
template <class T>
struct HeadsBwd {
  const T* wmu;
  const T* wlv;
  int Z;
  __device__ float operator()(int k, int n) const {
    return k < Z ? to_f(wmu[(size_t)n * Z + k])
                 : to_f(wlv[(size_t)n * Z + (k - Z)]);
  }
};

// out[r, n] = sum_k a(r, k) w(k, n) over the tile's TM rows, n < N, handed
// to epi(i, r, n, value) (i indexes the thread's RM rows). Thread (tr, tc)
// owns rows tr + GROUPS i and columns tc + GROUPS j of each column block.
// Ends with __syncthreads, so the next product may read what epi wrote.
template <class A, class Wt, class Epi>
__device__ void row_product(const A& a, const Wt& w, int N, int K, Stage& st,
                            Epi& epi) {
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
        const int kk = e / BN;
        const int nn = e % BN;
        const int n = n0 + nn;
        const int k = k0 + kk;
        st.w[kk][nn] = (n < N && k < K) ? w(k, n) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[RM];
        float wv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = st.a[tr + GROUPS * i][kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) wv[j] = st.w[kk][tc + GROUPS * j];
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
        if (n < N) epi(i, tr + GROUPS * i, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// ---- epilogues -------------------------------------------------------------

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
  __device__ void operator()(int, int r, int n, float v) {
    const T a = from_f<T>(leaky(v + b[n]));
    h[r * ld + n] = to_f(a);
    if (r < rows) g[(size_t)r * N + n] = a;
  }
};

// A head: v + b into a row-major [rows, N] output.
struct HeadOut {
  const float* b;
  float* out;
  int N;
  int rows;
  __device__ void operator()(int, int r, int n, float v) {
    if (r < rows) out[(size_t)r * N + n] = v + b[n];
  }
};

// A product into a shared tile, no bias.
struct ToSmem {
  float* h;
  int ld;
  __device__ void operator()(int, int r, int n, float v) { h[r * ld + n] = v; }
};

// The z block of d(zc) of the first decoder layer, stored per modality.
struct DzOut {
  float* dz;
  int Z;
  int rows;
  __device__ void operator()(int, int r, int n, float v) {
    if (r < rows) dz[(size_t)r * Z + n] = v;
  }
};

// The mean head of one 64-wide column chunk: the masked Gaussian NLL terms
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
  float* dm;           // shared [TM][BN + 1]
  int DM, c0, width, rows;
  float inv_n;
  float part[RM];
  __device__ void operator()(int i, int r, int n, float v) {
    const int col = c0 + n;
    float dmv = 0.f;
    float ev = 0.f;
    if (r < rows && col < width) {
      const float lv = lvo[col];
      const float q = expf(-lv);
      const float d = to_f(x[(size_t)r * DM + col]) - (v + cm[col]);
      const float m = rm[r];
      part[i] += m * (-0.5f * d * d * q - 0.5f * lv - HALF_LOG_2PI);
      dmv = -(m * q * d) * inv_n;
      ev = m * (0.5f * d * d * q - 0.5f);
    }
    if (r < rows) {
      dmean[(size_t)r * DM + col] = dmv;
      e_lvo[(size_t)r * DM + col] = ev;
    }
    dm[r * (BN + 1) + n] = rnd<T>(dmv);
  }
};

// ---- 1. encoder forward ------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(THREADS)
enc_fwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const int ld = d.widest();
  float* h0 = smem + sizeof(Stage) / sizeof(float);
  float* h1 = h0 + TM * ld;

  const int f = blockIdx.z;
  const int m = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, d.B - row0);
  const size_t fm = (size_t)f * d.M + m;
  const size_t frow = (size_t)f * d.B + row0;
  const size_t fmrow = fm * d.B + row0;

  const Concat<T> in{bt.x + fmrow * d.DM, bt.c + frow * d.C, d.DM, d.DM, d.C,
                     rows};
  const float* cur = nullptr;
  for (int l = 0; l < d.L; ++l) {
    const int K = d.kin(l);
    const int N = d.H[l];
    float* out = (l % 2 == 0) ? h0 : h1;
    ActOut<T> epi{out, ld, net.enc_b[l] + fm * N,
                  s.act_enc[l] + fmrow * N, N, rows};
    const WFwd<T> w{net.enc_w[l] + fm * K * N, N};
    if (l == 0) {
      row_product(in, w, N, K, st, epi);
    } else {
      row_product(SmemRows{cur, ld}, w, N, K, st, epi);
    }
    cur = out;
  }
  const int HL = d.H[d.L - 1];
  HeadOut mu{net.bmu + fm * d.Z, s.mus + fmrow * d.Z, d.Z, rows};
  row_product(SmemRows{cur, ld}, WFwd<T>{net.wmu + fm * HL * d.Z, d.Z}, d.Z,
              HL, st, mu);
  HeadOut lv{net.blv + fm * d.Z, s.lvs + fmrow * d.Z, d.Z, rows};
  row_product(SmemRows{cur, ld}, WFwd<T>{net.wlv + fm * HL * d.Z, d.Z}, d.Z,
              HL, st, lv);
}

// ---- 2. fusion + reparameterization + KL ----------------------------------

// gPoE weights: softmax of alpha[f] (max-shifted, as the TPU kernel).
__device__ void softmax_alpha(const float* alpha, int M, float* s) {
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
__device__ void fuse_one(int combine, int M, const float* mus,
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

template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
fuse_fwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  const int f = blockIdx.y;
  const int b = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (b >= d.B) return;
  const int M = d.M;
  const int Z = d.Z;
  float sw[MAX_M];
  for (int m = 0; m < M; ++m) sw[m] = 1.f;
  if (d.combine == GPOE) softmax_alpha(net.alpha + (size_t)f * M, M, sw);
  const size_t fb = (size_t)f * d.B + b;
  float kl = 0.f;
  for (int k = 0; k < Z; ++k) {
    float mus[MAX_M], lvs[MAX_M];
    for (int m = 0; m < M; ++m) {
      const size_t at = (((size_t)f * M + m) * d.B + b) * Z + k;
      mus[m] = s.mus[at];
      lvs[m] = s.lvs[at];
    }
    float mu, lgv;
    fuse_one(d.combine, M, mus, lvs, sw, mu, lgv);
    const float half = expf(0.5f * lgv);
    s.z[fb * Z + k] = from_f<T>(mu + bt.eps[fb * Z + k] * half);
    s.fmu[fb * Z + k] = mu;
    s.flgv[fb * Z + k] = lgv;
    kl += 1.f + lgv - mu * mu - expf(lgv);
  }
  s.kl_rows[fb] = -0.5f * kl;
}

// ---- 3. decoder forward, NLL and decoder backward ---------------------------

template <class T>
__global__ void __launch_bounds__(THREADS)
dec_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const int ld = d.widest();
  const int HL = d.hr(d.L - 1);   // the mean head's input width
  float* buf[3];
  buf[0] = smem + sizeof(Stage) / sizeof(float);
  buf[1] = buf[0] + TM * ld;
  buf[2] = buf[1] + TM * ld;
  float* dm = buf[2] + TM * ld;   // [TM][BN + 1]
  float* wc = dm + TM * (BN + 1); // [BN][HL] mean-head chunk, transposed

  const int f = blockIdx.z;
  const int m = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, d.B - row0);
  const size_t fm = (size_t)f * d.M + m;
  const size_t frow = (size_t)f * d.B + row0;
  const size_t fmrow = fm * d.B + row0;
  const int tid = threadIdx.x;

  // forward chain on [z | c]
  const Concat<T> in{s.z + frow * d.Z, bt.c + frow * d.C, d.Z, d.Z, d.C,
                     rows};
  const float* cur = nullptr;
  for (int l = 0; l < d.L; ++l) {
    const int K = d.kdec(l);
    const int N = d.hr(l);
    float* out = buf[l % 2];
    ActOut<T> epi{out, ld, net.dec_b[l] + fm * N,
                  s.act_dec[l] + fmrow * N, N, rows};
    const WFwd<T> w{net.dec_w[l] + fm * K * N, N};
    if (l == 0) {
      row_product(in, w, N, K, st, epi);
    } else {
      row_product(SmemRows{cur, ld}, w, N, K, st, epi);
    }
    cur = out;
  }

  // mean head + NLL by column chunks; dg = dmean Vm^T accumulated
  float* dg = buf[2];
  for (int e = tid; e < TM * HL; e += THREADS) dg[(e / HL) * ld + e % HL] = 0.f;
  const T* vm = net.vm + fm * HL * d.DM;
  NllChunk<T> nll{bt.x + fmrow * d.DM, net.cm + fm * d.DM,
                  net.lvo + fm * d.DM, bt.rm + frow, s.dmean + fmrow * d.DM,
                  s.e_lvo + fmrow * d.DM, dm, d.DM, 0, d.dims[m], rows,
                  1.f / bt.n[f], {}};
#pragma unroll
  for (int i = 0; i < RM; ++i) nll.part[i] = 0.f;
  const int width = d.dims[m];   // columns past it are padding: skipped
  for (int c0 = 0; c0 < width; c0 += BN) {
    const int ncols = min(BN, width - c0);
    for (int e = tid; e < ncols * HL; e += THREADS) {
      const int h = e / ncols;
      const int k = e % ncols;
      wc[k * HL + h] = to_f(vm[(size_t)h * d.DM + c0 + k]);
    }
    nll.c0 = c0;
    // ends with __syncthreads: dm (and wc) are complete
    row_product(SmemRows{cur, ld}, WFwd<T>{vm + c0, d.DM}, ncols, HL, st,
                nll);
    for (int e = tid; e < TM * HL; e += THREADS) {
      const int r = e / HL;
      const int h = e % HL;
      float sum = 0.f;
      for (int k = 0; k < ncols; ++k) {
        sum = fmaf(dm[r * (BN + 1) + k], wc[k * HL + h], sum);
      }
      dg[r * ld + h] += sum;
    }
    __syncthreads();
  }
  // padded columns: dmean and the dlvo terms are zero
  for (int e = tid; e < rows * (d.DM - width); e += THREADS) {
    const int r = e / (d.DM - width);
    const int col = width + e % (d.DM - width);
    s.dmean[(fmrow + r) * d.DM + col] = 0.f;
    s.e_lvo[(fmrow + r) * d.DM + col] = 0.f;
  }
  {
    // per-row ll: the 16 column threads of a row are consecutive lanes
    const int tr = tid / GROUPS;
    const int tc = tid % GROUPS;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float v = nll.part[i];
#pragma unroll
      for (int off = GROUPS / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      const int r = tr + GROUPS * i;
      if (tc == 0 && r < rows) s.ll_rows[fmrow + r] = v;
    }
  }

  // decoder backward chain: dy_l = dg * lrelu'(g_{l+1}); dg = dy_l V_l^T
  int g_at = 2, y_at = 0, n_at = 1;
  for (int l = d.L - 1; l >= 0; --l) {
    const int N = d.hr(l);
    const int K = d.kdec(l);
    float* gcur = buf[g_at];
    float* dyt = buf[y_at];
    const T* act = s.act_dec[l] + fmrow * N;
    float* dy = s.dy_dec[l] + fmrow * N;
    for (int e = tid; e < TM * N; e += THREADS) {
      const int r = e / N;
      const int n = e % N;
      float v = 0.f;
      if (r < rows) {
        v = gcur[r * ld + n] * dleaky(to_f(act[(size_t)r * N + n]));
        dy[(size_t)r * N + n] = v;
      }
      dyt[r * ld + n] = rnd<T>(v);
    }
    __syncthreads();
    const WBwd<T> w{net.dec_w[l] + fm * K * N, N};
    if (l > 0) {
      ToSmem epi{buf[n_at], ld};
      row_product(SmemRows{dyt, ld}, w, K, N, st, epi);
      const int t = g_at;
      g_at = n_at;
      n_at = t;
    } else {
      DzOut epi{s.dz + fmrow * d.Z, d.Z, rows};
      row_product(SmemRows{dyt, ld}, w, d.Z, N, st, epi);
    }
  }
}

// ---- 4. fusion backward -------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
fuse_bwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  const int f = blockIdx.y;
  const int b = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (b >= d.B) return;
  const int M = d.M;
  const int Z = d.Z;
  const float Mf = (float)M;
  float sw[MAX_M];
  for (int m = 0; m < M; ++m) sw[m] = 1.f;
  const bool gpoe = d.combine == GPOE && M > 1;
  if (d.combine == GPOE) softmax_alpha(net.alpha + (size_t)f * M, M, sw);
  float ds[MAX_M];
  for (int m = 0; m < M; ++m) ds[m] = 0.f;
  const size_t fb = (size_t)f * d.B + b;
  const float rmv = bt.rm[fb];
  const float inv_n = 1.f / bt.n[f];
  for (int k = 0; k < Z; ++k) {
    float mus[MAX_M], lvs[MAX_M];
    float dz = 0.f;
    for (int m = 0; m < M; ++m) {
      const size_t at = (((size_t)f * M + m) * d.B + b) * Z + k;
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
    float dmus[MAX_M], dlvs[MAX_M];
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
    for (int m = 0; m < M; ++m) {
      const size_t at = (((size_t)f * M + m) * d.B + b) * Z + k;
      s.dmus[at] = dmus[m];
      s.dlvs[at] = dlvs[m];
    }
  }
  for (int m = 0; m < M; ++m) s.ds_rows[fb * M + m] = ds[m];
}

// ---- 5. encoder backward chain ------------------------------------------------

template <class T>
__global__ void __launch_bounds__(THREADS)
enc_bwd_kernel(Dims d, Net<const T> net, Batch<T> bt, Scratch<T> s) {
  extern __shared__ float smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const int ld = d.widest();
  float* da = smem + sizeof(Stage) / sizeof(float);
  float* dzt = da + TM * ld;

  const int f = blockIdx.z;
  const int m = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, d.B - row0);
  const size_t fm = (size_t)f * d.M + m;
  const size_t fmrow = fm * d.B + row0;
  const int tid = threadIdx.x;

  // da = [dmu | dlv] [Wmu | Wlv]^T
  const int HL = d.H[d.L - 1];
  {
    ToSmem epi{da, ld};
    row_product(RoundedCat<T>{s.dmus + fmrow * d.Z, s.dlvs + fmrow * d.Z,
                              d.Z, rows},
                HeadsBwd<T>{net.wmu + fm * HL * d.Z, net.wlv + fm * HL * d.Z,
                            d.Z},
                HL, 2 * d.Z, st, epi);
  }
  for (int l = d.L - 1; l >= 0; --l) {
    const int N = d.H[l];
    const int K = d.kin(l);
    const T* act = s.act_enc[l] + fmrow * N;
    float* dz = s.dz_enc[l] + fmrow * N;
    for (int e = tid; e < TM * N; e += THREADS) {
      const int r = e / N;
      const int n = e % N;
      float v = 0.f;
      if (r < rows) {
        v = da[r * ld + n] * dleaky(to_f(act[(size_t)r * N + n]));
        dz[(size_t)r * N + n] = v;
      }
      dzt[r * ld + n] = rnd<T>(v);
    }
    __syncthreads();
    if (l > 0) {
      ToSmem epi{da, ld};
      row_product(SmemRows{dzt, ld},
                  WBwd<T>{net.enc_w[l] + fm * K * N, N}, K, N, st, epi);
    }
  }
}

// ---- 6. weight gradients ------------------------------------------------------

// One output of the weight-gradient pass, per (fold, modality):
// out[K, N] = scale * sum_rows A[row, k] dY[row, n] (a product), or
// out[N] = scale * sum_rows dY[row, n] (a column sum; A unused). A is the
// rows of [a | a2] (a2 from column `split` on; a2 per fold only); strides
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
constexpr int WR = 32;   // rows per staged chunk

template <class T>
__device__ float job_a(const Job& jb, size_t f, size_t m, int row, int k) {
  if (k < jb.a_cols) {
    const T* a = static_cast<const T*>(jb.a) + f * jb.a_f + m * jb.a_m;
    return to_f(a[(size_t)row * jb.a_ld + k]);
  }
  const T* a2 = static_cast<const T*>(jb.a2) + f * jb.a2_f;
  return to_f(a2[(size_t)row * jb.a2_ld + (k - jb.a_cols)]);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(Dims d, Jobs jobs, const float* n, float* part_base,
             float* grad_base, long long grad_count) {
  __shared__ float as[WR][WK + 1];
  __shared__ float ys[WR][BN + 1];
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
    const int n0 = t * THREADS;
    const int col = n0 + tid;
    if (col < jb.N) {
      float sum = 0.f;
      for (int r = r_lo; r < r_hi; ++r) sum += dy[(size_t)r * jb.dy_ld + col];
      out[col] = sum * scale;
    }
    return;
  }

  const int n_tiles = (jb.N + BN - 1) / BN;
  const int k0 = (t / n_tiles) * WK;
  const int n0 = (t % n_tiles) * BN;
  const int tr = tid / GROUPS;
  const int tc = tid % GROUPS;
  constexpr int RK = WK / GROUPS;
  float acc[RK][RN];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
  for (int r0 = r_lo; r0 < r_hi; r0 += WR) {
    for (int e = tid; e < WR * WK; e += THREADS) {
      const int rr = e / WK;
      const int kk = e % WK;
      const int r = r0 + rr;
      const int k = k0 + kk;
      as[rr][kk] = (r < r_hi && k < jb.K) ? job_a<T>(jb, f, m, r, k) : 0.f;
    }
    for (int e = tid; e < WR * BN; e += THREADS) {
      const int rr = e / BN;
      const int nn = e % BN;
      const int r = r0 + rr;
      const int col = n0 + nn;
      float v = 0.f;
      if (r < r_hi && col < jb.N) {
        v = dy[(size_t)r * jb.dy_ld + col];
        if (jb.round_dy) v = rnd<T>(v);
      }
      ys[rr][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < WR; ++rr) {
      float av[RK];
      float yv[RN];
#pragma unroll
      for (int i = 0; i < RK; ++i) av[i] = as[rr][tr + GROUPS * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) yv[j] = ys[rr][tc + GROUPS * j];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], yv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int k = k0 + tr + GROUPS * i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tc + GROUPS * j;
      if (k < jb.K && col < jb.N) out[(size_t)k * jb.N + col] = acc[i][j] * scale;
    }
  }
}

// out[i] = sum over k < split of part[k * count + i], in order of k.
__global__ void sum_splits_kernel(const float* __restrict__ part,
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

template <class T>
__global__ void finish_kernel(Dims d, Net<const T> net, Batch<T> bt,
                              Scratch<T> s, float* dalpha, float* losses) {
  const int f = blockIdx.x;
  if (threadIdx.x != 0) return;
  const int M = d.M;
  const float n = bt.n[f];
  float kl = 0.f;
  for (int b = 0; b < d.B; ++b) {
    kl += bt.rm[(size_t)f * d.B + b] * s.kl_rows[(size_t)f * d.B + b];
  }
  kl = kl / n;
  float ll = 0.f;
  for (int m = 0; m < M; ++m) {
    float llm = 0.f;
    for (int b = 0; b < d.B; ++b) {
      llm += s.ll_rows[((size_t)f * M + m) * d.B + b];
    }
    ll += llm / n;
  }
  losses[f * 3 + 0] = M * kl - ll;
  losses[f * 3 + 1] = M * kl;
  losses[f * 3 + 2] = ll;
  float* da = dalpha + (size_t)f * M;
  if (d.combine == GPOE && M > 1) {
    float sw[MAX_M], ds[MAX_M];
    softmax_alpha(net.alpha + (size_t)f * M, M, sw);
    float total = 0.f;
    for (int m = 0; m < M; ++m) {
      ds[m] = 0.f;
      for (int b = 0; b < d.B; ++b) {
        ds[m] += s.ds_rows[((size_t)f * d.B + b) * M + m];
      }
      total += sw[m] * ds[m];
    }
    for (int m = 0; m < M; ++m) da[m] = sw[m] * (ds[m] - total);
  } else {
    for (int m = 0; m < M; ++m) da[m] = 0.f;
  }
}

// ---- host side ----------------------------------------------------------------

size_t stage_floats() { return sizeof(Stage) / sizeof(float); }

size_t dec_smem(const Dims& d) {
  return (stage_floats() + 3 * (size_t)TM * d.widest() + TM * (BN + 1) +
          (size_t)BN * d.hr(d.L - 1)) * sizeof(float);
}
size_t enc_fwd_smem(const Dims& d) {
  return (stage_floats() + 2 * (size_t)TM * d.widest()) * sizeof(float);
}
size_t enc_bwd_smem(const Dims& d) { return enc_fwd_smem(d); }

// The parsed int table (see mmnm_train_step); false if out of range.
bool parse_dims(const int* ints, Dims& d) {
  d.F = ints[0];
  d.M = ints[1];
  d.B = ints[2];
  d.L = ints[3];
  d.Z = ints[4];
  d.C = ints[5];
  d.DM = ints[6];
  d.combine = ints[7];
  d.split_rows = ints[8];
  if (d.F <= 0 || d.M <= 0 || d.M > MAX_M || d.B <= 0 || d.L <= 0 ||
      d.L > MAX_L || d.Z <= 0 || d.C < 0 || d.DM <= 0 || d.combine < 0 ||
      d.combine > 3 || d.split_rows <= 0) {
    return false;
  }
  for (int m = 0; m < d.M; ++m) {
    d.dims[m] = ints[9 + m];
    if (d.dims[m] <= 0 || d.dims[m] > d.DM) return false;
  }
  for (int l = 0; l < d.L; ++l) {
    d.H[l] = ints[9 + d.M + l];
    if (d.H[l] <= 0) return false;
  }
  return true;
}

// Floats of every gradient but alpha (which comes last), summed.
long long grad_floats(const Dims& d) {
  long long per = 0;
  for (int l = 0; l < d.L; ++l) per += (long long)d.kin(l) * d.H[l] + d.H[l];
  const int hl = d.H[d.L - 1];
  per += 2LL * (hl * d.Z + d.Z);
  for (int l = 0; l < d.L; ++l) per += (long long)d.kdec(l) * d.hr(l) + d.hr(l);
  per += (long long)d.hr(d.L - 1) * d.DM + 2LL * d.DM;
  return per * d.F * d.M;
}

int n_splits(const Dims& d) { return (d.B + d.split_rows - 1) / d.split_rows; }

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
  for (int l = 0; l < d.L; ++l) {
    s.act_enc[l] = reinterpret_cast<T*>(take(fmb * d.H[l] * sizeof(T)));
  }
  s.mus = reinterpret_cast<float*>(take(fmb * d.Z * 4));
  s.lvs = reinterpret_cast<float*>(take(fmb * d.Z * 4));
  s.fmu = reinterpret_cast<float*>(take(fb * d.Z * 4));
  s.flgv = reinterpret_cast<float*>(take(fb * d.Z * 4));
  s.z = reinterpret_cast<T*>(take(fb * d.Z * sizeof(T)));
  s.kl_rows = reinterpret_cast<float*>(take(fb * 4));
  for (int l = 0; l < d.L; ++l) {
    s.act_dec[l] = reinterpret_cast<T*>(take(fmb * d.hr(l) * sizeof(T)));
  }
  s.dmean = reinterpret_cast<float*>(take(fmb * d.DM * 4));
  s.e_lvo = reinterpret_cast<float*>(take(fmb * d.DM * 4));
  s.ll_rows = reinterpret_cast<float*>(take(fmb * 4));
  for (int l = 0; l < d.L; ++l) {
    s.dy_dec[l] = reinterpret_cast<float*>(take(fmb * d.hr(l) * 4));
  }
  s.dz = reinterpret_cast<float*>(take(fmb * d.Z * 4));
  s.dmus = reinterpret_cast<float*>(take(fmb * d.Z * 4));
  s.dlvs = reinterpret_cast<float*>(take(fmb * d.Z * 4));
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
    j.a2 = a2;
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
      product(bt.x, MB * d.DM, B * d.DM, d.DM, d.DM, bt.c, B * d.C, d.C,
              s.dz_enc[0], d.DM + d.C, N, g.enc_w[0]);
    } else {
      act(s.act_enc[l - 1], d.H[l - 1], s.dz_enc[l], N, g.enc_w[l]);
    }
    colsum(s.dz_enc[l], N, g.enc_b[l], 0);
  }
  const int hl = d.H[d.L - 1];
  act(s.act_enc[d.L - 1], hl, s.dmus, d.Z, g.wmu);
  colsum(s.dmus, d.Z, g.bmu, 0);
  act(s.act_enc[d.L - 1], hl, s.dlvs, d.Z, g.wlv);
  colsum(s.dlvs, d.Z, g.blv, 0);
  for (int l = 0; l < d.L; ++l) {
    const int N = d.hr(l);
    if (l == 0) {
      // [z | c]: both per fold only
      product(s.z, B * d.Z, 0, d.Z, d.Z, bt.c, B * d.C, d.C, s.dy_dec[0],
              d.Z + d.C, N, g.dec_w[0]);
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

int net_count(const Dims& d) { return 4 * d.L + 8; }

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

  const dim3 tiles((d.B + TM - 1) / TM, d.M, d.F);
  const dim3 rows((d.B + ROW_THREADS - 1) / ROW_THREADS, d.F);
  cudaError_t err;

  size_t smem = enc_fwd_smem(d);
  err = cudaFuncSetAttribute(enc_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_fwd_kernel<T><<<tiles, THREADS, smem, stream>>>(d, net, bt, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fuse_fwd_kernel<T><<<rows, ROW_THREADS, 0, stream>>>(d, net, bt, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = dec_smem(d);
  err = cudaFuncSetAttribute(dec_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dec_kernel<T><<<tiles, THREADS, smem, stream>>>(d, net, bt, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fuse_bwd_kernel<T><<<rows, ROW_THREADS, 0, stream>>>(d, net, bt, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = enc_bwd_smem(d);
  err = cudaFuncSetAttribute(enc_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_bwd_kernel<T><<<tiles, THREADS, smem, stream>>>(d, net, bt, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const Jobs jobs = make_jobs<T>(d, bt, s, g);
  const int splits = n_splits(d);
  const long long count = grad_floats(d);
  const dim3 wgrid(jobs.total_tiles, splits, d.F * d.M);
  wgrad_kernel<T><<<wgrid, THREADS, 0, stream>>>(d, jobs, bt.n, s.part,
                                                  g.enc_w[0], count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long want = (count + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    sum_splits_kernel<<<blocks, 256, 0, stream>>>(s.part, g.enc_w[0], splits,
                                                  count);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  finish_kernel<T><<<d.F, 32, 0, stream>>>(d, net, bt, s, g.alpha, losses);
  return (int)cudaGetLastError();
}

}  // namespace mmnm_ts

// The int table: F, M, B, L, Z, C, d_max, combine (0 poe, 1 gpoe, 2 moe,
// 3 mopoe), rows per weight-gradient split, then the M modality widths and
// the L encoder hidden widths.
//
// The pointer table: x, c, eps, rowmask, n; the 4 L + 8 parameters in the
// order enc_w0, enc_b0, ..., wmu, bmu, wlv, blv, dec_w0, dec_b0, ..., vm,
// cm, lvo, alpha (weights [F, M, in, out] of the operand type, the rest
// fp32); their gradients in the same order, fp32 and laid out back to back
// in that order from enc_w0's; losses [F, 3] (total, M kl, ll); the
// workspace of mmnm_train_step_workspace bytes.

// Workspace bytes for these shapes, or -1 if the table is out of range.
extern "C" long long mmnm_train_step_workspace(const int* ints, int bf16) {
  using namespace mmnm_ts;
  Dims d;
  if (!parse_dims(ints, d)) return -1;
  if (bf16) {
    Scratch<__nv_bfloat16> s;
    return (long long)carve<__nv_bfloat16>(d, nullptr, s);
  }
  Scratch<float> s;
  return (long long)carve<float>(d, nullptr, s);
}

// One train step on `stream`; returns the first launch error, or 0.
extern "C" int mmnm_train_step(void* const* ptrs, const int* ints, int bf16,
                               void* stream) {
  using namespace mmnm_ts;
  Dims d;
  if (!parse_dims(ints, d)) return (int)cudaErrorInvalidValue;
  if (dec_smem(d) > 232448) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return bf16 ? run<__nv_bfloat16>(ptrs, d, s) : run<float>(ptrs, d, s);
}
