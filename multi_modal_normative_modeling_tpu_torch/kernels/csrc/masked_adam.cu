// MaskedAdam's update (train/trainer.py::MaskedAdam.step_flat) over the
// flat parameter buffer of every fold, in one launch.
//
// Replaces no TPU kernel: the JAX package's Adam is optax.adam, which XLA
// fuses on its own. Here the eager chain was some thirty whole-buffer
// launches a step (four torch.take spreads through an int64 fold index of
// one entry per element, the moment arithmetic, three where + copy_ pairs).
//
// What bounds it on an H100: bytes. Per element it reads g, p, m and v once
// and writes p, m and v once, 28 B in fp32 (roofline.masked_adam), against a
// few dozen fp32 operations. What the design does about it:
//   * the buffer is cut into chunks of at most `chunk` elements that never
//     cross a (parameter, fold) run, so a chunk has one fold. A block walks
//     chunks (grid-stride) and finds a chunk's parameter by a binary search
//     over the runs table (offset, per-fold run length, first chunk: one row
//     a parameter, built on the host by kernels/masked_adam.py::plan): no
//     per-element index is read;
//   * a chunk of a fold whose step is not valid is skipped whole: its p, m
//     and v are neither read nor written;
//   * the body of a chunk moves 16 B a thread a load (float4, double2),
//     four vectors a thread in flight, with a scalar head and tail where the
//     run does not start or end on a 16-byte boundary;
//   * the per-fold values (the new count, both bias corrections, the
//     learning rate) are computed by every thread from the [F] tables: two
//     pow a thread a chunk. Block 0 writes the new count to a second buffer,
//     so no block reads a count another block has already advanced.
//
// Bit-equal to the eager chain: the same operations in the same order, each
// rounded once (no contraction into FMA: the _rn intrinsics), IEEE division
// and square root, the Python scalars (1 - b1 and 1 - b2 computed in double)
// cast to the element type as PyTorch casts a scalar operand, and pow of the
// cast b1 and b2 as torch.pow(float, Tensor) computes it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmnm {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // vectors a thread keeps in flight

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using Vec = float4;
  static constexpr int kWidth = 4;
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float pow(float a, float b) { return powf(a, b); }
  __device__ static float get(const Vec& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
  __device__ static void set(Vec& x, int i, float a) {
    if (i == 0) x.x = a; else if (i == 1) x.y = a; else if (i == 2) x.z = a;
    else x.w = a;
  }
};

template <>
struct Arith<double> {
  using Vec = double2;
  static constexpr int kWidth = 2;
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) {
    return __dadd_rn(a, -b);
  }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double pow(double a, double b) { return ::pow(a, b); }
  __device__ static double get(const Vec& x, int i) {
    return i == 0 ? x.x : x.y;
  }
  __device__ static void set(Vec& x, int i, double a) {
    if (i == 0) x.x = a; else x.y = a;
  }
};

// The scalars of one step, already in the element type.
template <typename T>
struct Consts {
  T b1, b2, eps, one_minus_b1, one_minus_b2;
};

// One element: step_flat's expression for a fold whose step is valid.
template <typename T>
__device__ __forceinline__ void update(T& p, T& m, T& v, T g,
                                       const Consts<T>& k, T bc1, T bc2,
                                       T lr) {
  using A = Arith<T>;
  m = A::add(A::mul(k.one_minus_b1, g), A::mul(k.b1, m));
  v = A::add(A::mul(k.one_minus_b2, A::mul(g, g)), A::mul(k.b2, v));
  const T step = A::div(A::div(m, bc1),
                        A::add(A::sqrt(A::div(v, bc2)), k.eps));
  p = A::sub(p, A::mul(lr, step));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_adam_kernel(T* __restrict__ p, T* __restrict__ m, T* __restrict__ v,
                   const T* __restrict__ g, const T* __restrict__ count,
                   const T* __restrict__ valid, const T* __restrict__ lr,
                   T* __restrict__ count_out,
                   const long long* __restrict__ runs, int n_params,
                   long long n_chunks, long long chunk, int folds,
                   int vector, Consts<T> k) {
  using A = Arith<T>;
  using Vec = typename A::Vec;
  constexpr int W = A::kWidth;
  if (blockIdx.x == 0) {
    for (int f = threadIdx.x; f < folds; f += blockDim.x) {
      count_out[f] = A::add(count[f], valid[f]);
    }
  }
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the last parameter whose first chunk is at or before c (a parameter
    // of no elements has no chunk, and the search passes over it)
    int lo = 0, hi = n_params - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (runs[3 * mid + 2] <= c) lo = mid; else hi = mid - 1;
    }
    const long long offset = runs[3 * lo], run = runs[3 * lo + 1];
    const long long pieces = (run + chunk - 1) / chunk;
    const long long local = c - runs[3 * lo + 2];
    const int f = (int)(local / pieces);
    const T ok = valid[f];
    if (!(ok > T(0))) continue;
    const T now = A::add(count[f], ok);
    const T bc1 = A::sub(T(1), A::pow(k.b1, now));
    const T bc2 = A::sub(T(1), A::pow(k.b2, now));
    const T rate = lr[f];
    const long long run_start = offset + (long long)f * run;
    const long long piece = local - (long long)f * pieces;
    const long long start = run_start + piece * chunk;
    const long long end = min(start + chunk, run_start + run);
    long long head = end, body = end;
    if (vector) {
      head = min(end, (start + W - 1) / W * W);
      body = head + (end - head) / W * W;
    }
    for (long long i = start + threadIdx.x; i < head; i += blockDim.x) {
      update(p[i], m[i], v[i], g[i], k, bc1, bc2, rate);
    }
    for (long long i = body + threadIdx.x; i < end; i += blockDim.x) {
      update(p[i], m[i], v[i], g[i], k, bc1, bc2, rate);
    }
    const long long nvec = (body - head) / W;
    Vec* pv = reinterpret_cast<Vec*>(p + head);
    Vec* mv = reinterpret_cast<Vec*>(m + head);
    Vec* vv = reinterpret_cast<Vec*>(v + head);
    const Vec* gv = reinterpret_cast<const Vec*>(g + head);
    for (long long q0 = threadIdx.x; q0 < nvec;
         q0 += (long long)kUnroll * blockDim.x) {
      Vec gr[kUnroll], pr[kUnroll], mr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = q0 + (long long)u * blockDim.x;
        if (q < nvec) {
          gr[u] = gv[q];
          pr[u] = pv[q];
          mr[u] = mv[q];
          vr[u] = vv[q];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = q0 + (long long)u * blockDim.x;
        if (q < nvec) {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            T pe = A::get(pr[u], e), me = A::get(mr[u], e),
              ve = A::get(vr[u], e);
            update(pe, me, ve, A::get(gr[u], e), k, bc1, bc2, rate);
            A::set(pr[u], e, pe);
            A::set(mr[u], e, me);
            A::set(vr[u], e, ve);
          }
          pv[q] = pr[u];
          mv[q] = mr[u];
          vv[q] = vr[u];
        }
      }
    }
  }
}

template <typename T>
int launch(void* p, void* m, void* v, const void* g, const void* count,
           const void* valid, const void* lr, void* count_out,
           const long long* runs, int n_params, long long n_chunks,
           long long chunk, int folds, int grid, int vector, double b1,
           double b2, double eps, double one_minus_b1, double one_minus_b2,
           cudaStream_t stream) {
  const Consts<T> k{(T)b1, (T)b2, (T)eps, (T)one_minus_b1, (T)one_minus_b2};
  masked_adam_kernel<T><<<grid, kThreads, 0, stream>>>(
      (T*)p, (T*)m, (T*)v, (const T*)g, (const T*)count, (const T*)valid,
      (const T*)lr, (T*)count_out, runs, n_params, n_chunks, chunk, folds,
      vector, k);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mmnm

// One MaskedAdam step in place on p, m and v [numel] (element type float
// when elem_bytes is 4, double when 8), from the gradient g, the per-fold
// count, valid and lr [folds]; count + valid goes to count_out [folds].
// runs holds n_params rows of (offset, per-fold run length, first chunk);
// chunks hold at most `chunk` elements. `vector`: p, m, v and g all start
// on a 16-byte boundary.
extern "C" int mmnm_masked_adam(void* p, void* m, void* v, const void* g,
                                const void* count, const void* valid,
                                const void* lr, void* count_out,
                                const long long* runs, int n_params,
                                long long n_chunks, long long chunk,
                                int folds, int grid, int elem_bytes,
                                int vector, double b1, double b2, double eps,
                                double one_minus_b1, double one_minus_b2,
                                void* stream) {
  using namespace mmnm;
  if (n_params <= 0 || n_chunks < 0 || chunk <= 0 || folds <= 0 ||
      grid <= 0 || (elem_bytes != 4 && elem_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto launcher = elem_bytes == 4 ? launch<float> : launch<double>;
  return launcher(p, m, v, g, count, valid, lr, count_out, runs, n_params,
                  n_chunks, chunk, folds, grid, vector, b1, b2, eps,
                  one_minus_b1, one_minus_b2, (cudaStream_t)stream);
}
