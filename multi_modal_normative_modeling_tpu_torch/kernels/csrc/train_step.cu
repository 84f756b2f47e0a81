// The fused cVAE train step (K5, and K6 with fp32 operands): the fp32
// instantiation of train_step.cuh and the C entry points of both operand
// types. The bf16 instantiation is train_step_bf16.cu.
#include "train_step.cuh"

namespace mmnm_ts {
int run_bf16(void* const* ptrs, const Dims& d, cudaStream_t stream);
}

// The int table: F, M, B, L, Z (true latent width), Zp, Cp, d_max (the
// padded latent, covariate and feature widths), combine (0 poe, 1 gpoe,
// 2 moe, 3 mopoe), rows per weight-gradient split, the route (0: chosen
// from the shapes, 1: fused, n > 1: wide, aiming at n blocks a launch),
// pass 3's activation tiles (0: chosen from the shapes, 3, or 2: the
// wide-hidden route), then the M modalities' true widths and the L padded
// encoder hidden widths. Padded widths are multiples of 4, of 16 with bf16
// operands.
//
// The pointer table: x, c, eps, rowmask, n; the 4 L + 8 parameters in the
// order enc_w0, enc_b0, ..., wmu, bmu, wlv, blv, dec_w0, dec_b0, ..., vm,
// cm, lvo, alpha (weights [F, M, in, out] of the operand type, the rest
// fp32, all at the padded widths); their gradients in the same order, fp32
// and laid out back to back in that order from enc_w0's; losses [F, 3]
// (total, M kl, ll); the workspace of mmnm_train_step_workspace bytes.

// Workspace bytes for these shapes, or -1 if the table is out of range.
extern "C" long long mmnm_train_step_workspace(const int* ints, int bf16) {
  using namespace mmnm_ts;
  Dims d;
  if (!parse_dims(ints, bf16 ? 16 : 4, d)) return -1;
  if (bf16) {
    Scratch<__nv_bfloat16> s;
    return (long long)carve<__nv_bfloat16>(d, nullptr, s);
  }
  Scratch<float> s;
  return (long long)carve<float>(d, nullptr, s);
}

// The route `mmnm_train_step` takes for these shapes: out[0] 1 if wide,
// out[1] the first encoder layer's K splits, out[2] the mean head's column
// groups, out[3] the step's launches, out[4] pass 3's activation tiles,
// out[5] its shared memory in bytes. Returns 0, or -1 if out of range.
extern "C" int mmnm_train_step_plan(const int* ints, int* out) {
  using namespace mmnm_ts;
  Dims d;
  if (!parse_dims(ints, 4, d)) return -1;
  out[0] = d.wide;
  out[1] = d.wide ? d.enc0_splits : 1;
  out[2] = d.col_groups;
  out[3] = (d.wide ? 10 : 7) + (n_splits(d) > 1 ? 1 : 0);
  out[4] = d.dec_tiles;
  out[5] = (int)dec_smem(d, d.dec_tiles);
  return 0;
}

// One train step on `stream`; returns the first launch error, or 0.
extern "C" int mmnm_train_step(void* const* ptrs, const int* ints, int bf16,
                               void* stream) {
  using namespace mmnm_ts;
  Dims d;
  if (!parse_dims(ints, bf16 ? 16 : 4, d)) return (int)cudaErrorInvalidValue;
  if (dec_smem(d, d.dec_tiles) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return bf16 ? run_bf16(ptrs, d, s) : run<float>(ptrs, d, s);
}
