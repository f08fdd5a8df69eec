// Field kernels K1 (mont_mul), K2 (NTT twiddle multiply), K3 (wide REDC)
// and K4 (radix-2 butterfly stage).
//
// K1 replaces zkevm_circuits_tpu/ops/pallas_field.py::mont_mul
//    (_mul_kernel -> _mont_mul_block: digit convolution, REDC, carry canon).
// K2 replaces zkevm_circuits_tpu/ops/pallas_field.py::mont_mul_mxu, the
//    Fr twiddle multiply between the two DFT passes of poly/ntt_mxu.py.
// K3 replaces zkevm_circuits_tpu/ops/pallas_field.py::redc34, the wide
//    REDC (T * 2^-272 mod p) after every DFT-pass matmul.
// K4 replaces zkevm_circuits_tpu/ops/pallas_field.py::butterfly_stage
//    (_butterfly_kernel), one radix-2 DIT stage over Fr:
//    (lo + hi * tw, lo - hi * tw).
//
// What bounds them on the H100: each thread owns one element and keeps the
// whole Montgomery product in registers (36 64x64-bit products, about 140
// 32-bit multiply-adds), so per element they move 96 bytes (K1, K2) or 284
// bytes (K3) through device memory against a few hundred integer
// instructions: memory bound at the sizes the prover uses.  The design
// therefore reads each operand once, keeps no intermediate in memory (the
// TPU kernels' digit planes and Toeplitz matrices do not exist here), reads
// the u8 rows in place as u64 limbs, and lets K2 index the (n1, n2) twiddle
// table instead of reading a broadcast copy of it.
//
// K4 is bound by bytes too: per butterfly it reads lo and hi and writes two
// rows (128 bytes in the stage form, 160 in the row form, which also reads
// a twiddle row) against one Montgomery product and an add and a subtract.
// One thread owns one butterfly: it reads the two 32-byte rows in place as
// four u64 limbs, reuses K1's device product and bn254.cuh's fe_add and
// fe_sub, and keeps the product in registers.  In the stage form (the NTT
// ladder) the thread computes its rows and its twiddle's index from its
// butterfly index, as K2 does, so the stage reads the (half, 32) table of
// the stage and never a pre-broadcast (rows, 32) copy, and no concatenate
// follows: both outputs are written where the next stage reads them.
#include <cstdint>
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

// K1: out[i] = a[i or 0] * b[i or 0] (Montgomery), field f
__global__ void mont_mul_kernel(const uint64_t *__restrict__ a,
                                const uint64_t *__restrict__ b,
                                uint64_t *__restrict__ out, int64_t n, int f,
                                int a_bcast, int b_bcast) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a, a_bcast ? 0 : i);
  Fe y = fe_load(b, b_bcast ? 0 : i);
  fe_store(out, i, fe_mul(x, y, f));
}

// K2: y viewed as (n1, nb, n2) rows; out[i1, b, j2] = y[i1, b, j2] * tw[i1, j2]
__global__ void twiddle_mul_kernel(const uint64_t *__restrict__ y,
                                   const uint64_t *__restrict__ tw,
                                   uint64_t *__restrict__ out, int64_t rows,
                                   int64_t nb, int64_t n2) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int64_t j2 = r % n2;
  int64_t i1 = r / (nb * n2);
  Fe x = fe_load(y, r);
  Fe w = fe_load(tw, i1 * n2 + j2);
  fe_store(out, r, fe_mul(x, w, FIELD_FR));
}

// K3: t (rows, 63) int32 exact digit sums, T = sum t[d] 2^(8d) < 2^272 p.
// out = T * 2^-272 mod p (Fr), canonical.
__global__ void redc34_kernel(const int32_t *__restrict__ t,
                              uint64_t *__restrict__ out, int64_t rows) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int32_t *row = t + 63 * r;
  // carry-propagate the digit sums into nine u64 limbs (T < 2^527)
  uint64_t T[9];
#pragma unroll
  for (int j = 0; j < 9; j++) T[j] = 0;
  uint64_t carry = 0;
#pragma unroll
  for (int d = 0; d < 72; d++) {
    uint64_t v = carry + (d < 63 ? static_cast<uint64_t>(
                                       static_cast<uint32_t>(row[d]))
                                 : 0ULL);
    T[d >> 3] |= (v & 0xFFULL) << (8 * (d & 7));
    carry = v >> 8;
  }
  const uint64_t *p = P_LIMBS[FIELD_FR];
  const uint64_t np0 = NP0[FIELD_FR];
  // four 64-bit REDC steps ...
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint64_t m = T[i] * np0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) T[i + j] = mac(m, p[j], T[i + j], c);
#pragma unroll
    for (int k = i + 4; k < 9; k++) {
      T[k] += c;
      c = (T[k] < c);
    }
  }
  // ... and one 16-bit step: 2^272 = 2^(4*64 + 16)
  {
    const uint64_t m = (T[4] * np0) & 0xFFFFULL;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) T[4 + j] = mac(m, p[j], T[4 + j], c);
    T[8] += c;
  }
  Fe res;
#pragma unroll
  for (int j = 0; j < 4; j++) res.v[j] = (T[4 + j] >> 16) | (T[5 + j] << 48);
  fe_store(out, r, cond_sub_p(res, FIELD_FR));  // res < 2p
}

// K4, row form: row r of lo pairs with row r of hi and of tw
__global__ void butterfly_rows_kernel(const uint64_t *__restrict__ lo,
                                      const uint64_t *__restrict__ hi,
                                      const uint64_t *__restrict__ tw,
                                      uint64_t *__restrict__ out_lo,
                                      uint64_t *__restrict__ out_hi,
                                      int64_t rows) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Fe a = fe_load(lo, r);
  Fe t = fe_mul(fe_load(hi, r), fe_load(tw, r), FIELD_FR);
  fe_store(out_lo, r, fe_add(a, t, FIELD_FR));
  fe_store(out_hi, r, fe_sub(a, t, FIELD_FR));
}

// K4, stage form: x viewed as (batch, n = 2^log_n) rows, stage s in
// [1, log_n] of the DIT ladder (blocks of m = 2^s rows, half = m / 2).
// Butterfly i of the pairs = batch * n / 2: column b = i / (n / 2), j = its
// index in the column, block j / half, t = j mod half; rows lo = b n +
// block m + t and hi = lo + half; twiddle row t.
__global__ void dit_stage_kernel(const uint64_t *__restrict__ x,
                                 const uint64_t *__restrict__ tw,
                                 uint64_t *__restrict__ out, int64_t pairs,
                                 int log_n, int s) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t half = int64_t{1} << (s - 1);
  const int64_t j = i & ((int64_t{1} << (log_n - 1)) - 1);
  const int64_t b = i >> (log_n - 1);
  const int64_t t = j & (half - 1);
  const int64_t lo = (b << log_n) + ((j >> (s - 1)) << s) + t;
  const int64_t hi = lo + half;
  Fe a = fe_load(x, lo);
  Fe p = fe_mul(fe_load(x, hi), fe_load(tw, t), FIELD_FR);
  fe_store(out, lo, fe_add(a, p, FIELD_FR));
  fe_store(out, hi, fe_sub(a, p, FIELD_FR));
}

}  // namespace

extern "C" {

int zk_mont_mul(const void *a, const void *b, void *out, int64_t n, int field,
                int a_bcast, int b_bcast, void *stream) {
  if (n > 0)
    mont_mul_kernel<<<blocks_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t *>(a), static_cast<const uint64_t *>(b),
        static_cast<uint64_t *>(out), n, field, a_bcast, b_bcast);
  return static_cast<int>(cudaGetLastError());
}

int zk_twiddle_mul(const void *y, const void *tw, void *out, int64_t rows,
                   int64_t nb, int64_t n2, void *stream) {
  if (rows > 0)
    twiddle_mul_kernel<<<blocks_for(rows), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t *>(y), static_cast<const uint64_t *>(tw),
        static_cast<uint64_t *>(out), rows, nb, n2);
  return static_cast<int>(cudaGetLastError());
}

int zk_redc34(const void *t, void *out, int64_t rows, void *stream) {
  if (rows > 0)
    redc34_kernel<<<blocks_for(rows), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t *>(t), static_cast<uint64_t *>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

int zk_butterfly_rows(const void *lo, const void *hi, const void *tw,
                      void *out_lo, void *out_hi, int64_t rows, void *stream) {
  if (rows > 0)
    butterfly_rows_kernel<<<blocks_for(rows), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t *>(lo), static_cast<const uint64_t *>(hi),
        static_cast<const uint64_t *>(tw), static_cast<uint64_t *>(out_lo),
        static_cast<uint64_t *>(out_hi), rows);
  return static_cast<int>(cudaGetLastError());
}

int zk_dit_stage(const void *x, const void *tw, void *out, int64_t pairs,
                 int log_n, int s, void *stream) {
  if (pairs > 0)
    dit_stage_kernel<<<blocks_for(pairs), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t *>(x), static_cast<const uint64_t *>(tw),
        static_cast<uint64_t *>(out), pairs, log_n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
