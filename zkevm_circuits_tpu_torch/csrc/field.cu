// Field kernels K1 (mont_mul), K2 (NTT twiddle multiply) and K3 (wide REDC).
//
// K1 replaces zkevm_circuits_tpu/ops/pallas_field.py::mont_mul
//    (_mul_kernel -> _mont_mul_block: digit convolution, REDC, carry canon).
// K2 replaces zkevm_circuits_tpu/ops/pallas_field.py::mont_mul_mxu, the
//    Fr twiddle multiply between the two DFT passes of poly/ntt_mxu.py.
// K3 replaces zkevm_circuits_tpu/ops/pallas_field.py::redc34, the wide
//    REDC (T * 2^-272 mod p) after every DFT-pass matmul.
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

}  // extern "C"
