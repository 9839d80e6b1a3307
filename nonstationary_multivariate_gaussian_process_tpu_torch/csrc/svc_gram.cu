// Fused GNMGP ("SVC") Gram on an NVIDIA Hopper card (sm_90a).
//
//   K[(n,a),(p,c)] = (Kx[n,p] + jitter * [n == p]) * sum_b L[n,a,b] * L[p,c,b]
//   Kx[n,p]        = sqrt(2 l_n l_p / (l_n^2 + l_p^2)) * exp(-(x_n - x_p)^2 / (l_n^2 + l_p^2))
//
// with x, l of shape (N,) and the Cholesky process L of shape (N, M, M).  The
// jitter rides the n == p diagonal of Kx for EVERY task pair (a, c), not only
// the diagonal of the NM x NM matrix (reference logpos.py:345-349).  Two
// layouts of the same matrix:
//   layout 0, task-major:  row a*N + n, column c*N + p  (models.gnmgp.gram, y = Y.T.reshape(-1))
//   layout 1, input-major: row n*M + a, column p*M + c  (the TPU kernel's own contract)
//
// Replaces the TPU kernel `svc_gram_fused2d` (tile body `_svc2d_tile_kernel`)
// in nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py.
// Like it, this kernel never builds the (N, M, N, M) task-product
// intermediate in device memory.
//
// What bounds it on the H100: it reads O(N M^2) inputs and writes (N M)^2
// outputs, (N M)^2 * 8 bytes at float64 (32 MB at N=1000, M=2, about 9.6 us
// at 3.35 TB/s), against some 10 + 2 M^3 operations per (n, p) pair.  It is
// bound by the bytes it writes.  The design: one thread per input pair (n, p)
// evaluates the Gibbs term (the exp, sqrt and division) once and writes the
// M^2 task entries it scales, so the transcendental work is N^2 and not
// (N M)^2; threads of a warp take neighbouring p, so for each (a, c) the
// task-major stores of a warp are contiguous.  The ragged edge is masked
// instead of the TPU kernel's padding.
//
// Built without fast math and with -fmad=false: the task sum runs b = 0..M-1
// in the plain version's order, each operation rounded on its own.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }

template <typename T>
__global__ void svc_gram_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                const T* __restrict__ ls, int n, int m, T jitter,
                                int input_major, T* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y * blockDim.y + threadIdx.y;  // the row input n
  if (q >= n || p >= n) return;
  const T li = ell[q];
  const T lj = ell[p];
  const T a2 = li * li + lj * lj;
  const T b2 = li * lj;
  const T dx = x[q] - x[p];
  const T d = dx * dx;
  T kx = gsqrt(T(2) * b2 / a2) * gexp(-d / a2);
  if (q == p) kx = kx + jitter;
  const size_t nm = static_cast<size_t>(n) * m;
  const T* lq = ls + static_cast<size_t>(q) * m * m;
  const T* lp = ls + static_cast<size_t>(p) * m * m;
  for (int a = 0; a < m; ++a) {
    const size_t row = input_major ? static_cast<size_t>(q) * m + a
                                   : static_cast<size_t>(a) * n + q;
    for (int c = 0; c < m; ++c) {
      T bsum = lq[a * m] * lp[c * m];
      for (int b = 1; b < m; ++b) bsum = bsum + lq[a * m + b] * lp[c * m + b];
      const size_t col = input_major ? static_cast<size_t>(p) * m + c
                                     : static_cast<size_t>(c) * n + p;
      out[row * nm + col] = kx * bsum;
    }
  }
}

template <typename T>
int launch(const void* x, const void* ell, const void* ls, int n, int m, double jitter,
           int input_major, void* out, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + block.x - 1) / block.x, (n + block.y - 1) / block.y);
  svc_gram_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls),
      n, m, static_cast<T>(jitter), input_major, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int svc_gram_f32(const void* x, const void* ell, const void* ls, int n, int m,
                 double jitter, int input_major, void* out, void* stream) {
  return launch<float>(x, ell, ls, n, m, jitter, input_major, out, stream);
}

int svc_gram_f64(const void* x, const void* ell, const void* ls, int n, int m,
                 double jitter, int input_major, void* out, void* stream) {
  return launch<double>(x, ell, ls, n, m, jitter, input_major, out, stream);
}

}  // extern "C"
