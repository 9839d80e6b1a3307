// Gibbs (nonstationary RBF) Gram on an NVIDIA Hopper card (sm_90a).
//
//   K[i,j] = s1_i s2_j sqrt(2 l1_i l2_j / (l1_i^2 + l2_j^2))
//            * exp(-(x1_i - x2_j)^2 / (l1_i^2 + l2_j^2))  [+ jitter if i == j]
//
// Replaces the TPU kernel `gibbs_gram_pallas` (tile body `_gibbs_tile_kernel`)
// in nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py.
// The TPU kernel only had the self form (x1 == x2, jitter baked in); this one
// takes a row strip (x1, s1, l1) and a column strip (x2, s2, l2) of any
// lengths, so the same body serves the self-covariance (the wrapper passes the
// jitter) and the predictive cross-covariance (jitter 0).
//
// What bounds it on the H100: it reads O(n1 + n2) inputs and writes n1*n2
// outputs, with ~12 operations per output, so it is bound by the bytes it
// writes (n1*n2*sizeof(T) over 3.35 TB/s).  The design does nothing more than
// keep that write the only traffic: one thread per output element, threads
// of a warp on neighbouring columns so every store is coalesced, the input
// strips read through the cache.  The TPU kernel's padding (sigma with 0,
// ell with 1) becomes a bounds mask on the ragged edge.
//
// Built without fast math and with -fmad=false, so each operation rounds as
// the plain PyTorch version's separate elementwise operations do; only the
// last-ulp differences of exp/sqrt remain.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }

template <typename T>
__global__ void gibbs_gram_kernel(const T* __restrict__ x1, const T* __restrict__ s1,
                                  const T* __restrict__ l1, int n1,
                                  const T* __restrict__ x2, const T* __restrict__ s2,
                                  const T* __restrict__ l2, int n2, T jitter,
                                  T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n1 || j >= n2) return;
  const T li = l1[i];
  const T lj = l2[j];
  const T a = li * li + lj * lj;
  const T b = li * lj;
  const T dx = x1[i] - x2[j];
  const T d = dx * dx;
  T k = (s1[i] * s2[j]) * gsqrt(T(2) * b / a) * gexp(-d / a);
  if (jitter != T(0) && i == j) k = k + jitter;
  out[static_cast<size_t>(i) * n2 + j] = k;
}

template <typename T>
int launch(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
           const void* s2, const void* l2, int n2, double jitter, void* out,
           void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n2 + block.x - 1) / block.x, (n1 + block.y - 1) / block.y);
  gibbs_gram_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(s1), static_cast<const T*>(l1),
      n1, static_cast<const T*>(x2), static_cast<const T*>(s2),
      static_cast<const T*>(l2), n2, static_cast<T>(jitter), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int gibbs_gram_f32(const void* x1, const void* s1, const void* l1, int n1,
                   const void* x2, const void* s2, const void* l2, int n2,
                   double jitter, void* out, void* stream) {
  return launch<float>(x1, s1, l1, n1, x2, s2, l2, n2, jitter, out, stream);
}

int gibbs_gram_f64(const void* x1, const void* s1, const void* l1, int n1,
                   const void* x2, const void* s2, const void* l2, int n2,
                   double jitter, void* out, void* stream) {
  return launch<double>(x1, s1, l1, n1, x2, s2, l2, n2, jitter, out, stream);
}

}  // extern "C"
