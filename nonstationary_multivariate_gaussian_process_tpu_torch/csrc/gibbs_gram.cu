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
//
// Backward of the self form (a second entry point; the TPU had none, XLA
// differentiated the jnp Gram).  With g_ij the Gibbs term (s = 1) and Kbar
// not assumed symmetric:
//
//   sbar_i = sum_j (Kbar_ij + Kbar_ji) s_j g_ij
//   lbar_i = sum_j (Kbar_ij + Kbar_ji) s_i s_j g_ij (1/(2 l_i) - l_i/A + 2 l_i D/A^2)
//
// with A = l_i^2 + l_j^2, D = (x_i - x_j)^2; the factor is 0 at j == i and
// the jitter carries no gradient.  It reads Kbar once along rows and once as
// transposed tiles through shared memory, so it is bound by the bytes read,
// at least n*n*sizeof(T) (8 MB at N=1000 float64, about 2.4 us at
// 3.35 TB/s).  Each block owns 16 rows and a strided share of the column
// tiles, sums in registers, reduces over the tile's columns with warp
// shuffles and writes one partial per (share, row); a second pass adds the
// shares in a fixed order.  No N x N intermediate is stored.

#include <cuda_runtime.h>

namespace {

constexpr int kBwdTile = 16;

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

// partial[chunk][i][0] = sbar share, [1] = lbar share.
template <typename T>
__global__ void gibbs_gram_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                                      const T* __restrict__ l, int n,
                                      const T* __restrict__ kbar, int n_chunks,
                                      T* __restrict__ partial) {
  __shared__ T x_r[kBwdTile], s_r[kBwdTile], l_r[kBwdTile];
  __shared__ T x_c[kBwdTile], s_c[kBwdTile], l_c[kBwdTile];
  __shared__ T kbt[kBwdTile][kBwdTile + 1];  // kbt[q][r] = Kbar[p0 + q][n0 + r]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * kBwdTile;
  const int chunk = blockIdx.y;
  const int n_tiles = (n + kBwdTile - 1) / kBwdTile;
  const int i = n0 + ty;
  if (ty == 0) {
    const bool ok = n0 + tx < n;
    x_r[tx] = ok ? x[n0 + tx] : T(0);
    s_r[tx] = ok ? s[n0 + tx] : T(0);
    l_r[tx] = ok ? l[n0 + tx] : T(1);
  }
  T acc_s = T(0), acc_l = T(0);
  for (int jt = chunk; jt < n_tiles; jt += n_chunks) {
    const int p0 = jt * kBwdTile;
    __syncthreads();  // the previous column tile is done with the shared strips
    if (ty == 0) {
      const bool ok = p0 + tx < n;
      x_c[tx] = ok ? x[p0 + tx] : T(0);
      s_c[tx] = ok ? s[p0 + tx] : T(0);
      l_c[tx] = ok ? l[p0 + tx] : T(1);
    }
    kbt[ty][tx] = (p0 + ty < n && n0 + tx < n)
        ? kbar[static_cast<size_t>(p0 + ty) * n + n0 + tx] : T(0);
    __syncthreads();
    const int j = p0 + tx;
    if (i < n && j < n) {
      const T sym = kbar[static_cast<size_t>(i) * n + j] + kbt[tx][ty];
      const T li = l_r[ty];
      const T lj = l_c[tx];
      const T a = li * li + lj * lj;
      const T b = li * lj;
      const T dx = x_r[ty] - x_c[tx];
      const T d = dx * dx;
      const T g = gsqrt(T(2) * b / a) * gexp(-d / a);
      acc_s = acc_s + sym * s_c[tx] * g;
      const T f = i == j ? T(0) : T(1) / (T(2) * li) - li / a + T(2) * li * d / (a * a);
      acc_l = acc_l + sym * (s_r[ty] * s_c[tx]) * g * f;
    }
  }
  for (int off = kBwdTile / 2; off > 0; off >>= 1) {
    acc_s = acc_s + __shfl_xor_sync(0xffffffffu, acc_s, off);
    acc_l = acc_l + __shfl_xor_sync(0xffffffffu, acc_l, off);
  }
  if (tx == 0 && i < n) {
    T* dst = partial + (static_cast<size_t>(chunk) * n + i) * 2;
    dst[0] = acc_s;
    dst[1] = acc_l;
  }
}

template <typename T>
__global__ void gibbs_gram_bwd_reduce(const T* __restrict__ partial, int n_chunks, int n,
                                      T* __restrict__ s_bar, T* __restrict__ l_bar) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const size_t stride = static_cast<size_t>(n) * 2;
  T v = partial[i];
  for (int c = 1; c < n_chunks; ++c) v = v + partial[c * stride + i];
  if (i % 2 == 0) s_bar[i / 2] = v;
  else l_bar[i / 2] = v;
}

template <typename T>
int launch_backward(const void* x, const void* s, const void* l, int n, const void* kbar,
                    int n_chunks, void* partial, void* s_bar, void* l_bar, void* stream) {
  const int n_tiles = (n + kBwdTile - 1) / kBwdTile;
  if (n_chunks < 1 || n_chunks > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, n_chunks);
  const dim3 block(kBwdTile, kBwdTile);
  gibbs_gram_bwd_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(s), static_cast<const T*>(l), n,
      static_cast<const T*>(kbar), n_chunks, static_cast<T*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gibbs_gram_bwd_reduce<T><<<(2 * n + 255) / 256, 256, 0, st>>>(
      static_cast<const T*>(partial), n_chunks, n, static_cast<T*>(s_bar),
      static_cast<T*>(l_bar));
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

// Self-form backward.  partial: n_chunks * n * 2 scratch values; s_bar, l_bar (n,).
int gibbs_gram_backward_f32(const void* x, const void* s, const void* l, int n,
                            const void* kbar, int n_chunks, void* partial, void* s_bar,
                            void* l_bar, void* stream) {
  return launch_backward<float>(x, s, l, n, kbar, n_chunks, partial, s_bar, l_bar, stream);
}

int gibbs_gram_backward_f64(const void* x, const void* s, const void* l, int n,
                            const void* kbar, int n_chunks, void* partial, void* s_bar,
                            void* l_bar, void* stream) {
  return launch_backward<double>(x, s, l, n, kbar, n_chunks, partial, s_bar, l_bar, stream);
}

}  // extern "C"
