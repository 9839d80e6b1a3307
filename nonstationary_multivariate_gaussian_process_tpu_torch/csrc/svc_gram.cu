// Fused GNMGP ("SVC") Gram, task-major, on an NVIDIA Hopper card (sm_90a).
//
//   K[(n,a),(p,c)] = (Kx[n,p] + jitter * [n == p]) * sum_b L[n,a,b] * L[p,c,b]
//   Kx[n,p]        = sqrt(2 l_n l_p / (l_n^2 + l_p^2)) * exp(-(x_n - x_p)^2 / (l_n^2 + l_p^2))
//
// with x, l of shape (N,) and the Cholesky process L of shape (N, M, M).  The
// jitter rides the n == p diagonal of Kx for EVERY task pair (a, c), not only
// the diagonal of the NM x NM matrix (reference logpos.py:345-349).  Row (n, a)
// is a*N + n and column (p, c) is c*N + p: the task-major layout of
// models.gnmgp.gram (y = Y.T.reshape(-1)).  The input-major layout of the same
// matrix is K3's (csrc/svc_gram_tiled.cu), which gram_kernels.svc_gram
// launches for layout="input".
//
// Replaces the TPU kernel `svc_gram_fused2d` (tile body `_svc2d_tile_kernel`)
// in nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py.
// Like it, this kernel never builds the (N, M, N, M) task-product
// intermediate in device memory.
//
// What bounds it on the H100: it reads O(N M^2) inputs and writes (N M)^2
// outputs, (N M)^2 * 8 bytes at float64 (32 MB at N=1000, M=2, about 9.6 us
// at 3.35 TB/s), against N^2 Gibbs terms (an exp, a sqrt and two divisions
// each, some 8 us for 10^6 in float64 on an NVIDIA H100 80GB HBM3 at 700 W:
// PERF.md) and 2 M^3 operations a pair.  The design is K3's forward laid out
// task-major, so that the stores stay wide and back to back:
// * An item is `rows` row inputs by a strip of 32 V column inputs; warp w
//   walks items w, w + (warps in the grid), ... on a persistent grid (`rows`,
//   the warps a block and the grid: gram_kernels.k2_schedule).
// * Lane l owns the V consecutive column inputs p = p0 + l V ..: it keeps
//   their x, l and rows of L (V M^2 values) in registers, and for each row
//   input n of the item (the same in every lane, so L_n is one broadcast
//   read) evaluates their V Gibbs terms once.
// * For each task pair (a, c) a lane then issues one V-wide store of
//   kx * bsum to row a*N + n, columns c*N + p ..: a warp's store covers 32 V
//   contiguous values (512 B at V = 2 in float64) in each of the M^2 output
//   rows the pair (n, strip) touches.
// * M (1..4) and V are template parameters.  V is 2 in float64 and 4 or 2 in
//   float32 where N is divisible by it, so every offset (a*N + n) N M + c*N +
//   p is a multiple of V; else 1 (scalar stores).
// * M > 4 takes the generic route, with M at run time: one thread per input
//   pair (n, p) on (32, 8) blocks, threads of a warp on neighbouring p,
//   scalar stores.  At V M^2 values of L in registers a lane would spill
//   from M = 5; serving runs M = 2.
// The ragged edge is masked.  Values never depend on the schedule.
//
// Built without fast math and with -fmad=false: the task sum runs b = 0..M-1
// in the plain version's order, each operation rounded on its own, so the
// kernel equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 4;          // the largest M of the templated route
constexpr int kMaxThreads = 256;  // templated route: at most 8 warps a block
constexpr int kGenericX = 32, kGenericY = 8;  // generic route: the block

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }

// The Gibbs term of row input n against column input p, without the jitter.
template <typename T>
__device__ __forceinline__ T gibbs(T xn, T ln, T xp, T lp) {
  const T a2 = ln * ln + lp * lp;
  const T b2 = ln * lp;
  const T dx = xn - xp;
  const T d = dx * dx;
  return gsqrt(T(2) * b2 / a2) * gexp(-d / a2);
}

// V consecutive values stored at once; `p` is aligned to V values.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else if constexpr (sizeof(T) == 8) {
    static_assert(V == 2, "float64 stores at most two values at once");
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    static_assert(V == 4, "float32 stores at most four values at once");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The store width: the widest of 16 B whose value count divides n.
template <typename T>
constexpr int store_width(int n) {
  return sizeof(T) == 8 ? (n % 2 == 0 ? 2 : 1) : (n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1);
}

// One warp per item (rows x 32 V input pairs); see the header.
template <typename T, int M, int V>
__global__ void __launch_bounds__(kMaxThreads)
svc_gram_task_kernel(const T* __restrict__ x, const T* __restrict__ ell, const T* __restrict__ ls,
                     int n, int rows, int n_items, T jitter, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_strips = (n + 32 * V - 1) / (32 * V);
  const size_t nm = static_cast<size_t>(n) * M;
  for (int item = blockIdx.x * warps + warp; item < n_items; item += gridDim.x * warps) {
    const int n0 = item / n_strips * rows;
    const int p = item % n_strips * (32 * V) + lane * V;  // the lane's first column input
    const bool live = p < n;  // N % V == 0: its V columns are all in or all out
    T xp[V], lp[V], Lp[V][M][M];  // Lp[v][c][b] = L[p + v, c, b]
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool in = p + v < n;
      xp[v] = in ? x[p + v] : T(0);
      lp[v] = in ? ell[p + v] : T(1);
      const T* src = ls + static_cast<size_t>(p + v) * M * M;
#pragma unroll
      for (int c = 0; c < M; ++c)
#pragma unroll
        for (int b = 0; b < M; ++b) Lp[v][c][b] = in ? src[c * M + b] : T(0);
    }
    const int n_end = min(n, n0 + rows);
    for (int r = n0; r < n_end; ++r) {  // r is the same in every lane
      const T xr = x[r], lr = ell[r];
      T kx[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        kx[v] = gibbs(xr, lr, xp[v], lp[v]);
        if (r == p + v) kx[v] = kx[v] + jitter;
      }
      const T* Lr = ls + static_cast<size_t>(r) * M * M;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        T La[M];
#pragma unroll
        for (int b = 0; b < M; ++b) La[b] = Lr[a * M + b];
        T* row = out + (static_cast<size_t>(a) * n + r) * nm + p;
#pragma unroll
        for (int c = 0; c < M; ++c) {
          T val[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            T bsum = La[0] * Lp[v][c][0];
#pragma unroll
            for (int b = 1; b < M; ++b) bsum = bsum + La[b] * Lp[v][c][b];
            val[v] = kx[v] * bsum;
          }
          if (live) store_vec<T, V>(row + static_cast<size_t>(c) * n, val);
        }
      }
    }
  }
}

// M > 4, any M: one thread per input pair (n, p); see the header.
template <typename T>
__global__ void svc_gram_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                        const T* __restrict__ ls, int n, int m, T jitter,
                                        T* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y * blockDim.y + threadIdx.y;  // the row input n
  if (q >= n || p >= n) return;
  T kx = gibbs(x[q], ell[q], x[p], ell[p]);
  if (q == p) kx = kx + jitter;
  const size_t nm = static_cast<size_t>(n) * m;
  const T* lq = ls + static_cast<size_t>(q) * m * m;
  const T* lp = ls + static_cast<size_t>(p) * m * m;
  for (int a = 0; a < m; ++a) {
    T* row = out + (static_cast<size_t>(a) * n + q) * nm + p;
    for (int c = 0; c < m; ++c) {
      T bsum = lq[a * m] * lp[c * m];
      for (int b = 1; b < m; ++b) bsum = bsum + lq[a * m + b] * lp[c * m + b];
      row[static_cast<size_t>(c) * n] = kx * bsum;
    }
  }
}

template <typename T, int M, int V>
int launch_task(const T* x, const T* ell, const T* ls, int n, int rows, int n_items, T jitter, int warps,
                int grid, T* out, cudaStream_t stream) {
  svc_gram_task_kernel<T, M, V><<<grid, warps * 32, 0, stream>>>(x, ell, ls, n, rows, n_items, jitter, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int launch_task_m(const T* x, const T* ell, const T* ls, int n, int vec, int rows, int n_items, T jitter,
                  int warps, int grid, T* out, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return launch_task<T, M, 4>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
  }
  if (vec == 2) return launch_task<T, M, 2>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
  return launch_task<T, M, 1>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
}

// For m <= 4: vec must be the store width of n, rows >= 1, 1 <= warps <= 8,
// grid >= 1, and the items must fit an int.  For m > 4 (the generic route):
// vec = 1, rows = 8, warps = 8 and grid = ceil(n / 32) * ceil(n / 8), the
// blocks of the (32, 8) grid.
template <typename T>
int launch(const void* x_, const void* ell_, const void* ls_, int n, int m, double jitter_, int vec,
           int rows, int warps, int grid, void* out_, void* stream_) {
  const T* x = static_cast<const T*>(x_);
  const T* ell = static_cast<const T*>(ell_);
  const T* ls = static_cast<const T*>(ls_);
  const T jitter = static_cast<T>(jitter_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m > kMaxM) {
    const dim3 block(kGenericX, kGenericY);
    const dim3 blocks((n + kGenericX - 1) / kGenericX, (n + kGenericY - 1) / kGenericY);
    if (vec != 1 || rows != kGenericY || warps != kGenericX * kGenericY / 32 || blocks.y > 65535 ||
        static_cast<long long>(grid) != static_cast<long long>(blocks.x) * blocks.y)
      return static_cast<int>(cudaErrorInvalidValue);
    svc_gram_generic_kernel<T><<<blocks, block, 0, stream>>>(x, ell, ls, n, m, jitter, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (vec != store_width<T>(n) || rows < 1 || warps < 1 || warps * 32 > kMaxThreads || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>((n + rows - 1) / rows) * ((n + 32 * vec - 1) / (32 * vec));
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
  switch (m) {
    case 1: return launch_task_m<T, 1>(x, ell, ls, n, vec, rows, n_items, jitter, warps, grid, out, stream);
    case 2: return launch_task_m<T, 2>(x, ell, ls, n, vec, rows, n_items, jitter, warps, grid, out, stream);
    case 3: return launch_task_m<T, 3>(x, ell, ls, n, vec, rows, n_items, jitter, warps, grid, out, stream);
    default: return launch_task_m<T, 4>(x, ell, ls, n, vec, rows, n_items, jitter, warps, grid, out, stream);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
// vec, rows, warps, grid: gram_kernels.k2_schedule(n, m, dtype).
int svc_gram_f32(const void* x, const void* ell, const void* ls, int n, int m, double jitter, int vec,
                 int rows, int warps, int grid, void* out, void* stream) {
  return launch<float>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, out, stream);
}

int svc_gram_f64(const void* x, const void* ell, const void* ls, int n, int m, double jitter, int vec,
                 int rows, int warps, int grid, void* out, void* stream) {
  return launch<double>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, out, stream);
}

}  // extern "C"
