// Tiled GNMGP ("SVC") Gram and its backward on an NVIDIA Hopper card (sm_90a).
//
//   K[(n,a),(p,c)] = kxj[n,p] * B[n,a,p,c]                     (input-major)
//   kxj[n,p]       = kx[n,p] + jitter * [n == p]
//   kx[n,p]        = sqrt(2 l_n l_p / A) * exp(-D / A),  A = l_n^2 + l_p^2, D = (x_n - x_p)^2
//   B[n,a,p,c]     = sum_b L[n,a,b] * L[p,c,b]
//
// with x, l of shape (N,) and the Cholesky process L of shape (N, M, M).
// Row (n, a) of the output is n*M + a, column (p, c) is p*M + c: the layout
// of row-major observations Y.reshape(-1).  This is the Gram of the GNMGP
// likelihood; the training path differentiates through it.
//
// Replaces the TPU kernel `svc_gram_fused` (tile body `_svc_tile_kernel`) in
// nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py.  The
// TPU kernel built each (T, M, T, M) block of the output from (T, 1) strips of
// x and l and (T, M, M) strips of L, with the task product as one
// dot_general per tile.  This kernel keeps that shape: one thread block per
// T x T tile of input pairs stages the row and column strips in shared
// memory, evaluates the Gibbs term of each pair once, and forms the
// (T*M) x (T*M) output tile from the staged strips.  The TPU had no backward
// kernel (XLA differentiated the jnp Gram); the backward here is new.
//
// What bounds them on the H100:
// * forward: it writes (N M)^2 outputs and reads O(N M^2) inputs, with some
//   2 M operations per output and ~12 per pair: bound by the bytes written,
//   (N M)^2 * 8 B = 32 MB at N=1000, M=2, float64 (about 9.6 us at 3.35 TB/s).
//   Consecutive threads store consecutive columns of a tile row.  The ragged
//   edge is masked, not padded.
// * backward: it reads Kbar (N M)^2 once as row tiles and once as transposed
//   tiles (Kbar is not assumed symmetric), and writes O(N M^2): bound by the
//   bytes read, at least (N M)^2 * 8 B.  Each block owns a tile of rows n and
//   a strided share of the column tiles, accumulates the row sums of its
//   pairs in registers, reduces them across the tile's columns with warp
//   shuffles and writes one partial per (share, n); a second pass sums the
//   shares in a fixed order, so the result does not depend on scheduling.
//   No N x N or (N, M, N, M) intermediate is stored.
//
//   Lbar[n,a,b] = sum_{p,c} (Kbar[(n,a),(p,c)] + Kbar[(p,c),(n,a)]) kxj[n,p] L[p,c,b]
//   lbar[n]     = sum_p (G[n,p] + G[p,n]) kx[n,p] (1/(2 l_n) - l_n/A + 2 l_n D/A^2),
//   G[n,p]      = sum_{a,c} Kbar[(n,a),(p,c)] B[n,a,p,c];  the factor is 0 at p == n.
//
// Built without fast math and with -fmad=false: the forward's task sum runs
// b = 0..M-1 in the plain version's order, each operation rounded on its own,
// so the forward matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // forward: input pairs per tile side
constexpr int kThreads = 256;
constexpr int kMaxM = 8;  // backward: tasks per input, a template parameter

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void svc_gram_tiled_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                      const T* __restrict__ ls, int n, int m, T jitter,
                                      T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int mm = m * m;
  T* x_r = smem;                     // kTile
  T* l_r = x_r + kTile;              // kTile
  T* x_c = l_r + kTile;              // kTile
  T* l_c = x_c + kTile;              // kTile
  T* kx_s = l_c + kTile;             // kTile * kTile
  T* L_r = kx_s + kTile * kTile;     // kTile * mm
  T* L_c = L_r + kTile * mm;         // kTile * mm

  const int n0 = blockIdx.y * kTile;
  const int p0 = blockIdx.x * kTile;
  const int rows_in = min(kTile, n - n0);
  const int cols_in = min(kTile, n - p0);
  const int tid = threadIdx.x;

  for (int i = tid; i < kTile; i += blockDim.x) {
    x_r[i] = i < rows_in ? x[n0 + i] : T(0);
    l_r[i] = i < rows_in ? ell[n0 + i] : T(1);
    x_c[i] = i < cols_in ? x[p0 + i] : T(0);
    l_c[i] = i < cols_in ? ell[p0 + i] : T(1);
  }
  for (int i = tid; i < kTile * mm; i += blockDim.x) {
    L_r[i] = i < rows_in * mm ? ls[static_cast<size_t>(n0) * mm + i] : T(0);
    L_c[i] = i < cols_in * mm ? ls[static_cast<size_t>(p0) * mm + i] : T(0);
  }
  __syncthreads();

  // the Gibbs term of each pair, once
  for (int i = tid; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const T li = l_r[r];
    const T lj = l_c[c];
    const T a2 = li * li + lj * lj;
    const T b2 = li * lj;
    const T dx = x_r[r] - x_c[c];
    const T d = dx * dx;
    T kx = gsqrt(T(2) * b2 / a2) * gexp(-d / a2);
    if (n0 + r == p0 + c) kx = kx + jitter;
    kx_s[i] = kx;
  }
  __syncthreads();

  // the (T*M) x (T*M) output tile, consecutive threads on consecutive columns
  const int rows = rows_in * m;
  const int cols = cols_in * m;
  const size_t nm = static_cast<size_t>(n) * m;
  T* tile_out = out + static_cast<size_t>(n0) * m * nm + static_cast<size_t>(p0) * m;
  for (int e = tid; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, q = e % cols;
    const int nl = r / m, a = r % m;
    const int pl = q / m, c = q % m;
    const T* lr = L_r + nl * mm + a * m;
    const T* lc = L_c + pl * mm + c * m;
    T bsum = lr[0] * lc[0];
    for (int b = 1; b < m; ++b) bsum = bsum + lr[b] * lc[b];
    tile_out[static_cast<size_t>(r) * nm + q] = kx_s[nl * kTile + pl] * bsum;
  }
}

template <typename T>
int launch_forward(const void* x, const void* ell, const void* ls, int n, int m,
                   double jitter, void* out, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const size_t smem = sizeof(T) * (4 * kTile + kTile * kTile + 2 * kTile * m * m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svc_gram_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svc_gram_tiled_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls), n, m,
      static_cast<T>(jitter), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// One block: a tile of `tile` rows n (threadIdx.y) against the column tiles
// chunk, chunk + n_chunks, ... (threadIdx.x is the column p within a tile).
// Writes partial[chunk][n][0..M*M) = Lbar contributions and [M*M] = lbar's.
template <typename T, int M>
__global__ void svc_gram_tiled_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                          const T* __restrict__ ls, int n, T jitter,
                                          const T* __restrict__ kbar, int n_chunks,
                                          T* __restrict__ partial) {
  constexpr int MM = M * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tile = blockDim.x;  // == blockDim.y, a power of two <= 32
  const int tm = tile * M;
  const int ld = tm + 1;  // padded rows of the staged Kbar tiles
  T* x_r = smem;
  T* l_r = x_r + tile;
  T* x_c = l_r + tile;
  T* l_c = x_c + tile;
  T* L_r = l_c + tile;          // tile * MM
  T* L_c = L_r + tile * MM;     // tile * MM
  T* kb = L_c + tile * MM;      // tm x ld: Kbar[(n,a),(p,c)]
  T* kbt = kb + tm * ld;        // tm x ld: Kbar[(p,c),(n,a)], row (p,c)

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tile + tx;
  const int nthreads = tile * tile;
  const int n0 = blockIdx.x * tile;
  const int chunk = blockIdx.y;
  const int n_tiles = (n + tile - 1) / tile;
  const int rows_in = min(tile, n - n0);
  const size_t nm = static_cast<size_t>(n) * M;

  for (int i = tid; i < tile; i += nthreads) {
    x_r[i] = i < rows_in ? x[n0 + i] : T(0);
    l_r[i] = i < rows_in ? ell[n0 + i] : T(1);
  }
  for (int i = tid; i < tile * MM; i += nthreads)
    L_r[i] = i < rows_in * MM ? ls[static_cast<size_t>(n0) * MM + i] : T(0);

  T acc_l[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) acc_l[k] = T(0);
  T acc_e = T(0);
  const int row_n = n0 + ty;

  for (int jt = chunk; jt < n_tiles; jt += n_chunks) {
    const int p0 = jt * tile;
    const int cols_in = min(tile, n - p0);
    __syncthreads();  // the previous column tile is done with the shared strips
    for (int i = tid; i < tile; i += nthreads) {
      x_c[i] = i < cols_in ? x[p0 + i] : T(0);
      l_c[i] = i < cols_in ? ell[p0 + i] : T(1);
    }
    for (int i = tid; i < tile * MM; i += nthreads)
      L_c[i] = i < cols_in * MM ? ls[static_cast<size_t>(p0) * MM + i] : T(0);
    // both Kbar tiles, each read along its rows (coalesced)
    for (int i = tid; i < tm * tm; i += nthreads) {
      const int r = i / tm, q = i % tm;
      const bool row_ok = r < rows_in * M, col_ok = q < cols_in * M;
      kb[r * ld + q] = (row_ok && col_ok)
          ? kbar[(static_cast<size_t>(n0) * M + r) * nm + static_cast<size_t>(p0) * M + q] : T(0);
      const bool trow_ok = r < cols_in * M, tcol_ok = q < rows_in * M;
      kbt[r * ld + q] = (trow_ok && tcol_ok)
          ? kbar[(static_cast<size_t>(p0) * M + r) * nm + static_cast<size_t>(n0) * M + q] : T(0);
    }
    __syncthreads();

    if (ty < rows_in && tx < cols_in) {
      const T ln = l_r[ty];
      const T lp = l_c[tx];
      const T a2 = ln * ln + lp * lp;
      const T b2 = ln * lp;
      const T dx = x_r[ty] - x_c[tx];
      const T d = dx * dx;
      const T kx = gsqrt(T(2) * b2 / a2) * gexp(-d / a2);
      const bool diag = row_n == p0 + tx;
      const T kxj = diag ? kx + jitter : kx;
      const T f = diag ? T(0) : T(1) / (T(2) * ln) - ln / a2 + T(2) * ln * d / (a2 * a2);
      const T* Ln = L_r + ty * MM;
      const T* Lp = L_c + tx * MM;
      T gsum = T(0);
#pragma unroll
      for (int a = 0; a < M; ++a) {
#pragma unroll
        for (int c = 0; c < M; ++c) {
          T bac = Ln[a * M] * Lp[c * M];
#pragma unroll
          for (int b = 1; b < M; ++b) bac = bac + Ln[a * M + b] * Lp[c * M + b];
          const T s = kb[(ty * M + a) * ld + tx * M + c] + kbt[(tx * M + c) * ld + ty * M + a];
          gsum = gsum + s * bac;
          const T w = s * kxj;
#pragma unroll
          for (int b = 0; b < M; ++b) acc_l[a * M + b] = acc_l[a * M + b] + w * Lp[c * M + b];
        }
      }
      acc_e = acc_e + gsum * kx * f;
    }
  }

  // sum over the tile's columns: the `tile` lanes of one row are adjacent in a warp
  for (int off = tile / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < MM; ++k) acc_l[k] = acc_l[k] + __shfl_xor_sync(0xffffffffu, acc_l[k], off);
    acc_e = acc_e + __shfl_xor_sync(0xffffffffu, acc_e, off);
  }
  if (tx == 0 && ty < rows_in) {
    T* dst = partial + (static_cast<size_t>(chunk) * n + row_n) * (MM + 1);
#pragma unroll
    for (int k = 0; k < MM; ++k) dst[k] = acc_l[k];
    dst[MM] = acc_e;
  }
}

// Sums the shares in chunk order: ls_bar (N, M, M) and ell_bar (N,).
template <typename T>
__global__ void svc_gram_tiled_bwd_reduce(const T* __restrict__ partial, int n_chunks, int n,
                                          int mm, T* __restrict__ ls_bar, T* __restrict__ ell_bar) {
  const int width = mm + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * width) return;
  const size_t stride = static_cast<size_t>(n) * width;
  T s = partial[i];
  for (int c = 1; c < n_chunks; ++c) s = s + partial[c * stride + i];
  const int row = i / width, k = i % width;
  if (k < mm) ls_bar[static_cast<size_t>(row) * mm + k] = s;
  else ell_bar[row] = s;
}

template <typename T, int M>
int launch_backward_m(const T* x, const T* ell, const T* ls, int n, T jitter, const T* kbar,
                      int tile, int n_chunks, T* partial, cudaStream_t stream) {
  const int tm = tile * M;
  const size_t smem = sizeof(T) * (4 * tile + 2 * tile * M * M + 2 * tm * (tm + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svc_gram_tiled_bwd_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + tile - 1) / tile, n_chunks);
  const dim3 block(tile, tile);
  svc_gram_tiled_bwd_kernel<T, M><<<grid, block, smem, stream>>>(
      x, ell, ls, n, jitter, kbar, n_chunks, partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const void* ell, const void* ls, int n, int m,
                    double jitter, const void* kbar, int tile, int n_chunks, void* partial,
                    void* ls_bar, void* ell_bar, void* stream) {
  const int n_tiles = (n + tile - 1) / tile;
  if (m < 1 || m > kMaxM || (tile != 8 && tile != 16) || n_chunks < 1 || n_chunks > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  const T* es = static_cast<const T*>(ell);
  const T* lss = static_cast<const T*>(ls);
  const T* kb = static_cast<const T*>(kbar);
  T* part = static_cast<T*>(partial);
  const T jit = static_cast<T>(jitter);
  int status = 0;
  switch (m) {
    case 1: status = launch_backward_m<T, 1>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 2: status = launch_backward_m<T, 2>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 3: status = launch_backward_m<T, 3>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 4: status = launch_backward_m<T, 4>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 5: status = launch_backward_m<T, 5>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 6: status = launch_backward_m<T, 6>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    case 7: status = launch_backward_m<T, 7>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
    default: status = launch_backward_m<T, 8>(xs, es, lss, n, jit, kb, tile, n_chunks, part, s); break;
  }
  if (status != 0) return status;
  const int total = n * (m * m + 1);
  svc_gram_tiled_bwd_reduce<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, n_chunks, n, m * m, static_cast<T*>(ls_bar), static_cast<T*>(ell_bar));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
int svc_gram_tiled_f32(const void* x, const void* ell, const void* ls, int n, int m,
                       double jitter, void* out, void* stream) {
  return launch_forward<float>(x, ell, ls, n, m, jitter, out, stream);
}

int svc_gram_tiled_f64(const void* x, const void* ell, const void* ls, int n, int m,
                       double jitter, void* out, void* stream) {
  return launch_forward<double>(x, ell, ls, n, m, jitter, out, stream);
}

// partial: n_chunks * n * (m*m + 1) scratch values; ls_bar (n, m, m); ell_bar (n,).
int svc_gram_tiled_backward_f32(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int n_chunks,
                                void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<float>(x, ell, ls, n, m, jitter, kbar, tile, n_chunks, partial,
                                ls_bar, ell_bar, stream);
}

int svc_gram_tiled_backward_f64(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int n_chunks,
                                void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<double>(x, ell, ls, n, m, jitter, kbar, tile, n_chunks, partial,
                                 ls_bar, ell_bar, stream);
}

}  // extern "C"
