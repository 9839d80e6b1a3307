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
// dot_general per tile.
//
// Forward.  It writes (N M)^2 outputs and reads O(N M^2) inputs, with some
// 2 M operations per output and ~12 per pair: bound by the bytes written,
// (N M)^2 * 8 B = 32 MB at N=1000, M=2, float64 (about 9.6 us at 3.35 TB/s).
// So the design keeps a warp's stores wide and back to back, with no barrier
// and no per-output index arithmetic:
// * Work items are 32-input column strips of `rows` consecutive row inputs:
//   item i takes row inputs (i / strips) * rows .. and columns (i % strips)
//   * 32 ..  Each warp walks items w, w + (warps in the grid), ...  (a
//   persistent grid; `rows`, the warps per block and the grid come from
//   gram_kernels.k3_forward_schedule).
// * Lane l owns column input p = p0 + l: it evaluates the Gibbs term of
//   (n, p) once per row input n, in registers.  A row (n, a) of the strip is
//   32 M contiguous outputs; lane l stores its chunks (l + 32 k) V .. + V - 1
//   for k < M / V, V values at once (double2 for even M in float64, float4
//   or float2 for M divisible by 4 or 2 in float32, else scalars).  A chunk
//   lies within one column input, whose Gibbs term comes from its owner lane
//   by a shuffle where V < M.  So every store instruction of a warp covers
//   32 V contiguous values, and a row of the strip 32 M (512 B at M=2,
//   float64).  The route (V) follows from M and the type alone: an even M
//   keeps every row offset n M (N M) + a (N M) + p M even.
// * M (1..8) is a template parameter, so the chunk decoding (element e = (l
//   + 32 k) V: input e / M, task e % M) is done once per thread.  For M <= 4
//   a lane keeps the L rows of its chunks in registers for the whole item;
//   for M = 5..8 the warp stages its strip of L in shared memory, transposed
//   to [b][e], and a lane holds one row of L_n at a time, so nothing spills.
// * M > 8 takes the generic route: one block per 16 x 16 tile of input
//   pairs, a runtime task loop, scalar stores.  Its shared memory holds x,
//   l and the Gibbs terms of the tile, a fixed size; L is read through the
//   cache, so any M that fits the card runs.
// The ragged edge is masked.  Values never depend on the schedule: each
// output is kx * bsum of its own (n, a, p, c).  What holds it back on the
// card (PERF.md): in float64 the Gibbs term's exp, sqrt and two divisions
// take about as long as the stores alone, and each warp reaches its first
// store only after its loads and first Gibbs term.  Evaluating the term once
// per unordered pair (tile pairs I <= J, the transposed block through shared
// memory) was tried and was no faster at N=1000 and slower at N=257.
//
// Backward: the gradient of the same TPU kernel's Gram (pallas_kernels.py:122;
// the TPU had no backward kernel, XLA differentiated the jnp Gram).  For a
// cotangent Kbar (N M, N M) that need not be symmetric:
//
//   S           = Kbar + Kbar^T
//   Lbar[n,a,b] = sum_{p,c} S[(n,a),(p,c)] kxj[n,p] L[p,c,b]
//   lbar[n]     = sum_p gsum[n,p] kx[n,p] f(l_n; l_p, D)
//   gsum[n,p]   = sum_{a,c} S[(n,a),(p,c)] B[n,a,p,c]
//   f(l_n; l_p, D) = 1/(2 l_n) - l_n/A + 2 l_n D/A^2,   and f = 0 at p == n.
//
// What bounds it: the bytes of Kbar, (N M)^2 * 8 B = 32 MB at N=1000, M=2,
// float64 (9.6 us at 3.35 TB/s); everything else is O(N M^2).  The design
// reads each element of Kbar exactly once:
// * The blocks walk the unordered tile pairs (I <= J), row-major, in one
//   fixed order (pair q = (I, J) with q counted along I = 0, 1, ...; block b
//   takes q = b, b + gridDim.x, ...: a persistent grid).  A pair stages
//   Kbar[I,J] and Kbar[J,I] (one tile when I == J), forms S once and
//   evaluates kx, both f's, B and gsum once for each unordered input pair
//   (n, p), then adds its contributions to both rows n and p.  On a diagonal
//   tile each unordered pair counts once (thread row < thread column) and
//   n == p once (the row side alone, f = 0).  So the Gibbs and task work is
//   half of what an ordered walk does.
// * Loads stay in flight: the next pair's Kbar tiles and strips are copied
//   into a second shared-memory stage with cp.async while the current pair
//   is computed.  Copies are element-wise (4 or 8 bytes), so any N and M
//   work: Kbar's row stride N M need not be a multiple of 16 bytes.
// * Staged Kbar tiles are task-pair major, [a][c][row][col] with rows
//   padded to T+1, so a warp reads Kbar[I,J] along consecutive columns and
//   Kbar[J,I] along an odd stride: no shared-memory bank conflicts in f64.
// * The result does not depend on scheduling.  A pair sums its row shares
//   over the tile's columns (through shared memory, in order) and its
//   column shares over the tile's rows (shuffles, then the warps in order)
//   and writes them to fixed
//   slots, partial[partner tile][row]: rows of tile I to slot J, rows of
//   tile J to slot I.  Every (slot, row) is written exactly once, and a
//   second launch sums each row's slots in one fixed order (a warp per row,
//   lanes over slots, then a shuffle tree).  The partials are
//   ceil(N/T) N (M^2 + 1) values: 2.5 MB at N=1000, M=2, T=16, float64.
// * T (16 for M <= 4, else 8) and M are template parameters.  No tensor
//   cores: wgmma has no float64 form and the task contraction has length M.
// * M > 8 takes a generic route with M at run time: one block per row input,
//   no partials, and shared memory of a fixed size (see
//   svc_gram_tiled_bwd_generic_kernel).  It is simple, not fast: it reads
//   Kbar twice.
//
// Built without fast math and with -fmad=false: the forward's task sum runs
// b = 0..M-1 in the plain version's order, each operation rounded on its own,
// so the forward matches the plain PyTorch version bit for bit.  The backward
// is held to a tolerance and uses explicit fma() and one division per pair.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // forward, M > 8: input pairs per tile side
constexpr int kGenericSmem = 4 * kTile + kTile * kTile;  // forward, M > 8: shared values a block
constexpr int kThreads = 256;
constexpr int kMaxM = 8;  // the largest M of the templated routes
constexpr int kFwdMaxThreads = 256;  // forward, M <= 8: at most 8 warps a block

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

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

template <typename T, int M>
struct Fwd {
  static constexpr int MM = M * M;
  // values per store: the alignment rule of gram_kernels.k3_forward_schedule
  static constexpr int V = sizeof(T) == 8 ? (M % 2 == 0 ? 2 : 1) : (M % 4 == 0 ? 4 : M % 2 == 0 ? 2 : 1);
  static constexpr int K = M / V;          // chunks of a row a lane stores
  static constexpr bool REGS = M <= 4;     // the strip's L in registers, else in shared memory
  static constexpr int STRIP = 32 * MM;    // a warp's staged strip of L (shared-memory route)
};

// Lane `lane`'s chunks of the strip of 32 column inputs from s0, and the L
// rows they need: chunk k is elements (lane + 32 k) V .. + V - 1 of an output
// row of the strip, all of column input s0 + pl[k], tasks c0[k] .. + V - 1.
template <typename T, int M>
struct Strip {
  using F = Fwd<T, M>;
  int pl[F::K], c0[F::K];
  T L[F::REGS ? F::K : 1][F::V][M];  // register route: L[s0 + pl[k], c0[k] + v, b]
  const T* Ls;                       // shared-memory route: [b][e] = L[s0 + e / M, e % M, b]

  __device__ __forceinline__ Strip(int lane, int s0, int n, const T* ls, const T* staged) : Ls(staged) {
#pragma unroll
    for (int k = 0; k < F::K; ++k) {
      const int e = (lane + 32 * k) * F::V;
      pl[k] = e / M;
      c0[k] = e % M;
      if constexpr (F::REGS) {
        const bool in = s0 + pl[k] < n;
        const T* src = ls + (static_cast<size_t>(s0 + pl[k]) * M + c0[k]) * M;
#pragma unroll
        for (int v = 0; v < F::V; ++v)
#pragma unroll
          for (int b = 0; b < M; ++b) L[k][v][b] = in ? src[v * M + b] : T(0);
      }
    }
  }

  __device__ __forceinline__ T at(int lane, int k, int v, int b) const {
    if constexpr (F::REGS) return L[k][v][b];
    else return Ls[b * (32 * M) + (lane + 32 * k) * F::V + v];
  }
};

// The M output rows (r, a) over the strip from s0; kx is the Gibbs term of
// (r, s0 + lane), r is the same in every lane.
template <typename T, int M>
__device__ __forceinline__ void store_rows(T* __restrict__ out, size_t nm, int n, int r, int s0, T kx,
                                           const T* __restrict__ ls, const Strip<T, M>& st, int lane) {
  using F = Fwd<T, M>;
  constexpr int V = F::V, K = F::K;
  T kxk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) kxk[k] = V == M ? kx : __shfl_sync(0xffffffffu, kx, st.pl[k]);
  const T* ls_r = ls + static_cast<size_t>(r) * F::MM;
  T* row = out + static_cast<size_t>(r) * M * nm + static_cast<size_t>(s0) * M;
#pragma unroll
  for (int a = 0; a < M; ++a, row += nm) {
    T Lr[M];
#pragma unroll
    for (int b = 0; b < M; ++b) Lr[b] = ls_r[a * M + b];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (s0 + st.pl[k] >= n) continue;
      T val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T bsum = Lr[0] * st.at(lane, k, v, 0);
#pragma unroll
        for (int b = 1; b < M; ++b) bsum = bsum + Lr[b] * st.at(lane, k, v, b);
        val[v] = kxk[k] * bsum;
      }
      store_vec<T, V>(row + (lane + 32 * k) * V, val);
    }
  }
}

// The warp's strip of L from s0, [b][e], for the shared-memory route; past
// N, L = 0.
template <typename T, int M>
__device__ __forceinline__ void stage_L(T* dst, int s0, int n, const T* __restrict__ ls, int lane) {
  using F = Fwd<T, M>;
  const int valid = min(32, n - s0) * F::MM;
  const T* src = ls + static_cast<size_t>(s0) * F::MM;
  for (int i = lane; i < F::STRIP; i += 32) dst[(i % M) * (32 * M) + i / M] = i < valid ? src[i] : T(0);
}

// One warp per item (rows x 32 input pairs); see the header.
template <typename T, int M>
__global__ void __launch_bounds__(kFwdMaxThreads)
svc_gram_tiled_fwd_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                          const T* __restrict__ ls, int n, int rows, int n_items, T jitter,
                          T* __restrict__ out) {
  using F = Fwd<T, M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_strips = (n + 31) / 32;
  const size_t nm = static_cast<size_t>(n) * M;
  T* Ls = reinterpret_cast<T*>(smem_raw) + warp * F::STRIP;  // shared-memory route: the warp's strip
  for (int item = blockIdx.x * warps + warp; item < n_items; item += gridDim.x * warps) {
    const int n0 = item / n_strips * rows;
    const int p0 = item % n_strips * 32;
    if constexpr (!F::REGS) {
      __syncwarp();  // every lane is done with the previous item's strip
      stage_L<T, M>(Ls, p0, n, ls, lane);
      __syncwarp();
    }
    const Strip<T, M> st(lane, p0, n, ls, Ls);
    const int p = p0 + lane;
    const T xp = p < n ? x[p] : T(0);
    const T lp = p < n ? ell[p] : T(1);
    const int n1 = min(n, n0 + rows);
    for (int r = n0; r < n1; ++r) {  // r is the same in every lane
      T kx = gibbs(x[r], ell[r], xp, lp);
      if (r == p) kx = kx + jitter;
      store_rows<T, M>(out, nm, n, r, p0, kx, ls, st, lane);
    }
  }
}

// M > 8, any M: one block per 16 x 16 tile of input pairs.  Shared memory
// holds the tile's x, l and Gibbs terms alone, kGenericSmem values whatever
// M is; the rows of L_n and L_p are read through the cache.
template <typename T>
__global__ void svc_gram_tiled_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell,
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
  __syncthreads();

  // the Gibbs term of each pair, once
  for (int i = tid; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    T kx = gibbs(x_r[r], l_r[r], x_c[c], l_c[c]);
    if (n0 + r == p0 + c) kx = kx + jitter;
    kx_s[i] = kx;
  }
  __syncthreads();

  // the (T*M) x (T*M) output tile, consecutive threads on consecutive columns
  const int rows = rows_in * m;
  const int cols = cols_in * m;
  const size_t nm = static_cast<size_t>(n) * m;
  const T* L_r = ls + static_cast<size_t>(n0) * mm;
  const T* L_c = ls + static_cast<size_t>(p0) * mm;
  T* tile_out = out + static_cast<size_t>(n0) * m * nm + static_cast<size_t>(p0) * m;
  for (int e = tid; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, q = e % cols;
    const int nl = r / m, a = r % m;
    const int pl = q / m, c = q % m;
    const T* lr = L_r + static_cast<size_t>(nl) * mm + a * m;
    const T* lc = L_c + static_cast<size_t>(pl) * mm + c * m;
    T bsum = __ldg(lr) * __ldg(lc);
    for (int b = 1; b < m; ++b) bsum = bsum + __ldg(lr + b) * __ldg(lc + b);
    tile_out[static_cast<size_t>(r) * nm + q] = kx_s[nl * kTile + pl] * bsum;
  }
}

template <typename T, int M>
int launch_forward_m(const T* x, const T* ell, const T* ls, int n, int rows, int n_items, T jitter,
                     int warps, int grid, T* out, cudaStream_t stream) {
  using F = Fwd<T, M>;
  const size_t smem = F::REGS ? 0 : sizeof(T) * F::STRIP * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svc_gram_tiled_fwd_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svc_gram_tiled_fwd_kernel<T, M><<<grid, warps * 32, smem, stream>>>(x, ell, ls, n, rows, n_items,
                                                                       jitter, out);
  return static_cast<int>(cudaGetLastError());
}

// vec must be the store width of (T, m) and rows the tile's row inputs
// (16 for m > 8); for m <= 8, 1 <= warps <= kFwdMaxThreads / 32 and
// 1 <= grid.
template <typename T>
int launch_forward(const void* x_, const void* ell_, const void* ls_, int n, int m,
                   double jitter_, int vec, int rows, int warps, int grid, void* out_,
                   void* stream_) {
  const T* x = static_cast<const T*>(x_);
  const T* ell = static_cast<const T*>(ell_);
  const T* ls = static_cast<const T*>(ls_);
  const T jitter = static_cast<T>(jitter_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m > kMaxM) {
    // a tile's (16 M)^2 outputs and N M must fit an int
    const int tiles = (n + kTile - 1) / kTile;
    if (vec != 1 || rows != kTile || tiles > 65535 || static_cast<long long>(n) * m > 0x7fffffff ||
        kTile * m > 46340)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(T) * kGenericSmem;
    svc_gram_tiled_generic_kernel<T><<<dim3(tiles, tiles), kThreads, smem, stream>>>(
        x, ell, ls, n, m, jitter, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int want_vec = sizeof(T) == 8 ? (m % 2 == 0 ? 2 : 1) : (m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : 1);
  if (vec != want_vec || rows < 1 || warps < 1 || warps * 32 > kFwdMaxThreads || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>((n + rows - 1) / rows) * ((n + 31) / 32);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
  switch (m) {
    case 1: return launch_forward_m<T, 1>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 2: return launch_forward_m<T, 2>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 3: return launch_forward_m<T, 3>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 4: return launch_forward_m<T, 4>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 5: return launch_forward_m<T, 5>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 6: return launch_forward_m<T, 6>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    case 7: return launch_forward_m<T, 7>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
    default: return launch_forward_m<T, 8>(x, ell, ls, n, rows, n_items, jitter, warps, grid, out, stream);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared-memory layout of the backward for T inputs per tile side and M tasks.
template <typename T, int TILE, int M>
struct Bwd {
  static constexpr int MM = M * M;
  static constexpr int K = MM + 1;            // values of one row's partial: Lbar, then lbar
  static constexpr int TM = TILE * M;         // rows (and columns) of a Kbar tile
  static constexpr int KP = TILE + 1;         // padded row of a staged Kbar tile
  static constexpr int KB = MM * TILE * KP;   // one staged Kbar tile, [a][c][row][col]
  static constexpr int LP = MM | 1;           // padded (odd) pitch of one staged L
  static constexpr int STRIP = 2 * TILE + TILE * LP;  // x, l, L of one input tile
  static constexpr int STAGE = 2 * KB + 2 * STRIP;
  static constexpr int THREADS = TILE * TILE;
  static constexpr int WARPS = THREADS / 32;
  // Row shares are summed through a [row][k][column] buffer with padded
  // rows of RP.  It holds all TILE columns where two blocks still fit on an
  // SM (228 KB of shared memory, 1 KB of it reserved per block); else a
  // shuffle first halves them to 8.
  static constexpr size_t FULL_SMEM = sizeof(T) * (2 * STAGE + TILE * K * (TILE + 1) + WARPS * TILE * K);
  static constexpr int RC = FULL_SMEM + 1024 <= 228 * 1024 / 2 || TILE < 8 ? TILE : 8;
  static constexpr int RP = RC + 1;
  // the row-share buffer, then the column sums of each warp
  static constexpr int RED = TILE * K * RP + WARPS * TILE * K;
  static constexpr size_t SMEM = sizeof(T) * (2 * STAGE + RED);
  static_assert(THREADS % 32 == 0 && 32 % TILE == 0, "a warp holds whole tile rows");
};

// Tile pair q of the row-major walk over I <= J.  Row I starts at pair
// I*nt - I*(I-1)/2; a float root gives I, and the two loops correct it.
__device__ __forceinline__ int first_pair(int i, int n_tiles) { return i * n_tiles - i * (i - 1) / 2; }

__device__ __forceinline__ void tile_pair(int q, int n_tiles, int& I, int& J) {
  const float b = 2.0f * n_tiles + 1.0f;
  int i = static_cast<int>((b - sqrtf(fmaxf(b * b - 8.0f * q, 0.0f))) * 0.5f);
  i = max(0, min(i, n_tiles - 1));
  while (i > 0 && q < first_pair(i, n_tiles)) --i;
  while (i + 1 < n_tiles && q >= first_pair(i + 1, n_tiles)) ++i;
  I = i;
  J = i + q - first_pair(i, n_tiles);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

// x, l and L of the input tile starting at n0; the ragged edge gets x = 0,
// l = 1, L = 0 (finite Gibbs terms, zero contributions).
template <typename T, int TILE, int M>
__device__ __forceinline__ void stage_strip(T* strip, int n0, int n, const T* x, const T* ell,
                                            const T* ls, int tid) {
  using S = Bwd<T, TILE, M>;
  T* xs = strip;
  T* es = xs + TILE;
  T* Ls = es + TILE;
  for (int i = tid; i < TILE; i += S::THREADS) {
    if (n0 + i < n) {
      copy_async(xs + i, x + n0 + i);
      copy_async(es + i, ell + n0 + i);
    } else {
      xs[i] = T(0);
      es[i] = T(1);
    }
  }
  for (int i = tid; i < TILE * S::MM; i += S::THREADS) {
    const int r = i / S::MM, k = i % S::MM;
    if (n0 + r < n) copy_async(Ls + r * S::LP + k, ls + static_cast<size_t>(n0 + r) * S::MM + k);
    else Ls[r * S::LP + k] = T(0);
  }
}

// Kbar's tile (row tile R, column tile C) into [a][c][row][col] order, read
// along Kbar's rows (coalesced); the ragged edge is 0.
template <typename T, int TILE, int M>
__device__ __forceinline__ void stage_kbar(T* dst, int R, int C, int n, const T* kbar, int tid) {
  using S = Bwd<T, TILE, M>;
  constexpr int TM = S::TM;
  const size_t nm = static_cast<size_t>(n) * M;
  const int r0 = R * TILE, c0 = C * TILE;
  const int rows_in = min(TILE, n - r0) * M, cols_in = min(TILE, n - c0) * M;
  const T* src = kbar + static_cast<size_t>(r0) * M * nm + static_cast<size_t>(c0) * M;
  if constexpr (S::THREADS % TM == 0) {
    // each thread keeps one column q and steps down the rows
    constexpr int RSTEP = S::THREADS / TM;
    const int q = tid % TM, pl = q / M, c = q % M;
    const int r1 = tid / TM;
    const bool col_ok = q < cols_in;
    const T* s1 = src + static_cast<size_t>(r1) * nm + q;
#pragma unroll
    for (int k = 0; k < TM / RSTEP; ++k) {
      const int r = r1 + k * RSTEP;
      T* d = dst + (((r % M) * M + c) * TILE + r / M) * S::KP + pl;
      if (col_ok && r < rows_in) copy_async(d, s1 + static_cast<size_t>(k) * RSTEP * nm);
      else *d = T(0);
    }
  } else {
    for (int i = tid; i < TM * TM; i += S::THREADS) {
      const int r = i / TM, q = i % TM;
      T* d = dst + (((r % M) * M + q % M) * TILE + r / M) * S::KP + q / M;
      if (r < rows_in && q < cols_in) copy_async(d, src + static_cast<size_t>(r) * nm + q);
      else *d = T(0);
    }
  }
}

template <typename T, int TILE, int M>
__device__ __forceinline__ void stage_pair(T* st, int I, int J, int n, const T* x, const T* ell,
                                           const T* ls, const T* kbar, int tid) {
  using S = Bwd<T, TILE, M>;
  stage_kbar<T, TILE, M>(st, I, J, n, kbar, tid);
  if (I != J) stage_kbar<T, TILE, M>(st + S::KB, J, I, n, kbar, tid);
  stage_strip<T, TILE, M>(st + 2 * S::KB, I * TILE, n, x, ell, ls, tid);
  stage_strip<T, TILE, M>(st + 2 * S::KB + S::STRIP, J * TILE, n, x, ell, ls, tid);
}

// One block walks tile pairs q = blockIdx.x, + gridDim.x, ...; thread
// (ty, tx) takes the input pair (n, p) = (I*T + ty, J*T + tx).  Writes
// partial[slot][row][0..M*M) = Lbar's share and [M*M] = lbar's share.
template <typename T, int TILE, int M>
__global__ void __launch_bounds__(TILE * TILE)
svc_gram_tiled_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                          const T* __restrict__ ls, int n, T jitter,
                          const T* __restrict__ kbar, T* __restrict__ partial) {
  using S = Bwd<T, TILE, M>;
  constexpr int MM = S::MM, K = S::K, KP = S::KP, LP = S::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  T* red_row = stages + 2 * S::STAGE;    // TILE x K x RP: the row shares
  T* red_col = red_row + TILE * K * S::RP;  // WARPS x TILE x K

  const int tid = threadIdx.x;
  const int tx = tid % TILE, ty = tid / TILE;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;

  int q = blockIdx.x, I, J;
  tile_pair(q, n_tiles, I, J);
  stage_pair<T, TILE, M>(stages, I, J, n, x, ell, ls, kbar, tid);
  __pipeline_commit();
  for (int it = 0; q < n_pairs; ++it, q += gridDim.x) {
    const T* st = stages + (it & 1) * S::STAGE;
    int In = 0, Jn = 0;
    if (q + gridDim.x < n_pairs) {
      tile_pair(q + gridDim.x, n_tiles, In, Jn);
      stage_pair<T, TILE, M>(stages + ((it + 1) & 1) * S::STAGE, In, Jn, n, x, ell, ls, kbar, tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this pair's copies have landed
    __syncthreads();

    const bool diag = I == J;
    const T* kb = st;                      // Kbar[(n,a),(p,c)] at [a][c][ty][tx]
    const T* kbt = diag ? st : st + S::KB; // Kbar[(p,c),(n,a)] at [c][a][tx][ty]
    const T* xr = st + 2 * S::KB;
    const T* lr = xr + TILE;
    const T* Lr = lr + TILE;
    const T* xc = xr + S::STRIP;
    const T* lc = xc + TILE;
    const T* Lc = lc + TILE;

    T row[K], col[K];
#pragma unroll
    for (int k = 0; k < K; ++k) row[k] = col[k] = T(0);
    if (!diag || ty <= tx) {
      const bool self = diag && ty == tx;  // n == p: the row side alone
      const T ln = lr[ty], lp = lc[tx];
      const T dx = xr[ty] - xc[tx];
      const T d = dx * dx;
      const T a2 = fma(ln, ln, lp * lp);
      const T b2 = ln * lp;
      const T inv_ab = T(1) / (a2 * b2);  // the pair's one division
      const T inv_a = b2 * inv_ab;
      const T half_inv_b = T(0.5) * a2 * inv_ab;  // 1/(2 l_n) = l_p/(2 l_n l_p)
      const T kx = gsqrt(T(2) * b2 * inv_a) * gexp(-d * inv_a);
      const T kxj = self ? kx + jitter : kx;
      const T g = fma(T(2) * d, inv_a * inv_a, -inv_a);  // -1/A + 2 D/A^2
      const T* Ln = Lr + ty * LP;
      const T* Lp = Lc + tx * LP;
      T gsum = T(0);
#pragma unroll
      for (int a = 0; a < M; ++a) {
#pragma unroll
        for (int c = 0; c < M; ++c) {
          const T s = kb[((a * M + c) * TILE + ty) * KP + tx] + kbt[((c * M + a) * TILE + tx) * KP + ty];
          T bac = T(0);
#pragma unroll
          for (int b = 0; b < M; ++b) bac = fma(Ln[a * M + b], Lp[c * M + b], bac);
          gsum = fma(s, bac, gsum);
          const T w = s * kxj;
#pragma unroll
          for (int b = 0; b < M; ++b) {
            row[a * M + b] = fma(w, Lp[c * M + b], row[a * M + b]);
            col[c * M + b] = fma(w, Ln[a * M + b], col[c * M + b]);
          }
        }
      }
      const T gk = gsum * kx;
      if (!self) {
        row[MM] = gk * fma(ln, g, lp * half_inv_b);
        col[MM] = gk * fma(lp, g, ln * half_inv_b);
      } else {
#pragma unroll
        for (int k = 0; k < MM; ++k) col[k] = T(0);
      }
    }

    // row shares: to RC columns by shuffles (none where RC == TILE), then to
    // shared memory, summed over the columns below; column sums over the
    // warp's rows by shuffles, then over the warps
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T v = row[k];
#pragma unroll
      for (int off = TILE / 2; off >= S::RC; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tx < S::RC) red_row[(ty * K + k) * S::RP + tx] = v;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T v = col[k];
#pragma unroll
      for (int off = TILE; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      col[k] = v;
    }
    if (lane < TILE) {
#pragma unroll
      for (int k = 0; k < K; ++k) red_col[(warp * TILE + lane) * K + k] = col[k];
    }
    __syncthreads();  // also: every thread is done with this stage

    const int n0 = I * TILE, p0 = J * TILE;
    for (int i = tid; i < TILE * K; i += S::THREADS) {
      const int l = i / K;
      T rs = red_row[i * S::RP];
#pragma unroll
      for (int j = 1; j < S::RC; ++j) rs += red_row[i * S::RP + j];
      T cs = red_col[i];
#pragma unroll
      for (int w = 1; w < S::WARPS; ++w) cs += red_col[w * TILE * K + i];
      if (diag) {
        if (n0 + l < n) partial[(static_cast<size_t>(I) * n + n0) * K + i] = rs + cs;
      } else {
        if (n0 + l < n) partial[(static_cast<size_t>(J) * n + n0) * K + i] = rs;
        if (p0 + l < n) partial[(static_cast<size_t>(I) * n + p0) * K + i] = cs;
      }
    }
    I = In;
    J = Jn;
  }
}

// Sums each row's slots in one fixed order: one warp per row, lane j adds
// slots j, j + 32, ... in turn, then a fixed shuffle tree adds the lanes.
// Writes ls_bar (N, M, M) and ell_bar (N,).
template <typename T, int M>
__global__ void svc_gram_tiled_bwd_reduce(const T* __restrict__ partial, int n_slots, int n,
                                          T* __restrict__ ls_bar, T* __restrict__ ell_bar) {
  constexpr int MM = M * M, K = MM + 1;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  T s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = T(0);
  for (int slot = lane; slot < n_slots; slot += 32) {
    const T* src = partial + (static_cast<size_t>(slot) * n + row) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += src[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  }
  if (lane == 0) {  // every lane holds the same sums
#pragma unroll
    for (int k = 0; k < MM; ++k) ls_bar[static_cast<size_t>(row) * MM + k] = s[k];
    ell_bar[row] = s[MM];
  }
}

// M > 8, any M: one block per row input n, no scratch and no second launch.
// For each column input p, t[a,b] = sum_c S[(n,a),(p,c)] L[p,c,b]; then
// Lbar[n,a,b] = sum_p kxj[n,p] t[a,b] and, since gsum[n,p] = sum_{a,b}
// L[n,a,b] t[a,b], lbar[n] = sum_{a,b} sum_p kx[n,p] f L[n,a,b] t[a,b].
// Thread k owns (a, b) = (k / M, k % M), then k + kThreads, ...; it walks p
// in order, c in order within p.  kxj and kx f of a chunk of kThreads column
// inputs are computed once into shared memory (the only shared memory, a
// fixed size).  Kbar and L are read through the cache: Kbar[(n,a),:] along
// the row, Kbar[:,(n,a)] down the column, so each element is read twice in
// all.  lbar's shares are summed through shared memory by a fixed tree.
// The sums run in double for either T: at large M, lbar is a small
// difference of large terms (M = 130: sums of 10^4 terms of ~10^2 that
// cancel to ~50), which float32 sums would carry with errors of 1e-4 of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
svc_gram_tiled_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                  const T* __restrict__ ls, int n, int m, T jitter,
                                  const T* __restrict__ kbar, T* __restrict__ ls_bar,
                                  T* __restrict__ ell_bar) {
  __shared__ double kxj_s[kThreads], w_s[kThreads], red[kThreads];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int mm = m * m;
  const size_t nm = static_cast<size_t>(n) * m;
  const T xn = x[row], ln = ell[row];
  const T* Ln = ls + static_cast<size_t>(row) * mm;
  const T* krow = kbar + static_cast<size_t>(row) * m * nm;  // Kbar[(n,0), :]
  const T* kcol = kbar + static_cast<size_t>(row) * m;       // Kbar[:, (n,0)]
  double lsh = 0.0;
  for (int k0 = 0; k0 < mm; k0 += kThreads) {
    const int k = k0 + tid;
    const bool own = k < mm;
    const int a = own ? k / m : 0, b = own ? k % m : 0;
    const double lnab = own ? static_cast<double>(Ln[k]) : 0.0;
    double acc = 0.0;
    for (int p0 = 0; p0 < n; p0 += kThreads) {
      __syncthreads();  // every thread is done with the previous chunk
      const int pi = p0 + tid;
      if (pi < n) {
        const T lp = ell[pi];
        const T dx = xn - x[pi];
        const T d = dx * dx;
        const T a2 = ln * ln + lp * lp;
        const T kx = gsqrt(T(2) * (ln * lp) / a2) * gexp(-d / a2);
        kxj_s[tid] = pi == row ? kx + jitter : kx;
        w_s[tid] = pi == row ? T(0) : kx * (T(1) / (T(2) * ln) - ln / a2 + T(2) * ln * d / (a2 * a2));
      }
      __syncthreads();
      if (own) {
        const int p1 = min(n, p0 + kThreads);
        for (int p = p0; p < p1; ++p) {
          const T* Lp = ls + static_cast<size_t>(p) * mm + b;
          const T* kr = krow + a * nm + static_cast<size_t>(p) * m;   // Kbar[(n,a),(p,c)] at c
          const T* kc = kcol + static_cast<size_t>(p) * m * nm + a;  // Kbar[(p,c),(n,a)] at c nm
          double t = 0.0;
          for (int c = 0; c < m; ++c) {
            const double s = static_cast<double>(__ldg(kr + c)) + static_cast<double>(__ldg(kc + c * nm));
            t = fma(s, static_cast<double>(__ldg(Lp + c * m)), t);
          }
          acc = fma(kxj_s[p - p0], t, acc);
          lsh = fma(w_s[p - p0] * lnab, t, lsh);
        }
      }
    }
    if (own) ls_bar[static_cast<size_t>(row) * mm + k] = static_cast<T>(acc);
  }
  red[tid] = lsh;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] = red[tid] + red[tid + off];
    __syncthreads();
  }
  if (tid == 0) ell_bar[row] = static_cast<T>(red[0]);
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* ell;
  const T* ls;
  int n;
  T jitter;
  const T* kbar;
  int grid;
  T* partial;
  T* ls_bar;
  T* ell_bar;
  cudaStream_t stream;
};

template <typename T, int TILE, int M>
int launch_backward_m(const BwdArgs<T>& a) {
  using S = Bwd<T, TILE, M>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svc_gram_tiled_bwd_kernel<T, TILE, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svc_gram_tiled_bwd_kernel<T, TILE, M><<<a.grid, S::THREADS, S::SMEM, a.stream>>>(
      a.x, a.ell, a.ls, a.n, a.jitter, a.kbar, a.partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kThreads / 32;
  svc_gram_tiled_bwd_reduce<T, M><<<(a.n + rows_per_block - 1) / rows_per_block, kThreads, 0, a.stream>>>(
      a.partial, (a.n + TILE - 1) / TILE, a.n, a.ls_bar, a.ell_bar);
  return static_cast<int>(cudaGetLastError());
}

// For m <= 8, tile must be the backward's tile side for m (16 for m <= 4,
// else 8), and 1 <= grid <= the number of tile pairs, which must fit an
// int.  For m > 8 (the generic route), tile = 1, grid = n and partial is
// not used; a row's (M N)-long slice of Kbar must fit an int.
template <typename T>
int launch_backward(const void* x, const void* ell, const void* ls, int n, int m,
                    double jitter, const void* kbar, int tile, int grid, void* partial,
                    void* ls_bar, void* ell_bar, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m > kMaxM) {
    if (tile != 1 || grid != n || static_cast<long long>(n) * m > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    svc_gram_tiled_bwd_generic_kernel<T><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls), n, m,
        static_cast<T>(jitter), static_cast<const T*>(kbar), static_cast<T*>(ls_bar),
        static_cast<T*>(ell_bar));
    return static_cast<int>(cudaGetLastError());
  }
  const int n_tiles = (n + tile - 1) / tile;
  if (tile != (m <= 4 ? 16 : 8) || n_tiles > 46340 || grid < 1 || grid > n_tiles * (n_tiles + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls), n,
                     static_cast<T>(jitter), static_cast<const T*>(kbar), grid, static_cast<T*>(partial),
                     static_cast<T*>(ls_bar), static_cast<T*>(ell_bar), static_cast<cudaStream_t>(stream)};
  switch (m) {
    case 1: return launch_backward_m<T, 16, 1>(a);
    case 2: return launch_backward_m<T, 16, 2>(a);
    case 3: return launch_backward_m<T, 16, 3>(a);
    case 4: return launch_backward_m<T, 16, 4>(a);
    case 5: return launch_backward_m<T, 8, 5>(a);
    case 6: return launch_backward_m<T, 8, 6>(a);
    case 7: return launch_backward_m<T, 8, 7>(a);
    default: return launch_backward_m<T, 8, 8>(a);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
// vec, rows, warps, grid: gram_kernels.k3_forward_schedule(n, m, dtype).
int svc_gram_tiled_f32(const void* x, const void* ell, const void* ls, int n, int m,
                       double jitter, int vec, int rows, int warps, int grid, void* out,
                       void* stream) {
  return launch_forward<float>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, out, stream);
}

int svc_gram_tiled_f64(const void* x, const void* ell, const void* ls, int n, int m,
                       double jitter, int vec, int rows, int warps, int grid, void* out,
                       void* stream) {
  return launch_forward<double>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, out, stream);
}

// partial: ceil(n/tile) * n * (m*m + 1) scratch values (none for m > 8);
// ls_bar (n, m, m); ell_bar (n,).  tile, grid: gram_kernels.k3_backward_schedule(n, m).
int svc_gram_tiled_backward_f32(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int grid,
                                void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<float>(x, ell, ls, n, m, jitter, kbar, tile, grid, partial,
                                ls_bar, ell_bar, stream);
}

int svc_gram_tiled_backward_f64(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int grid,
                                void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<double>(x, ell, ls, n, m, jitter, kbar, tile, grid, partial,
                                 ls_bar, ell_bar, stream);
}

}  // extern "C"
