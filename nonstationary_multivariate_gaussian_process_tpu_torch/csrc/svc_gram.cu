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
// * M > 4 takes the generic route, with M at run time.  There a lane cannot
//   keep V M^2 values of L in registers, and a tile of the flattened output
//   (K3's generic walk) would cover one task pair, so each Gibbs term would
//   be evaluated M^2 times.  So the route tiles the input pairs instead:
//   - A unit of work is a tile of 64 x 64 input pairs (n, p) and a group of
//     row tasks a by a group of column tasks c.  One block of 16 x 16
//     threads takes units blockIdx.x, + gridDim.x, ... (a persistent grid;
//     the groups and the grid: gram_kernels.k2_schedule).
//   - Thread (ty, tx) owns rows n0 + 4 ty .. + 3 and 4 columns (two 16-B
//     groups, p0 + 2 tx and p0 + 2 tx + 32, in float64; p0 + 4 tx in
//     float32).  It evaluates its 16 Gibbs terms once a unit, the jitter on
//     n == p, and keeps them in registers across every task pair of the unit.
//   - The block stages its rows' L[n, a, :] and its columns' L[p, c, :] for
//     the unit's tasks in shared memory, transposed to [task][b][input], so a
//     thread's 4 values for one b arrive in one or two 16-B loads.  A block
//     stages (row tasks + column tasks) b_chunk 68 w bytes, within half an
//     SM's shared memory (two blocks an SM) at every M.  Where two whole
//     tasks do not fit (M > 106 in float64, 212 in float32), the CHUNKED
//     variant takes one task pair a unit and stages its b range b_chunk
//     values at a time, its 4 x 4 sums kept in registers across the chunks
//     and its Gibbs terms evaluated after them.  Inputs past N are not
//     staged.
//   - For each (a, c) it sums b = 0..M-1 over its 4 x 4 pairs and stores
//     row a*N + n, columns c*N + p .., V values at once: each store
//     instruction of a warp writes two rows' 256 contiguous bytes.
//   The bound is the bytes written, (N M)^2 w, against 2 M operations an
//   output (each multiply and add on its own, -fmad=false).
// The ragged edge is masked.  Values never depend on the schedule.
//
// Built without fast math and with -fmad=false: the task sum runs b = 0..M-1
// in the plain version's order, each operation rounded on its own, so the
// kernel equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 4;          // the largest M of the templated route
constexpr int kMaxThreads = 256;  // templated route: at most 8 warps a block
// The generic route (M > 4): tiles of input pairs, staged L, 4 x 4 pairs a thread.
constexpr int kGenTile = 64;             // row (and column) inputs of a tile
constexpr int kGenPitch = kGenTile + 4;  // a staged [task][b] row of L (16-B aligned in either type)
constexpr int kGenThreads = 256;         // 16 x 16 threads
constexpr size_t kMaxSmem = 232448;      // a block's shared memory on the H100 (227 KB)

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

// The generic route: thread column tx's 4 columns of a tile, two 16-B groups
// of 2 in float64 (2 tx, 2 tx + 1, 2 tx + 32, 2 tx + 33), one of 4 in float32.
template <typename T>
__device__ __forceinline__ int gen_col(int tx, int j) {
  constexpr int cw = 16 / sizeof(T);
  return cw * tx + 16 * cw * (j / cw) + j % cw;
}

// One b of a task pair: a thread's 4 row values and 4 column values of L, as
// 16-B loads from the staged rows (Ra) and columns (Cc), into its 4 x 4 sums.
template <typename T, bool FIRST>
__device__ __forceinline__ void gen_step(const T* __restrict__ Ra, const T* __restrict__ Cc, int ty, int tx,
                                         T (&acc)[4][4]) {
  T r[4], c[4];
  if constexpr (sizeof(T) == 8) {
    const double2 r0 = *reinterpret_cast<const double2*>(Ra + 4 * ty);
    const double2 r1 = *reinterpret_cast<const double2*>(Ra + 4 * ty + 2);
    const double2 c0 = *reinterpret_cast<const double2*>(Cc + 2 * tx);
    const double2 c1 = *reinterpret_cast<const double2*>(Cc + 2 * tx + 32);
    r[0] = r0.x, r[1] = r0.y, r[2] = r1.x, r[3] = r1.y;
    c[0] = c0.x, c[1] = c0.y, c[2] = c1.x, c[3] = c1.y;
  } else {
    const float4 r0 = *reinterpret_cast<const float4*>(Ra + 4 * ty);
    const float4 c0 = *reinterpret_cast<const float4*>(Cc + 4 * tx);
    r[0] = r0.x, r[1] = r0.y, r[2] = r0.z, r[3] = r0.w;
    c[0] = c0.x, c[1] = c0.y, c[2] = c0.z, c[3] = c0.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = FIRST ? r[i] * c[j] : acc[i][j] + r[i] * c[j];
}

// Stage `width` values a row input of L for inputs base .. base + count - 1,
// from flat value t0 * m + k0 of each, transposed: S[j * kGenPitch + r].
template <typename T>
__device__ __forceinline__ void gen_stage(T* __restrict__ S, const T* __restrict__ ls, int base, int count, int m,
                                          int t0, int k0, int width, int tid) {
  for (int i = tid; i < count * width; i += kGenThreads) {
    const int r = i / width, j = i % width;  // consecutive threads: consecutive (task, b) of one input
    S[j * kGenPitch + r] = ls[(static_cast<size_t>(base + r) * m + t0) * m + k0 + j];
  }
}

// A thread's 16 Gibbs terms, the jitter on n == p (0 past N).
template <typename T>
__device__ __forceinline__ void gen_gibbs(const T* __restrict__ x, const T* __restrict__ ell, int n, int n0, int p0,
                                          int ty, int tx, T jitter, T (&kx)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + gen_col<T>(tx, j);
      T k = T(0);
      if (r < n && p < n) {
        k = gibbs(x[r], ell[r], x[p], ell[p]);
        if (r == p) k = k + jitter;
      }
      kx[i][j] = k;
    }
  }
}

// A task pair's outputs of a thread, kx * acc, to its rows from orow (row
// n0 + 4 ty, column c*N + p0), V values a store; V divides N and 16 B, so a
// group never crosses the edge.
template <typename T, int V>
__device__ __forceinline__ void gen_store(T* __restrict__ orow, int n, size_t nm, int n0, int p0, int ty, int tx,
                                          const T (&kx)[4][4], const T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (n0 + 4 * ty + i >= n) break;
#pragma unroll
    for (int j = 0; j < 4; j += V) {
      const int lc = gen_col<T>(tx, j);
      if (p0 + lc >= n) continue;
      T val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) val[v] = kx[i][j + v] * acc[i][j + v];
      store_vec<T, V>(orow + i * nm + lc, val);
    }
  }
}

// M > 4, M at run time: a persistent walk of units (a tile of 64 x 64 input
// pairs, a group of row tasks, a group of column tasks); see the header.
// CHUNKED: one row and one column task a unit, b staged b_chunk values at a
// time, the sums kept across the chunks; else every task of the unit staged
// whole (b_chunk = m).
template <typename T, int V, bool CHUNKED>
__global__ void __launch_bounds__(kGenThreads, 2)
svc_gram_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell, const T* __restrict__ ls, int n,
                        int m, int row_tasks, int col_tasks, int b_chunk, int n_units, T jitter,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Rs = reinterpret_cast<T*>(smem);              // [q][b][row]: L[n0 + row, a0 + q, k0 + b]
  T* Cs = Rs + row_tasks * b_chunk * kGenPitch;    // [q][b][col]: L[p0 + col, c0 + q, k0 + b]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles = (n + kGenTile - 1) / kGenTile;
  const int a_groups = (m + row_tasks - 1) / row_tasks, c_groups = (m + col_tasks - 1) / col_tasks;
  const size_t nm = static_cast<size_t>(n) * m;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int ic = u % c_groups, ia = u / c_groups % a_groups, tile = u / c_groups / a_groups;
    const int n0 = tile / tiles * kGenTile, p0 = tile % tiles * kGenTile;
    const int a0 = ia * row_tasks, c0 = ic * col_tasks;
    // inputs past N are not staged: what their threads read there is never stored
    const int rn = min(kGenTile, n - n0), cn = min(kGenTile, n - p0);
    T kx[4][4];  // the thread's Gibbs terms, jitter on n == p, for every task pair of the unit
    if constexpr (CHUNKED) {
      T acc[4][4];
      for (int k0 = 0; k0 < m; k0 += b_chunk) {
        const int kb = min(b_chunk, m - k0);
        __syncthreads();  // every thread is done with the previous chunk's (or unit's) staged L
        gen_stage(Rs, ls, n0, rn, m, a0, k0, kb, tid);
        gen_stage(Cs, ls, p0, cn, m, c0, k0, kb, tid);
        __syncthreads();
        if (k0 == 0) {
          gen_step<T, true>(Rs, Cs, ty, tx, acc);
        } else {
          gen_step<T, false>(Rs, Cs, ty, tx, acc);
        }
#pragma unroll 1  // as below
        for (int b = 1; b < kb; ++b) gen_step<T, false>(Rs + b * kGenPitch, Cs + b * kGenPitch, ty, tx, acc);
      }
      // the Gibbs terms once the sums are done: live beside them only here, so nothing spills
      gen_gibbs(x, ell, n, n0, p0, ty, tx, jitter, kx);
      gen_store<T, V>(out + (static_cast<size_t>(a0) * n + n0 + 4 * ty) * nm + static_cast<size_t>(c0) * n + p0, n,
                      nm, n0, p0, ty, tx, kx, acc);
    } else {
      const int rw = min(row_tasks, m - a0) * m, cw = min(col_tasks, m - c0) * m;  // staged values an input
      __syncthreads();  // every thread is done with the previous unit's staged L
      gen_stage(Rs, ls, n0, rn, m, a0, 0, rw, tid);
      gen_stage(Cs, ls, p0, cn, m, c0, 0, cw, tid);
      gen_gibbs(x, ell, n, n0, p0, ty, tx, jitter, kx);
      __syncthreads();
      for (int qa = 0; qa < rw / m; ++qa) {
        const T* Ra = Rs + qa * m * kGenPitch;
        T* rows = out + (static_cast<size_t>(a0 + qa) * n + n0 + 4 * ty) * nm + p0;
        for (int qc = 0; qc < cw / m; ++qc) {
          const T* Cc = Cs + qc * m * kGenPitch;
          T acc[4][4];
          gen_step<T, true>(Ra, Cc, ty, tx, acc);
#pragma unroll 1  // unrolled, the next b's loads spill in float64 (128 registers at 2 blocks an SM)
          for (int b = 1; b < m; ++b) gen_step<T, false>(Ra + b * kGenPitch, Cc + b * kGenPitch, ty, tx, acc);
          gen_store<T, V>(rows + static_cast<size_t>(c0 + qc) * n, n, nm, n0, p0, ty, tx, kx, acc);
        }
      }
    }
  }
}

template <typename T, int V, bool CHUNKED>
int launch_generic(const T* x, const T* ell, const T* ls, int n, int m, int row_tasks, int col_tasks, int b_chunk,
                   int n_units, T jitter, int grid, size_t smem, T* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(svc_gram_generic_kernel<T, V, CHUNKED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svc_gram_generic_kernel<T, V, CHUNKED><<<grid, kGenThreads, smem, stream>>>(x, ell, ls, n, m, row_tasks,
                                                                              col_tasks, b_chunk, n_units, jitter,
                                                                              out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_generic_b(const T* x, const T* ell, const T* ls, int n, int m, int row_tasks, int col_tasks, int b_chunk,
                     int n_units, T jitter, int grid, size_t smem, T* out, cudaStream_t stream) {
  if (b_chunk < m)
    return launch_generic<T, V, true>(x, ell, ls, n, m, row_tasks, col_tasks, b_chunk, n_units, jitter, grid, smem,
                                      out, stream);
  return launch_generic<T, V, false>(x, ell, ls, n, m, row_tasks, col_tasks, b_chunk, n_units, jitter, grid, smem,
                                     out, stream);
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
// grid >= 1, the items must fit an int, and row_tasks = col_tasks = b_chunk =
// 0.  For m > 4 (the generic route): vec the store width of n, rows = 64 (a
// tile's inputs), warps = 8, 1 <= row_tasks, col_tasks <= m, 1 <= b_chunk <=
// m (below m only with one row and one column task), their staged L within a
// block's shared memory, the units within an int, and grid >= 1.
template <typename T>
int launch(const void* x_, const void* ell_, const void* ls_, int n, int m, double jitter_, int vec,
           int rows, int warps, int grid, int row_tasks, int col_tasks, int b_chunk, void* out_, void* stream_) {
  const T* x = static_cast<const T*>(x_);
  const T* ell = static_cast<const T*>(ell_);
  const T* ls = static_cast<const T*>(ls_);
  const T jitter = static_cast<T>(jitter_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n < 1 || m < 1 || grid < 1 || vec != store_width<T>(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (m > kMaxM) {
    const long long tiles = (n + kGenTile - 1) / kGenTile;
    if (rows != kGenTile || warps * 32 != kGenThreads || row_tasks < 1 || row_tasks > m || col_tasks < 1 ||
        col_tasks > m || b_chunk < 1 || b_chunk > m || (b_chunk < m && (row_tasks != 1 || col_tasks != 1)))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long units = tiles * tiles * ((m + row_tasks - 1) / row_tasks) * ((m + col_tasks - 1) / col_tasks);
    const size_t smem = sizeof(T) * static_cast<size_t>(row_tasks + col_tasks) * b_chunk * kGenPitch;
    if (units > 0x7fffffff || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const int n_units = static_cast<int>(units);
    if constexpr (sizeof(T) == 4) {
      if (vec == 4)
        return launch_generic_b<T, 4>(x, ell, ls, n, m, row_tasks, col_tasks, b_chunk, n_units, jitter, grid, smem,
                                      out, stream);
    }
    if (vec == 2)
      return launch_generic_b<T, 2>(x, ell, ls, n, m, row_tasks, col_tasks, b_chunk, n_units, jitter, grid, smem,
                                    out, stream);
    return launch_generic_b<T, 1>(x, ell, ls, n, m, row_tasks, col_tasks, b_chunk, n_units, jitter, grid, smem, out,
                                  stream);
  }
  if (row_tasks != 0 || col_tasks != 0 || b_chunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows < 1 || warps < 1 || warps * 32 > kMaxThreads)
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
// vec, rows, warps, grid, row_tasks, col_tasks, b_chunk: gram_kernels.k2_schedule(n, m, dtype).
int svc_gram_f32(const void* x, const void* ell, const void* ls, int n, int m, double jitter, int vec,
                 int rows, int warps, int grid, int row_tasks, int col_tasks, int b_chunk, void* out, void* stream) {
  return launch<float>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, row_tasks, col_tasks, b_chunk, out,
                       stream);
}

int svc_gram_f64(const void* x, const void* ell, const void* ls, int n, int m, double jitter, int vec,
                 int rows, int warps, int grid, int row_tasks, int col_tasks, int b_chunk, void* out, void* stream) {
  return launch<double>(x, ell, ls, n, m, jitter, vec, rows, warps, grid, row_tasks, col_tasks, b_chunk, out,
                        stream);
}

}  // extern "C"
