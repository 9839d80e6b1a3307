// Gibbs (nonstationary RBF) Gram on an NVIDIA Hopper card (sm_90a).
//
//   K[i,j] = s1_i s2_j sqrt(2 l1_i l2_j / (l1_i^2 + l2_j^2))
//            * exp(-(x1_i - x2_j)^2 / (l1_i^2 + l2_j^2))  [+ jitter if i == j]
//
// Replaces the TPU kernel `gibbs_gram_pallas` (tile body `_gibbs_tile_kernel`)
// in nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py.
// The TPU kernel only had the self form (x1 == x2, jitter baked in); here the
// forward also takes the cross form (a row strip x1, s1, l1 against a column
// strip x2, s2, l2 of any lengths, no jitter: the predictive
// cross-covariance).
//
// What bounds the forward on the H100: it reads O(n1 + n2) inputs and writes
// n1 n2 outputs (8 MB at N=1000 float64, 2.4 us at 3.35 TB/s), but in float64
// each Gibbs term's exp, sqrt and two divisions cost about as much: some 8 us
// for 10^6 terms on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  Two routes,
// chosen from the shapes (gram_kernels.k1_forward_schedule):
// * Pairs (the self form where its N^2 outputs need more than one wave of
//   the threads route): the blocks walk the unordered tile pairs (I <= J) of
//   32 inputs, in the backward's row-major order, on a persistent grid of 4
//   blocks per SM.  A block stages the pair's two strips of x, s and l, and
//   each of its 256 threads evaluates 4 terms in registers: V consecutive
//   columns of 4 / V rows.  Every operation of the term is commutative in
//   (i, j), so the one evaluation of an unordered pair is also the bits of
//   (j, i): the output is exactly symmetric, with half the terms of an
//   ordered walk.  Tile (I, J) is stored from registers, V values at once,
//   lanes on neighbouring columns; tile (J, I) goes through shared memory
//   with an odd pitch and is stored the same way along its rows.  A diagonal
//   tile evaluates its upper triangle (the jitter on i == j) and stores the
//   whole tile once, its lower triangle read back transposed.  V is 2 in
//   float64 and 4 or 2 in float32 where N is divisible by it (so every row
//   offset i N + j is a multiple of V), else 1.
// * Threads (the cross form, and the self form at small N): one thread per
//   output on (32, 8) blocks, threads of a warp on neighbouring columns, so
//   every store is coalesced.  Below a full wave the kernel is bound by one
//   term's latency and the launch, and the most threads in flight win: the
//   pairs route and warp strips with wide stores (K3's design: fewer threads,
//   more registers, V terms a lane) were slower there (PERF.md).
// The ragged edge is masked.
//
// Built without fast math and with -fmad=false, so each operation rounds as
// the plain PyTorch version's separate elementwise operations do, and the
// forward equals the plain version bit for bit on the card.
//
// Backward of the self form (a second entry point; the TPU had none, XLA
// differentiated the jnp Gram).  With g_ij the Gibbs term (s = 1) and Kbar
// not assumed symmetric, S = Kbar + Kbar^T:
//
//   sbar_i = sum_j S_ij s_j g_ij
//   lbar_i = sum_j S_ij s_i s_j g_ij f_ij,  f_ij = 1/(2 l_i) - l_i/A + 2 l_i D/A^2
//
// with A = l_i^2 + l_j^2, D = (x_i - x_j)^2; f is 0 at j == i and the
// jitter carries no gradient.  What bounds it: the bytes of Kbar, read once,
// n*n*sizeof(T) (8 MB at N=1000 float64, about 2.4 us at 3.35 TB/s on an
// H100 SXM); the rest is O(n).  Beside that read, each unordered pair costs
// one float64 exp and one rsqrt and some 20 other operations, and on an
// NVIDIA H100 80GB HBM3 at 700 W those, not the read, set the time at N=1000
// (PERF.md: staging each pair in chunks to overlap the two gained
// nothing).  The design, K3's backward carried over to M = 1:
// * The blocks walk the unordered tile pairs (I <= J), row-major, in one
//   fixed order (pair q = (I, J) counted along I = 0, 1, ...; block b takes
//   q = b, b + gridDim.x, ...: a persistent grid sized from the SM count).
//   Tiles are TILE = 32 inputs a side, or 16 where that gives too few pairs
//   to fill the card (gram_kernels.k1_backward_schedule).
// * A pair stages Kbar[I,J] and Kbar[J,I] (one tile when I == J) into a
//   second shared-memory stage with element-wise cp.async while the current
//   pair computes, so each element of Kbar is read once and Kbar's row
//   stride need not be a multiple of 16 bytes.  Staged tiles have an odd
//   pitch (TILE + 1), so the transposed read has no bank conflicts in
//   float64.  The next pair's x, s, l are loaded into registers at the same
//   time and written to the stage, with 1/(2 l) and u = sqrt(sqrt(2) l),
//   once the current pair is done.
// * Each unordered input pair (i, j) is evaluated once, with one root and
//   no division: q = rsqrt(A), r = q^2, g = u_i u_j q exp(-D r), f_i =
//   1/(2 l_i) + l_i (2 D r - 1) r and f_j likewise; it adds its shares to
//   both rows i and j.  Thread t takes column t % TILE of rows t / TILE +
//   k (256 / TILE).  On a
//   diagonal tile row < column counts once and i == j once, on the row side
//   alone, with f = 0 and S = 2 Kbar_ii.
// * The result does not depend on scheduling.  A row's shares are summed
//   over its TILE lanes by a shuffle tree; a column's over a thread's rows
//   in order, over the warp's rows by shuffles, then over the warps in
//   order; both are written to fixed slots, partial[partner tile][row][2]:
//   rows of tile I to slot J, rows of tile J to slot I.  Every (slot, row)
//   is written exactly once, and a second launch sums each row's slots in
//   one fixed order (a warp per row, lanes over slots, then a shuffle tree).
//   It is a programmatic dependent launch (Hopper): its launch overlaps the
//   pair kernel's tail, and griddepcontrol.wait holds it until the partials
//   are written.  The partials are ceil(N/TILE) N 2 values: 0.5 MB at
//   N=1000 float64.
// * The ragged last tile is staged whole with x = 0, s = 0, l = 1 and
//   Kbar = 0 past N, so anything it adds is exactly 0.
// No tensor cores: wgmma has no float64 form and nothing here is a matrix
// product.  The backward is held to a tolerance and uses explicit fma().
//
// Backward of the cross form (a third entry point; the TPU had none): the
// sparse tier differentiates K_xz = K(x, l_x; z, l_z) in l on both sides
// (and the separable sparse models in s too), so it returns the four
// sums, with g_ij the Gibbs term (s = 1), f as above with A = l1_i^2 +
// l2_j^2:
//
//   s1bar_i = sum_j Kbar_ij s2_j g_ij     l1bar_i = sum_j Kbar_ij K_ij f1_ij
//   s2bar_j = sum_i Kbar_ij s1_i g_ij     l2bar_j = sum_i Kbar_ij K_ij f2_ij
//
// What bounds it: the bytes of Kbar, read once, n1 n2 sizeof(T) (1 MB at the
// sparse path's 2000 x 64 float64, 0.31 us at 3.35 TB/s); each term's exp
// and rsqrt cost less than that in float64 at these shapes, so at the
// path's size it is bound by its launches.  A simple design: each block
// takes a strip of 8, 16 or 32 rows (as many as still give every SM a
// block, gram_kernels.k1_cross_backward_schedule) and all the columns, in
// chunks of 32 along the lanes, so Kbar is read once, coalesced along its
// rows; a row is reduced in full inside its warp, a column's shares of the
// strip go to per-block partials that the self form's second launch
// (gibbs_gram_bwd_reduce, a programmatic dependent launch) sums over the
// blocks in one fixed order.  No atomics: the result does not depend on
// scheduling.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float grsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double grsqrt(double v) { return rsqrt(v); }

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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The Gibbs term of (i, j): the plain version's operations in its order.
// Each step is commutative in (i, j), so gibbs of (j, i) is the same bits.
template <typename T>
__device__ __forceinline__ T gibbs(T xi, T si, T li, T xj, T sj, T lj) {
  const T a = li * li + lj * lj;
  const T b = li * lj;
  const T dx = xi - xj;
  const T d = dx * dx;
  return (si * sj) * gsqrt(T(2) * b / a) * gexp(-d / a);
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

// The store width: the widest of 16 B whose value count divides n, so that
// every row offset i * n + j (j a multiple of V) is a multiple of V.
template <typename T>
__host__ __device__ constexpr int fwd_vec(int n) {
  return sizeof(T) == 8 ? (n % 2 == 0 ? 2 : 1) : (n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1);
}

// The pairs route's shapes for stores of V values: thread t takes columns
// c0 = (t % LANES) V .. + V - 1 of rows t / LANES + k STEP of a tile pair.
template <int V>
struct Pairs {
  static constexpr int TILE = 32;                  // inputs a tile side
  static constexpr int THREADS = TILE * TILE / 4;  // four terms a thread
  static constexpr int LANES = TILE / V;           // threads along a tile row
  static constexpr int STEP = THREADS / LANES;     // tile rows the block takes at once
  static constexpr int ROWS = TILE / STEP;         // rows a thread takes: 4 / V
  static constexpr int PITCH = TILE + 1;           // odd: the transposed reads spread over the banks
};

// Self form, pairs route: one block walks tile pairs q = blockIdx.x,
// + gridDim.x, ...; see the header.
template <typename T, int V>
__global__ void __launch_bounds__(Pairs<V>::THREADS)
gibbs_gram_pairs_kernel(const T* __restrict__ x, const T* __restrict__ s, const T* __restrict__ l,
                        int n, T jitter, T* __restrict__ out) {
  using F = Pairs<V>;
  constexpr int TILE = F::TILE;
  __shared__ T sx[2][TILE], ss[2][TILE], sl[2][TILE];  // tile I (side 0) and tile J (side 1)
  __shared__ T tile[TILE][F::PITCH];                  // tile[r][c] = K[I TILE + r, J TILE + c]
  const int tid = threadIdx.x;
  const int c0 = tid % F::LANES * V;
  const int r0 = tid / F::LANES;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  for (int q = blockIdx.x; q < n_pairs; q += gridDim.x) {
    int I, J;
    tile_pair(q, n_tiles, I, J);
    __syncthreads();  // the previous pair is done with the shared memory
    if (tid < 2 * TILE) {
      const int side = tid / TILE, e = tid % TILE;
      const int i = (side == 0 ? I : J) * TILE + e;
      const bool in = i < n;
      sx[side][e] = in ? x[i] : T(0);
      ss[side][e] = in ? s[i] : T(0);
      sl[side][e] = in ? l[i] : T(1);
    }
    __syncthreads();
    const bool diag = I == J;
    T k[F::ROWS][V];
#pragma unroll
    for (int rr = 0; rr < F::ROWS; ++rr) {
      const int r = r0 + rr * F::STEP;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = c0 + v;
        k[rr][v] = T(0);
        if (!diag || r <= c) {
          k[rr][v] = gibbs(sx[0][r], ss[0][r], sl[0][r], sx[1][c], ss[1][c], sl[1][c]);
          if (diag && r == c && jitter != T(0)) k[rr][v] = k[rr][v] + jitter;
          tile[r][c] = k[rr][v];
        }
      }
    }
    if (!diag) {  // tile (I, J) from registers
      const int j = J * TILE + c0;
#pragma unroll
      for (int rr = 0; rr < F::ROWS; ++rr) {
        const int i = I * TILE + r0 + rr * F::STEP;
        if (i < n && j < n) store_vec<T, V>(out + static_cast<size_t>(i) * n + j, k[rr]);
      }
    }
    __syncthreads();  // the pair's terms are in shared memory
    // tile (J, I), or on the diagonal tile (I, I) with its lower triangle,
    // read transposed: row R TILE + r, columns I TILE + c0 ..
    const int R = diag ? I : J;
    const int j = I * TILE + c0;
#pragma unroll
    for (int rr = 0; rr < F::ROWS; ++rr) {
      const int r = r0 + rr * F::STEP;
      const int i = R * TILE + r;
      T val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) val[v] = diag && r <= c0 + v ? k[rr][v] : tile[c0 + v][r];
      if (i < n && j < n) store_vec<T, V>(out + static_cast<size_t>(i) * n + j, val);
    }
  }
}

constexpr int kThreadsX = 32, kThreadsY = 8;  // threads route: the block

// Threads route: one thread per output (i, j), threads of a warp on
// neighbouring columns; the jitter on i == j (self form only).
template <typename T>
__global__ void gibbs_gram_threads_kernel(const T* __restrict__ x1, const T* __restrict__ s1,
                                          const T* __restrict__ l1, int n1, const T* __restrict__ x2,
                                          const T* __restrict__ s2, const T* __restrict__ l2, int n2,
                                          T jitter, T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n1 || j >= n2) return;
  T k = gibbs(x1[i], s1[i], l1[i], x2[j], s2[j], l2[j]);
  if (jitter != T(0) && i == j) k = k + jitter;
  out[static_cast<size_t>(i) * n2 + j] = k;
}

template <typename T, int V>
int launch_pairs_vec(const T* x, const T* s, const T* l, int n, T jitter, int grid, T* out, cudaStream_t stream) {
  gibbs_gram_pairs_kernel<T, V><<<grid, Pairs<V>::THREADS, 0, stream>>>(x, s, l, n, jitter, out);
  return static_cast<int>(cudaGetLastError());
}

// vec must be the store width of n, and 1 <= grid <= the number of tile
// pairs, which must fit an int.
template <typename T>
int launch_pairs(const void* x_, const void* s_, const void* l_, int n, double jitter, int vec, int grid,
                 void* out_, void* stream_) {
  const int n_tiles = (n + 31) / 32;
  if (n < 1 || n_tiles > 46340 || grid < 1 || grid > n_tiles * (n_tiles + 1) / 2 || vec != fwd_vec<T>(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const T*>(x_);
  const auto* s = static_cast<const T*>(s_);
  const auto* l = static_cast<const T*>(l_);
  auto* out = static_cast<T*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const T jit = static_cast<T>(jitter);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return launch_pairs_vec<T, 4>(x, s, l, n, jit, grid, out, stream);
  }
  if (vec == 2) return launch_pairs_vec<T, 2>(x, s, l, n, jit, grid, out, stream);
  return launch_pairs_vec<T, 1>(x, s, l, n, jit, grid, out, stream);
}

// grid must be the blocks of the (32, 8) grid, ceil(n2 / 32) * ceil(n1 / 8).
template <typename T>
int launch_threads(const void* x1, const void* s1, const void* l1, int n1, const void* x2, const void* s2,
                   const void* l2, int n2, double jitter, int grid, void* out, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 blocks((n2 + kThreadsX - 1) / kThreadsX, (n1 + kThreadsY - 1) / kThreadsY);
  if (n1 < 1 || n2 < 1 || blocks.y > 65535 ||
      static_cast<long long>(grid) != static_cast<long long>(blocks.x) * blocks.y)
    return static_cast<int>(cudaErrorInvalidValue);
  gibbs_gram_threads_kernel<T><<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(s1), static_cast<const T*>(l1), n1,
      static_cast<const T*>(x2), static_cast<const T*>(s2), static_cast<const T*>(l2), n2,
      static_cast<T>(jitter), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Backward's shapes for tiles of TILE inputs a side: thread t takes column
// c = t % TILE of rows t / TILE + k * STEP, k < ROWS.
template <int TILE>
struct Bwd {
  static constexpr int STEP = kBwdThreads / TILE;  // rows of a pair the block takes at once
  static constexpr int ROWS = TILE / STEP;         // rows of a pair a thread takes
  static constexpr int PITCH = TILE + 1;           // odd: conflict-free transposed reads
  static_assert(32 % TILE == 0 && TILE % STEP == 0, "a warp holds whole tile rows");
};

// One stage: Kbar[I,J] and Kbar[J,I], and x, s, l, 1/(2 l), sqrt(sqrt(2) l)
// of tiles I (side 0) and J (side 1).
template <typename T, int TILE>
struct BwdStage {
  T kb[2][TILE][Bwd<TILE>::PITCH];
  T x[2][TILE], s[2][TILE], l[2][TILE], h[2][TILE], u[2][TILE];
};

// Kbar's tile (row tile R, column tile C), read along Kbar's rows; the
// ragged edge is 0.
template <typename T, int TILE>
__device__ __forceinline__ void stage_kbar(T (*dst)[Bwd<TILE>::PITCH], int R, int C, int n,
                                           const T* __restrict__ kbar, int tid) {
  using B = Bwd<TILE>;
  const int r0 = R * TILE, c0 = C * TILE;
  const int c = tid % TILE;
  const bool col_ok = c0 + c < n;
#pragma unroll
  for (int k = 0; k < B::ROWS; ++k) {
    const int r = tid / TILE + k * B::STEP;
    if (col_ok && r0 + r < n)
      __pipeline_memcpy_async(&dst[r][c], kbar + static_cast<size_t>(r0 + r) * n + c0 + c, sizeof(T));
    else dst[r][c] = T(0);
  }
}

// One input of a pair's strips, held in registers between its load and its
// store: threads 0..TILE-1 take tile I, the next TILE tile J; past N, x =
// 0, s = 0, l = 1.
template <typename T, int TILE>
struct StripIn {
  T x, s, l;

  __device__ __forceinline__ void load(int I, int J, int n, const T* __restrict__ x_,
                                       const T* __restrict__ s_, const T* __restrict__ l_, int tid) {
    if (tid >= 2 * TILE) return;
    const int i = (tid < TILE ? I : J) * TILE + tid % TILE;
    const bool in = i < n;
    x = in ? x_[i] : T(0);
    s = in ? s_[i] : T(0);
    l = in ? l_[i] : T(1);
  }

  __device__ __forceinline__ void store(BwdStage<T, TILE>& st, int tid) const {
    if (tid >= 2 * TILE) return;
    const int side = tid / TILE, e = tid % TILE;
    st.x[side][e] = x;
    st.s[side][e] = s;
    st.l[side][e] = l;
    st.h[side][e] = T(1) / (T(2) * l);
    st.u[side][e] = gsqrt(T(1.4142135623730951) * l);  // u_i u_j = sqrt(2 l_i l_j)
  }
};

// One block walks tile pairs q = blockIdx.x, + gridDim.x, ...; writes
// partial[slot][row][0] = sbar's share, [1] = lbar's.
template <typename T, int TILE>
__global__ void __launch_bounds__(kBwdThreads)
gibbs_gram_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s, const T* __restrict__ l,
                      int n, const T* __restrict__ kbar, T* __restrict__ partial) {
  using B = Bwd<TILE>;
  __shared__ BwdStage<T, TILE> stages[2];
  __shared__ T red_row[TILE][2];
  __shared__ T red_col[kBwdWarps][TILE][2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int c = tid % TILE, r0 = tid / TILE;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;

  int q = blockIdx.x, I, J;
  tile_pair(q, n_tiles, I, J);
  StripIn<T, TILE> strip;
  strip.load(I, J, n, x, s, l, tid);
  stage_kbar<T, TILE>(stages[0].kb[0], I, J, n, kbar, tid);
  if (I != J) stage_kbar<T, TILE>(stages[0].kb[1], J, I, n, kbar, tid);
  __pipeline_commit();
  strip.store(stages[0], tid);
  for (int it = 0; q < n_pairs; ++it, q += gridDim.x) {
    const BwdStage<T, TILE>& st = stages[it & 1];
    BwdStage<T, TILE>& next = stages[(it + 1) & 1];
    const bool more = q + gridDim.x < n_pairs;
    int In = 0, Jn = 0;
    if (more) {
      tile_pair(q + gridDim.x, n_tiles, In, Jn);
      strip.load(In, Jn, n, x, s, l, tid);
      stage_kbar<T, TILE>(next.kb[0], In, Jn, n, kbar, tid);
      if (In != Jn) stage_kbar<T, TILE>(next.kb[1], Jn, In, n, kbar, tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this pair's copies have landed
    __syncthreads();

    const bool diag = I == J;
    const T (*kt)[B::PITCH] = st.kb[diag ? 0 : 1];  // kt[c][r] = Kbar[J*TILE + c][I*TILE + r]
    const T xj = st.x[1][c], sj = st.s[1][c], lj = st.l[1][c], hj = st.h[1][c], uj = st.u[1][c];
    T col_s = T(0), col_l = T(0);
#pragma unroll
    for (int k = 0; k < B::ROWS; ++k) {
      const int r = r0 + k * B::STEP;
      T row_s = T(0), row_l = T(0);
      if (!diag || r <= c) {
        const T xi = st.x[0][r], si = st.s[0][r], li = st.l[0][r], hi = st.h[0][r], ui = st.u[0][r];
        const T dx = xi - xj;
        const T d = dx * dx;
        const T rs = grsqrt(fma(li, li, lj * lj));  // the pair's one root, and no division
        const T ra = rs * rs;
        const T g = (ui * uj) * rs * gexp(-d * ra);  // sqrt(2 l_i l_j / A) exp(-D / A)
        const T w = (st.kb[0][r][c] + kt[c][r]) * g;
        const T e = fma(T(2) * d, ra, T(-1)) * ra;  // f = 1/(2 l) + l e
        const T wss = w * (si * sj);
        row_s = w * sj;
        if (!diag || r != c) {
          row_l = wss * fma(li, e, hi);
          col_s = fma(w, si, col_s);
          col_l = fma(wss, fma(lj, e, hj), col_l);
        }
      }
      // the row's shares over its TILE lanes; each of them ends with the sum
#pragma unroll
      for (int off = TILE / 2; off > 0; off >>= 1) {
        row_s += __shfl_xor_sync(0xffffffffu, row_s, off);
        row_l += __shfl_xor_sync(0xffffffffu, row_l, off);
      }
      if (c == 0) {
        red_row[r][0] = row_s;
        red_row[r][1] = row_l;
      }
    }
    // the column's shares over the warp's rows, then (below) over the warps
#pragma unroll
    for (int off = TILE; off < 32; off <<= 1) {
      col_s += __shfl_xor_sync(0xffffffffu, col_s, off);
      col_l += __shfl_xor_sync(0xffffffffu, col_l, off);
    }
    if ((tid & 31) < TILE) {
      red_col[warp][c][0] = col_s;
      red_col[warp][c][1] = col_l;
    }
    if (more) strip.store(next, tid);
    __syncthreads();  // also: every thread is done with this stage

    if (tid < 2 * TILE) {
      const int i = tid >> 1, v = tid & 1;
      const T rs = red_row[i][v];
      T cs = red_col[0][i][v];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) cs += red_col[w][i][v];
      const int ri = I * TILE + i, ci = J * TILE + i;
      if (diag) {
        if (ri < n) partial[(static_cast<size_t>(I) * n + ri) * 2 + v] = rs + cs;
      } else {
        if (ri < n) partial[(static_cast<size_t>(J) * n + ri) * 2 + v] = rs;
        if (ci < n) partial[(static_cast<size_t>(I) * n + ci) * 2 + v] = cs;
      }
    }
    I = In;
    J = Jn;
  }
}

// Sums each row's slots in one fixed order: one warp per row, lane j adds
// slots j, j + 32, ... in turn, then a fixed shuffle tree adds the lanes.
// Launched as a programmatic dependent of the pair kernel: it waits here
// until that grid has finished and its partials are visible.
template <typename T>
__global__ void gibbs_gram_bwd_reduce(const T* __restrict__ partial, int n_slots, int n,
                                      T* __restrict__ s_bar, T* __restrict__ l_bar) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  T vs = T(0), vl = T(0);
  for (int slot = lane; slot < n_slots; slot += 32) {
    const T* src = partial + (static_cast<size_t>(slot) * n + row) * 2;
    vs += src[0];
    vl += src[1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vs += __shfl_xor_sync(0xffffffffu, vs, off);
    vl += __shfl_xor_sync(0xffffffffu, vl, off);
  }
  if (lane == 0) {
    s_bar[row] = vs;
    l_bar[row] = vl;
  }
}

// Launches gibbs_gram_bwd_reduce over n rows of n_slots slots as a
// programmatic dependent of the kernel just launched on st: its launch
// overlaps that kernel's tail instead of following its end.
template <typename T>
int launch_reduce(const T* partial, int n_slots, int n, T* s_bar, T* l_bar, cudaStream_t st) {
  constexpr int rows_per_block = 256 / 32;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + rows_per_block - 1) / rows_per_block);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gibbs_gram_bwd_reduce<T>, partial, n_slots, n, s_bar, l_bar);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TILE>
int launch_backward_tile(const T* x, const T* s, const T* l, int n, const T* kbar, int grid,
                         T* partial, T* s_bar, T* l_bar, cudaStream_t st) {
  gibbs_gram_bwd_kernel<T, TILE><<<grid, kBwdThreads, 0, st>>>(x, s, l, n, kbar, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<T>(partial, (n + TILE - 1) / TILE, n, s_bar, l_bar, st);
}

// tile is 16 or 32, and 1 <= grid <= the number of tile pairs, which must
// fit an int.
template <typename T>
int launch_backward(const void* x, const void* s, const void* l, int n, const void* kbar,
                    int tile, int grid, void* partial, void* s_bar, void* l_bar, void* stream) {
  const int n_tiles = tile > 0 ? (n + tile - 1) / tile : 0;
  if (n < 1 || (tile != 16 && tile != 32) || n_tiles > 46340 || grid < 1 ||
      grid > n_tiles * (n_tiles + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xt = static_cast<const T*>(x);
  const auto* st = static_cast<const T*>(s);
  const auto* lt = static_cast<const T*>(l);
  const auto* kt = static_cast<const T*>(kbar);
  auto* pt = static_cast<T*>(partial);
  auto* sb = static_cast<T*>(s_bar);
  auto* lb = static_cast<T*>(l_bar);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (tile == 16) return launch_backward_tile<T, 16>(xt, st, lt, n, kt, grid, pt, sb, lb, strm);
  return launch_backward_tile<T, 32>(xt, st, lt, n, kt, grid, pt, sb, lb, strm);
}

// ---------------------------------------------------------------------------
// Backward of the cross form
// ---------------------------------------------------------------------------

// Block b takes the row strip b ROWS .. + ROWS - 1, ROWS = RPW kBwdWarps:
// warp w its rows b ROWS + w + k kBwdWarps, k < RPW, in registers (past n1:
// x = 0, s = 0, l = 1, so their shares are exactly 0).  The block walks the
// columns in chunks of 32, lane l taking column c0 + l; each term adds its
// shares to its row's accumulators (in registers, across the chunks) and to
// its column's (over the warp's rows in order, then over the warps in order
// through shared memory).  A row is whole inside one warp, so after the
// last chunk a shuffle tree over the lanes gives sbar1 and lbar1 directly;
// a column's sums are the block's partials, partial[b][column][2], which
// gibbs_gram_bwd_reduce sums over the blocks in one fixed order.
template <typename T, int RPW>
__global__ void __launch_bounds__(kBwdThreads)
gibbs_gram_cross_bwd_kernel(const T* __restrict__ x1, const T* __restrict__ s1, const T* __restrict__ l1, int n1,
                            const T* __restrict__ x2, const T* __restrict__ s2, const T* __restrict__ l2, int n2,
                            const T* __restrict__ kbar, T* __restrict__ s1_bar, T* __restrict__ l1_bar,
                            T* __restrict__ partial) {
  constexpr int ROWS = RPW * kBwdWarps;
  __shared__ T red[kBwdWarps][32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T xi[RPW], si[RPW], li[RPW], hi[RPW], ui[RPW], acc_s[RPW], acc_l[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int i = blockIdx.x * ROWS + warp + k * kBwdWarps;
    const bool in = i < n1;
    xi[k] = in ? x1[i] : T(0);
    si[k] = in ? s1[i] : T(0);
    li[k] = in ? l1[i] : T(1);
    hi[k] = T(1) / (T(2) * li[k]);
    ui[k] = gsqrt(T(1.4142135623730951) * li[k]);  // u_i u_j = sqrt(2 l_i l_j)
    acc_s[k] = T(0);
    acc_l[k] = T(0);
  }
  for (int c0 = 0; c0 < n2; c0 += 32) {
    const int j = c0 + lane;
    const bool col_in = j < n2;
    const T xj = col_in ? x2[j] : T(0), sj = col_in ? s2[j] : T(0), lj = col_in ? l2[j] : T(1);
    const T hj = T(1) / (T(2) * lj), uj = gsqrt(T(1.4142135623730951) * lj);
    T col_s = T(0), col_l = T(0);
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int i = blockIdx.x * ROWS + warp + k * kBwdWarps;
      const T kb = col_in && i < n1 ? kbar[static_cast<size_t>(i) * n2 + j] : T(0);
      const T dx = xi[k] - xj;
      const T d = dx * dx;
      const T rs = grsqrt(fma(li[k], li[k], lj * lj));  // the term's one root, and no division
      const T ra = rs * rs;
      const T w = kb * ((ui[k] * uj) * rs * gexp(-d * ra));  // Kbar_ij g_ij
      const T e = fma(T(2) * d, ra, T(-1)) * ra;            // f = 1/(2 l) + l e
      const T wss = w * (si[k] * sj);
      acc_s[k] = fma(w, sj, acc_s[k]);
      acc_l[k] = fma(wss, fma(li[k], e, hi[k]), acc_l[k]);
      col_s = fma(w, si[k], col_s);
      col_l = fma(wss, fma(lj, e, hj), col_l);
    }
    red[warp][lane][0] = col_s;
    red[warp][lane][1] = col_l;
    __syncthreads();
    if (warp == 0 && col_in) {
      T cs = red[0][lane][0], cl = red[0][lane][1];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) {
        cs += red[w][lane][0];
        cl += red[w][lane][1];
      }
      partial[(static_cast<size_t>(blockIdx.x) * n2 + j) * 2] = cs;
      partial[(static_cast<size_t>(blockIdx.x) * n2 + j) * 2 + 1] = cl;
    }
    __syncthreads();  // red is free for the next chunk
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    T vs = acc_s[k], vl = acc_l[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vs += __shfl_xor_sync(0xffffffffu, vs, off);
      vl += __shfl_xor_sync(0xffffffffu, vl, off);
    }
    const int i = blockIdx.x * ROWS + warp + k * kBwdWarps;
    if (lane == 0 && i < n1) {
      s1_bar[i] = vs;
      l1_bar[i] = vl;
    }
  }
}

template <typename T, int RPW>
int launch_cross_backward_rpw(const T* x1, const T* s1, const T* l1, int n1, const T* x2, const T* s2, const T* l2,
                              int n2, const T* kbar, int grid, T* partial, T* s1_bar, T* l1_bar, T* s2_bar,
                              T* l2_bar, cudaStream_t st) {
  gibbs_gram_cross_bwd_kernel<T, RPW><<<grid, kBwdThreads, 0, st>>>(x1, s1, l1, n1, x2, s2, l2, n2, kbar, s1_bar,
                                                                     l1_bar, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<T>(partial, grid, n2, s2_bar, l2_bar, st);
}

// rows_per_warp is 1, 2 or 4, and grid must be ceil(n1 / (8 rows_per_warp)).
template <typename T>
int launch_cross_backward(const void* x1, const void* s1, const void* l1, int n1, const void* x2, const void* s2,
                          const void* l2, int n2, const void* kbar, int rows_per_warp, int grid, void* partial,
                          void* s1_bar, void* l1_bar, void* s2_bar, void* l2_bar, void* stream) {
  const int rows = rows_per_warp * kBwdWarps;
  if (n1 < 1 || n2 < 1 || (rows_per_warp != 1 && rows_per_warp != 2 && rows_per_warp != 4) ||
      grid != (n1 + rows - 1) / rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const T*>(x1);
  const auto* b = static_cast<const T*>(s1);
  const auto* c = static_cast<const T*>(l1);
  const auto* d = static_cast<const T*>(x2);
  const auto* e = static_cast<const T*>(s2);
  const auto* f = static_cast<const T*>(l2);
  const auto* kb = static_cast<const T*>(kbar);
  auto* pt = static_cast<T*>(partial);
  auto* sb1 = static_cast<T*>(s1_bar);
  auto* lb1 = static_cast<T*>(l1_bar);
  auto* sb2 = static_cast<T*>(s2_bar);
  auto* lb2 = static_cast<T*>(l2_bar);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_warp == 4)
    return launch_cross_backward_rpw<T, 4>(a, b, c, n1, d, e, f, n2, kb, grid, pt, sb1, lb1, sb2, lb2, st);
  if (rows_per_warp == 2)
    return launch_cross_backward_rpw<T, 2>(a, b, c, n1, d, e, f, n2, kb, grid, pt, sb1, lb1, sb2, lb2, st);
  return launch_cross_backward_rpw<T, 1>(a, b, c, n1, d, e, f, n2, kb, grid, pt, sb1, lb1, sb2, lb2, st);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 on success).
// Self form, pairs route: vec, grid from gram_kernels.k1_forward_schedule(n, n, True, dtype).
int gibbs_gram_pairs_f32(const void* x, const void* s, const void* l, int n, double jitter, int vec, int grid,
                         void* out, void* stream) {
  return launch_pairs<float>(x, s, l, n, jitter, vec, grid, out, stream);
}

int gibbs_gram_pairs_f64(const void* x, const void* s, const void* l, int n, double jitter, int vec, int grid,
                         void* out, void* stream) {
  return launch_pairs<double>(x, s, l, n, jitter, vec, grid, out, stream);
}

// Threads route (the cross form, and the self form at small N, with
// x2 = x1 ...): grid from gram_kernels.k1_forward_schedule; jitter 0 for
// the cross form.
int gibbs_gram_threads_f32(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                           const void* s2, const void* l2, int n2, double jitter, int grid, void* out,
                           void* stream) {
  return launch_threads<float>(x1, s1, l1, n1, x2, s2, l2, n2, jitter, grid, out, stream);
}

int gibbs_gram_threads_f64(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                           const void* s2, const void* l2, int n2, double jitter, int grid, void* out,
                           void* stream) {
  return launch_threads<double>(x1, s1, l1, n1, x2, s2, l2, n2, jitter, grid, out, stream);
}

// Self-form backward.  partial: ceil(n/tile) * n * 2 scratch values; s_bar,
// l_bar (n,).  tile, grid: gram_kernels.k1_backward_schedule(n).
int gibbs_gram_backward_f32(const void* x, const void* s, const void* l, int n,
                            const void* kbar, int tile, int grid, void* partial, void* s_bar,
                            void* l_bar, void* stream) {
  return launch_backward<float>(x, s, l, n, kbar, tile, grid, partial, s_bar, l_bar, stream);
}

int gibbs_gram_backward_f64(const void* x, const void* s, const void* l, int n,
                            const void* kbar, int tile, int grid, void* partial, void* s_bar,
                            void* l_bar, void* stream) {
  return launch_backward<double>(x, s, l, n, kbar, tile, grid, partial, s_bar, l_bar, stream);
}

// Cross-form backward.  partial: grid * n2 * 2 scratch values; s1_bar,
// l1_bar (n1,), s2_bar, l2_bar (n2,).  rows_per_warp, grid:
// gram_kernels.k1_cross_backward_schedule(n1, n2).
int gibbs_gram_cross_backward_f32(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                                  const void* s2, const void* l2, int n2, const void* kbar, int rows_per_warp,
                                  int grid, void* partial, void* s1_bar, void* l1_bar, void* s2_bar, void* l2_bar,
                                  void* stream) {
  return launch_cross_backward<float>(x1, s1, l1, n1, x2, s2, l2, n2, kbar, rows_per_warp, grid, partial, s1_bar,
                                      l1_bar, s2_bar, l2_bar, stream);
}

int gibbs_gram_cross_backward_f64(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                                  const void* s2, const void* l2, int n2, const void* kbar, int rows_per_warp,
                                  int grid, void* partial, void* s1_bar, void* l1_bar, void* s2_bar, void* l2_bar,
                                  void* stream) {
  return launch_cross_backward<double>(x1, s1, l1, n1, x2, s2, l2, n2, kbar, rows_per_warp, grid, partial, s1_bar,
                                       l1_bar, s2_bar, l2_bar, stream);
}

}  // extern "C"
