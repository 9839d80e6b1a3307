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
// sparse path's 2000 x 64 float64, 0.31 us at 3.35 TB/s; 10.2 MB, 3.06 us at
// the N = 20,000 rate's 20,000 x 64).  A term's float64 exp, rsqrt and some
// 20 other operations take longer than its 8 bytes on an NVIDIA H100 80GB
// HBM3 at 700 W, and at the sparse path's size one launch's fixed cost and
// one chain of latencies dominate (PERF.md).  The design, one launch
// (gram_kernels.k1_cross_backward_schedule):
// * Block (s, g) (8 warps) takes row strip s and column group g: a
//   contiguous strip of rows, staged once in shared memory with 1/(2 l)
//   and sqrt(sqrt(2) l), against a contiguous run of column chunks of 64,
//   two columns a lane, so Kbar is read once, coalesced along its rows.  A
//   warp evaluates its rows four at a time (8 independent terms a lane)
//   and loads the next rows' Kbar while it computes; every load of the
//   first rows is issued before any arithmetic.
// * Strips are as short as fill the card once (32 rows a block below
//   4,224 rows); where that leaves SMs idle and the columns make more than
//   one chunk, the columns are cut into groups, so a short or wide Kbar
//   still gives every SM a block.
// * A row is reduced inside its warp: a row's shares over the lane's two
//   columns, then over the lanes by halving exchanges that reduce the four
//   rows' two sums together (9 shuffles of a value where shuffle trees take
//   40), into the row's sums in shared memory; a later chunk adds to them
//   in chunk order.  With one column group they are written out; with
//   several, each group's go to a row slot.
// * A column's shares stay in the lane's registers across every row of its
//   warp; once a chunk, the block adds its 8 warps' in order and writes the
//   strip's column slot once.
// * Both finish in the same launch: a block takes a ticket of its column
//   group and (with several groups) one of its strip (atomicInc with
//   release and acquire at device scope, which wraps back to 0).  The
//   block with a group's last ticket sums the group's column slots in strip
//   order and writes s2bar, l2bar; the one with a strip's last ticket sums
//   its row slots in group order and writes s1bar, l1bar.  No
//   floating-point atomics: the result does not depend on which block
//   finishes last, and two launches on the same inputs are bit-equal.  The
//   wrapper allocates the slots and keeps the tickets, per device and
//   stream, which the kernel leaves at 0.
// * Rows past n1 are staged with x = 0, s = 0, l = 1 and columns past n2
//   read x = 0, s = 0, l = 1, with Kbar = 0 past either, so what they add is
//   exactly 0.
// Thread-block clusters that first add their blocks' column slots through
// distributed shared memory were measured and dropped: their barriers cost
// more than they saved in the last block's sum (PERF.md).

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

constexpr int kXThreads = 256;                 // 8 warps
constexpr int kXWarps = kXThreads / 32;
constexpr int kXGroup = 4;                     // rows a warp evaluates at once
constexpr int kXCols = 2;                      // columns a lane takes in a chunk
constexpr int kXChunk = 32 * kXCols;           // columns of a chunk
constexpr int kXMaxRows = kXThreads;           // the tallest strip: a thread stages at most one row
constexpr int kXSmemPerRow = 7;                // x, s, l, 1/(2 l), sqrt(sqrt(2) l) and the two row sums
constexpr int kXSlotBatch = 32;                // slots the last block loads at once
static_assert(2 * kXChunk <= kXThreads, "a thread for each (column, sum) of a chunk");
static_assert(kXWarps * 2 * kXChunk >= 4 * kXThreads, "red holds 4 accumulators a thread");

// The N = 2 kXGroup shares v[2 g + t] (row g of a group, t = 0 for sbar1,
// 1 for lbar1) summed over the warp's 32 lanes.  Halving exchanges with the lanes
// 16, 8, ... apart leave each lane one value, and shuffles finish it; every
// sum pairs the same lanes as a shuffle tree over offsets 16, 8, 4, 2, 1,
// so each result is that tree's.  Lane l returns the sum of v[l / (32 / N)]
// (lanes 0, 32 / N, ... hold the N sums).
template <typename T, int N>
__device__ __forceinline__ T lane_sum(T (&v)[N], int lane) {
  int o = 16;
#pragma unroll
  for (int m = N / 2; m >= 1; m /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < m; ++k) v[k] = (up ? v[m + k] : v[k]) + __shfl_xor_sync(0xffffffffu, up ? v[k] : v[m + k], o);
  }
  T c = v[0];
#pragma unroll
  for (; o > 0; o /= 2) c += __shfl_xor_sync(0xffffffffu, c, o);
  return c;
}

// This lane's columns c0 + lane + 32 v of x2, s2, l2; past n2, x = 0, s = 0, l = 1.
template <typename T>
__device__ __forceinline__ void load_cols(T (&cx)[kXCols], T (&cs)[kXCols], T (&cl)[kXCols],
                                          const T* __restrict__ x2, const T* __restrict__ s2,
                                          const T* __restrict__ l2, int c0, int n2, int lane) {
#pragma unroll
  for (int v = 0; v < kXCols; ++v) {
    const int j = c0 + lane + 32 * v;
    const bool in = j < n2;
    cx[v] = in ? x2[j] : T(0);
    cs[v] = in ? s2[j] : T(0);
    cl[v] = in ? l2[j] : T(1);
  }
}

// Kbar of rows i0 .. i0 + kXGroup - 1, this lane's columns c0 + lane + 32 v;
// 0 past n1 and n2.
template <typename T>
__device__ __forceinline__ void load_group(T (&kb)[kXGroup][kXCols], const T* __restrict__ kbar, int i0, int n1,
                                           int c0, int n2, int lane) {
#pragma unroll
  for (int g = 0; g < kXGroup; ++g) {
#pragma unroll
    for (int v = 0; v < kXCols; ++v) {
      const int i = i0 + g, j = c0 + lane + 32 * v;
      kb[g][v] = i < n1 && j < n2 ? kbar[static_cast<size_t>(i) * n2 + j] : T(0);
    }
  }
}

// One ticket of n: atomicInc (wrapping to 0 after the last) with release and
// acquire at device scope, taken after the barrier that follows the block's
// slot writes: it publishes them and, for the last, makes every other
// block's visible.  True for the last.
__device__ __forceinline__ bool take_ticket(unsigned int* ticket, unsigned int n) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;" : "=r"(old) : "l"(ticket), "r"(n - 1) : "memory");
  return old == n - 1;
}

// Block b takes row strip s = b / col_groups, rows s rows .. + rows - 1,
// staged in shared memory (x = 0, s = 0, l = 1 past n1, so its shares are
// exactly 0), and column group g = b % col_groups, the chunks g per ..
// g per + per - 1 of kXChunk columns (per = ceil(chunks / col_groups));
// warp w takes its rows w rows / 8 + k, in groups of kXGroup, lane l of a
// chunk c0 its columns c0 + l + 32 v (x = 0, s = 0, l = 1 and Kbar = 0 past
// n2).  Every load of the first group is issued before any arithmetic;
// after that, each group's Kbar (and at a chunk's last group the next
// chunk's columns) is loaded while the group before it computes.  A row's
// shares are summed over the lane's columns, then over the lanes
// (lane_sum), into the row's sums in shared memory (the group's first chunk
// stores, a later one adds, in chunk order); with one column group they
// are written out, else to row slot rslots[g][row][2].  A column's shares
// stay in the lane's registers across every row of the warp, in order;
// once a chunk, the block adds its 8 warps' in order into column slot
// slots[s][column][2], written once.  Then the tickets (tickets[g] of the
// n_strips blocks of group g, and with several groups tickets[col_groups +
// s] of strip s's col_groups blocks): a strip's last sums its row slots in
// group order, a group's last its column slots in strip order (below).  No
// floating-point atomics: the result does not depend on which block
// finishes last.
template <typename T>
__global__ void __launch_bounds__(kXThreads)
gibbs_gram_cross_bwd_kernel(const T* __restrict__ x1, const T* __restrict__ s1, const T* __restrict__ l1, int n1,
                            const T* __restrict__ x2, const T* __restrict__ s2, const T* __restrict__ l2, int n2,
                            const T* __restrict__ kbar, int rows, int col_groups, T* __restrict__ slots,
                            unsigned int* __restrict__ tickets, T* __restrict__ s1_bar, T* __restrict__ l1_bar,
                            T* __restrict__ s2_bar, T* __restrict__ l2_bar) {
  extern __shared__ __align__(16) unsigned char x_smem[];
  T* const sx = reinterpret_cast<T*>(x_smem);
  T* const ss = sx + rows;
  T* const sl = ss + rows;
  T* const sh = sl + rows;
  T* const su = sh + rows;
  T* const srs = su + rows;  // the strip's sbar1
  T* const srl = srs + rows;  // and lbar1
  __shared__ T red[kXWarps][2 * kXChunk];  // the warps' column shares of a chunk, [warp][2 column + t]
  __shared__ bool last_col, last_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x / col_groups, cgrp = blockIdx.x % col_groups;
  const int r0 = strip * rows;
  const int per = ((n2 + kXChunk - 1) / kXChunk + col_groups - 1) / col_groups;  // chunks a column group
  const int c_begin = cgrp * per * kXChunk, c_end = min(n2, c_begin + per * kXChunk);
  const int per_warp = rows / kXWarps;
  const int w0 = warp * per_warp;  // the warp's first row in the strip
  // the first group's loads, all at once: this thread's staged row, its
  // columns of the first chunk, the first group's Kbar
  const int i_st = r0 + tid;
  const bool st_in = tid < rows && i_st < n1;
  const T x_st = st_in ? x1[i_st] : T(0), s_st = st_in ? s1[i_st] : T(0), l_st = st_in ? l1[i_st] : T(1);
  T cx[kXCols], cs[kXCols], cl[kXCols];
  load_cols(cx, cs, cl, x2, s2, l2, c_begin, n2, lane);
  T kb[kXGroup][kXCols];
  load_group(kb, kbar, r0 + w0, n1, c_begin, n2, lane);
  if (tid < rows) {
    sx[tid] = x_st;
    ss[tid] = s_st;
    sl[tid] = l_st;
    sh[tid] = T(1) / (T(2) * l_st);
    su[tid] = gsqrt(T(1.4142135623730951) * l_st);  // u_i u_j = sqrt(2 l_i l_j)
  }
  T xj[kXCols], sj[kXCols], lj[kXCols], lj2[kXCols], hj[kXCols], uj[kXCols];
  const auto column_setup = [&]() {  // this lane's columns of a chunk, from cx, cs, cl
#pragma unroll
    for (int v = 0; v < kXCols; ++v) {
      xj[v] = cx[v];
      sj[v] = cs[v];
      lj[v] = cl[v];
      lj2[v] = lj[v] * lj[v];
      hj[v] = T(1) / (T(2) * lj[v]);
      uj[v] = gsqrt(T(1.4142135623730951) * lj[v]);
    }
  };
  column_setup();
  __syncthreads();  // the strip is staged (its setup ran beside the columns')
  for (int c0 = c_begin; c0 < c_end; c0 += kXChunk) {
    T col_s[kXCols] = {}, col_l[kXCols] = {};
    const bool next_chunk = c0 + kXChunk < c_end;
    for (int g0 = w0; g0 < w0 + per_warp; g0 += kXGroup) {
      T kn[kXGroup][kXCols];
      const bool next_group = g0 + kXGroup < w0 + per_warp;
      if (next_group) {
        load_group(kn, kbar, r0 + g0 + kXGroup, n1, c0, n2, lane);
      } else if (next_chunk) {
        load_group(kn, kbar, r0 + w0, n1, c0 + kXChunk, n2, lane);
        load_cols(cx, cs, cl, x2, s2, l2, c0 + kXChunk, n2, lane);
      }
      T part[2 * kXGroup];
#pragma unroll
      for (int g = 0; g < kXGroup; ++g) {
        const int r = g0 + g;
        const T xi = sx[r], si = ss[r], li = sl[r], hi = sh[r], ui = su[r];
        T ps = T(0), pl = T(0);
#pragma unroll
        for (int v = 0; v < kXCols; ++v) {
          const T dx = xi - xj[v];
          const T d = dx * dx;
          const T rs = grsqrt(fma(li, li, lj2[v]));  // the term's one root, and no division
          const T ra = rs * rs;
          const T w = kb[g][v] * ((ui * uj[v]) * rs * gexp(-d * ra));  // Kbar_ij g_ij
          const T e = fma(T(2) * d, ra, T(-1)) * ra;                    // f = 1/(2 l) + l e
          const T wss = w * (si * sj[v]);
          ps = fma(w, sj[v], ps);
          pl = fma(wss, fma(li, e, hi), pl);
          col_s[v] = fma(w, si, col_s[v]);
          col_l[v] = fma(wss, fma(lj[v], e, hj[v]), col_l[v]);
        }
        part[2 * g] = ps;
        part[2 * g + 1] = pl;
      }
      const T sum = lane_sum(part, lane);
      constexpr int kSpread = 32 / (2 * kXGroup);  // lanes between two of the 2 kXGroup sums
      if (lane % kSpread == 0) {
        const int q = lane / kSpread, r = g0 + (q >> 1);
        T* acc = (q & 1) ? srl : srs;
        acc[r] = c0 == c_begin ? sum : acc[r] + sum;
      }
      if (next_group || next_chunk) {
#pragma unroll
        for (int g = 0; g < kXGroup; ++g)
#pragma unroll
          for (int v = 0; v < kXCols; ++v) kb[g][v] = kn[g][v];
      }
    }
#pragma unroll
    for (int v = 0; v < kXCols; ++v) {
      red[warp][2 * (32 * v + lane)] = col_s[v];
      red[warp][2 * (32 * v + lane) + 1] = col_l[v];
    }
    if (next_chunk) column_setup();  // the next chunk's columns, beside this one's combine
    __syncthreads();
    // thread tid < 2 kXChunk: column c0 + tid / 2, sum tid % 2
    const int j = c0 + (tid >> 1);
    if (tid < 2 * kXChunk && j < n2) {
      T acc = red[0][tid];
#pragma unroll
      for (int w = 1; w < kXWarps; ++w) acc += red[w][tid];
      slots[(static_cast<size_t>(strip) * n2 + j) * 2 + (tid & 1)] = acc;
    }
    __syncthreads();  // red is free for the next chunk, and the row sums are whole after the last
  }
  const unsigned int n_strips = gridDim.x / col_groups;
  T* const rslots = slots + static_cast<size_t>(n_strips) * n2 * 2;  // [column group][row][2]
  if (st_in) {
    if (col_groups == 1) {
      s1_bar[i_st] = srs[tid];
      l1_bar[i_st] = srl[tid];
    } else {
      rslots[(static_cast<size_t>(cgrp) * n1 + i_st) * 2] = srs[tid];
      rslots[(static_cast<size_t>(cgrp) * n1 + i_st) * 2 + 1] = srl[tid];
    }
  }
  if (col_groups > 1) __syncthreads();  // the row slots are written before the tickets
  if (tid == 0) {
    last_col = take_ticket(tickets + cgrp, n_strips);
    last_row = col_groups > 1 && take_ticket(tickets + col_groups + strip, col_groups);
  }
  __syncthreads();
  if (last_row) {
    // the strip's rows: row slot of group 0, then + group 1, ... in order
    for (int p = tid; p < 2 * rows && r0 + (p >> 1) < n1; p += kXThreads) {
      const size_t at = static_cast<size_t>(r0) * 2 + p;
      T a = __ldcg(rslots + at);
      for (int g = 1; g < col_groups; ++g) a += __ldcg(rslots + static_cast<size_t>(g) * n1 * 2 + at);
      ((p & 1) ? l1_bar : s1_bar)[r0 + (p >> 1)] = a;
    }
  }
  if (!last_col) return;
  // the group's column slots: where its 2 (c_end - c_begin) values leave
  // threads idle, H thread groups (a power of two, at most 8) take the
  // batches of kXSlotBatch slots in turn, batch b to group b % H; slot s
  // goes to accumulator s % 4 of its group, the groups' accumulators are
  // added in group order, then (a0 + a1) + (a2 + a3)
  const int n_vals = 2 * (c_end - c_begin);
  const int groups = n_vals > kXThreads / 2 ? 1 : n_vals > kXThreads / 4 ? 2 : n_vals > kXThreads / 8 ? 4 : 8;
  const int span = kXThreads / groups;  // threads of a group
  const size_t stride = static_cast<size_t>(2) * n2;
  T* const acc4 = &red[0][0];  // [group][4][span]: red's 8 kXChunk 2 values hold 4 kXThreads
  for (int p0 = 0; p0 < n_vals; p0 += span) {  // p = 2 (column - c_begin) + t
    const int h = tid / span, p = p0 + tid % span;
    T a[4] = {T(0), T(0), T(0), T(0)};
    if (p < n_vals) {
      const T* src = slots + 2 * c_begin + p;
      for (unsigned int s = h * kXSlotBatch; s < n_strips; s += groups * kXSlotBatch) {
        T got[kXSlotBatch];
#pragma unroll
        for (int k = 0; k < kXSlotBatch; ++k) {
          got[k] = T(0);
          if (s + k < n_strips) got[k] = __ldcg(src + (s + k) * stride);
        }
#pragma unroll
        for (int k = 0; k < kXSlotBatch; ++k) a[k % 4] += got[k];
      }
    }
    if (groups > 1) {
      __syncthreads();  // acc4 (red) is free
#pragma unroll
      for (int k = 0; k < 4; ++k) acc4[(h * 4 + k) * span + tid % span] = a[k];
      __syncthreads();
      if (h == 0) {
        for (int g = 1; g < groups; ++g) {
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] += acc4[(g * 4 + k) * span + tid];
        }
      }
    }
    if (h == 0 && p < n_vals) ((p & 1) ? l2_bar : s2_bar)[c_begin + (p >> 1)] = (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// rows a multiple of kXWarps kXGroup up to kXMaxRows; col_groups such that
// every group gets ceil(chunks / col_groups) chunks but the last, which
// gets at least one; grid the strips times col_groups.
template <typename T>
int launch_cross_backward(const void* x1, const void* s1, const void* l1, int n1, const void* x2, const void* s2,
                          const void* l2, int n2, const void* kbar, int rows, int col_groups, int grid, void* slots,
                          void* tickets, void* s1_bar, void* l1_bar, void* s2_bar, void* l2_bar, void* stream) {
  constexpr int unit = kXWarps * kXGroup;
  const bool rows_ok = rows >= unit && rows <= kXMaxRows && rows % unit == 0;
  if (n1 < 1 || n2 < 1 || n2 >= (1 << 30) || !rows_ok || col_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n2 + kXChunk - 1) / kXChunk;
  const int per = (chunks + col_groups - 1) / col_groups;
  const long long strips = (static_cast<long long>(n1) + rows - 1) / rows;
  if (col_groups > chunks || (chunks + per - 1) / per != col_groups || grid != strips * col_groups ||
      strips * rows >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kXSmemPerRow) * rows * sizeof(T);
  gibbs_gram_cross_bwd_kernel<T><<<grid, kXThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(s1), static_cast<const T*>(l1), n1,
      static_cast<const T*>(x2), static_cast<const T*>(s2), static_cast<const T*>(l2), n2,
      static_cast<const T*>(kbar), rows, col_groups, static_cast<T*>(slots), static_cast<unsigned int*>(tickets),
      static_cast<T*>(s1_bar), static_cast<T*>(l1_bar), static_cast<T*>(s2_bar), static_cast<T*>(l2_bar));
  return static_cast<int>(cudaGetLastError());
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

// Cross-form backward, one launch.  slots: grid / col_groups * n2 * 2
// scratch values, then (with col_groups > 1) col_groups * n1 * 2; tickets:
// col_groups unsigned ints, then (with col_groups > 1) one a strip, 0 before
// the launch and after it; s1_bar, l1_bar (n1,), s2_bar, l2_bar (n2,).
// rows, col_groups, grid: gram_kernels.k1_cross_backward_schedule(n1, n2).
int gibbs_gram_cross_backward_f32(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                                  const void* s2, const void* l2, int n2, const void* kbar, int rows, int col_groups,
                                  int grid, void* slots, void* tickets, void* s1_bar, void* l1_bar, void* s2_bar,
                                  void* l2_bar, void* stream) {
  return launch_cross_backward<float>(x1, s1, l1, n1, x2, s2, l2, n2, kbar, rows, col_groups, grid, slots, tickets,
                                      s1_bar, l1_bar, s2_bar, l2_bar, stream);
}

int gibbs_gram_cross_backward_f64(const void* x1, const void* s1, const void* l1, int n1, const void* x2,
                                  const void* s2, const void* l2, int n2, const void* kbar, int rows, int col_groups,
                                  int grid, void* slots, void* tickets, void* s1_bar, void* l1_bar, void* s2_bar,
                                  void* l2_bar, void* stream) {
  return launch_cross_backward<double>(x1, s1, l1, n1, x2, s2, l2, n2, kbar, rows, col_groups, grid, slots, tickets,
                                       s1_bar, l1_bar, s2_bar, l2_bar, stream);
}

}  // extern "C"
