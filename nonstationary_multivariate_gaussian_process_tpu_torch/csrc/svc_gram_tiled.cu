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
// * M > 8 takes the generic route, M at run time.  The output is the N M x
//   N M product (kx (x) 1) o (Lf Lf^T) of Lf = L viewed as (N M, M), so the
//   route is a register-blocked product over tiles of 64 x 64 outputs of the
//   flattened index, one block of 256 threads a tile.  A block stages its
//   rows' and columns' L, 16 task columns b at a time, transposed to [b][row]
//   (so any M runs in a fixed 18.6 KB of shared memory), and the <= 9 x 9
//   Gibbs terms its tile spans, with each row's and column's input found by
//   one division a block.  Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and 4
//   columns, two 16-B groups of them (columns 2 tx, 2 tx + 32 in float64, 4
//   tx in float32), reads each b's 4 + 4 values of L as 16-B loads, steps b
//   with no index arithmetic, and stores V values at once (V the widest store
//   of at most 16 B that divides N M: every row offset r N M and column is a
//   multiple of it), so each store instruction of a warp writes two rows of
//   256 contiguous bytes.  Bound: the bytes written, (N M)^2 w, and at large M
//   the 2 M operations an output, each a separate multiply or add
//   (-fmad=false), which at M = 32 take about as long as the bytes.
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
// Where the caller asks for it (inducing-input refinement moves x: the
// sparse tiers' K_mm is this Gram at Z), also
//
//   xbar[n]     = sum_p gsum[n,p] kx[n,p] e(n, p),   e(n, p) = -2 (x_n - x_p)/A
//
// (dkx[n,p]/dx_n = e kx = -dkx[n,p]/dx_p; the jitter carries none): one more
// share a pair adds to both rows from the gsum it already forms, with slots
// and sums of its own in the same order as lbar's.  For M <= 2 (the models'
// usual task count) the pair kernel and its row sums take it as a
// compile-time variant (X), launched where xbar is asked for, so those
// launches without it run the kernels and registers they ran before; above,
// where a variant's build costs more (variants at every M took the source's
// build from 39-46 s to 65-79 s on the H100's host), and on the generic
// route, a null xbar is tested where it is needed.
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
// * M > 8 takes a generic route with M at run time, over the same unordered
//   tile pairs but of the flattened index: tiles of 64 rows (n, a), whatever
//   M, so any M runs within a block's shared memory (see
//   svc_gram_tiled_bwd_generic_kernel).  It reads each element of Kbar once,
//   along its rows, stages it and the tiles' rows of L with cp.async a pair
//   ahead, and forms S once a pair; the sums run in double.  Its partials
//   are ceil(N M / 64) (M + ceil(M / 3)) N M doubles (122 MB at N=1000, M=9
//   against Kbar's 648 MB), summed by two more launches in a fixed order.
//   Bound: the bytes of Kbar, (N M)^2 w; its (N M)^2 M fma stay under that up
//   to M ~ 32 in float64.
//
// Batches (new: the TPU kernel took one Gram; a population sampler needs
// one per particle).  The batched entry points take B members over shared
// x: ell (B, N), L (B, N, M, M), the output and Kbar (B, N M, N M).  One
// launch serves the whole batch: the forward takes the member from the
// grid's y (z on the generic route), its blocks walking that member's items
// as a single launch's do; the backward's pair walk and row reduce run over
// (member, pair) and (member, row), member-major, with each member's arrays
// and partials at its own offset.  Each member is computed exactly as a
// single launch computes it, the same items, pairs, slots and summation
// order, hence the same bits.  The generic backward runs its three launches
// once per member.
//
// Built without fast math and with -fmad=false: the forward's task sum runs
// b = 0..M-1 in the plain version's order, each operation rounded on its own,
// so the forward matches the plain PyTorch version bit for bit.  The backward
// is held to a tolerance and uses explicit fma() and one division per pair.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;  // the largest M of the templated routes
constexpr int kFwdMaxThreads = 256;  // forward, M <= 8: at most 8 warps a block
// The generic routes (M > 8): tiles of the flattened N M x N M index.
constexpr int kGenTile = 64;             // rows (and columns) of a tile
constexpr int kGenSpan = 9;              // inputs a tile's 64 rows span at M >= 9: 63 / 9 + 2
constexpr int kGenK = 16;                // forward: task columns b of L staged at once
constexpr int kGenPitch = kGenTile + 4;  // forward: a staged [b] row of L (16-B aligned in either type)
constexpr int kGenFwdThreads = 256;      // forward: 16 x 16 threads, 4 x 4 outputs each
constexpr int kGenBB = 3;                // backward: b values of a task
constexpr int kGenKP = kGenTile + 1;     // backward: padded row of a staged Kbar tile and of S
constexpr int kGenBwdThreads = 384;      // backward: 12 warps, one block per SM
constexpr size_t kMaxSmem = 232448;      // a block's shared memory on the H100 (227 KB)
constexpr int kXVariantMaxM = 2;         // backward, M <= this: xbar as a compile-time variant

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

// One warp per item (rows x 32 input pairs); see the header.  A batch:
// member blockIdx.y walks its items as a single launch does, with its ell,
// ls and out at its own offset and x shared (0 for one Gram); every output
// is kx * bsum of its own (n, a, p, c) either way, so a member's Gram equals
// a single launch's bit for bit.
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
  ell += static_cast<size_t>(blockIdx.y) * n;
  ls += static_cast<size_t>(blockIdx.y) * n * F::MM;
  out += static_cast<size_t>(blockIdx.y) * nm * nm;
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

// M > 8, any M: one block per 64 x 64 tile of the flattened output; see the
// header.  Thread (ty, tx) owns rows 4 ty + i (i < 4) and the columns of
// GenFwd<T>::col(tx, j); the sums run b = 0..M-1 in order, each operation
// rounded on its own, as the plain version's do.
template <typename T>
struct GenFwd {
  static constexpr int CW = 16 / static_cast<int>(sizeof(T));  // a thread's contiguous columns: 2, or 4 in float32
  static constexpr int GROUPS = 4 / CW;                         // its groups of them: 2, or 1 in float32
  // local column of value j (< 4) of thread tx: group j / CW at 16 CW apart
  __device__ static __forceinline__ int col(int tx, int j) { return CW * tx + 16 * CW * (j / CW) + j % CW; }
};

// Four consecutive values from 16-B aligned shared memory.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* v) {
  if constexpr (sizeof(T) == 8) {
    const double2 a = *reinterpret_cast<const double2*>(p), b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

// One step b of the sums: the thread's 4 rows and 4 columns of staged L, 16 B
// at a time.  FIRST: the product starts the sum.
template <typename T, bool FIRST>
__device__ __forceinline__ void gen_fwd_step(const T* As_b, const T* Bs_b, int tx, int ty, T (&acc)[4][4]) {
  using G = GenFwd<T>;
  T a[4], c[4];
  load4(As_b + 4 * ty, a);
#pragma unroll
  for (int g = 0; g < G::GROUPS; ++g) {
    const T* src = Bs_b + G::CW * tx + 16 * G::CW * g;
    if constexpr (sizeof(T) == 8) {
      const double2 v = *reinterpret_cast<const double2*>(src);
      c[2 * g] = v.x;
      c[2 * g + 1] = v.y;
    } else {
      load4(src, c);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = FIRST ? a[i] * c[j] : acc[i][j] + a[i] * c[j];
}

template <typename T, int V>
__global__ void __launch_bounds__(kGenFwdThreads)
svc_gram_tiled_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                              const T* __restrict__ ls, int n, int m, T jitter,
                              T* __restrict__ out) {
  using G = GenFwd<T>;
  __shared__ __align__(16) T As[kGenK * kGenPitch];  // [b][row]: L of the tile's rows, task columns k0 + b
  __shared__ __align__(16) T Bs[kGenK * kGenPitch];  // [b][column]
  __shared__ T kx_s[kGenSpan * kGenSpan];            // [row input][column input], from the tile's first
  __shared__ int rn_s[kGenTile], cp_s[kGenTile];      // each row's (column's) input, from the tile's first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nm = n * m;
  // a batch: member blockIdx.z, its ell, ls and out at their offsets (0 for one Gram)
  ell += static_cast<size_t>(blockIdx.z) * n;
  ls += static_cast<size_t>(blockIdx.z) * nm * m;
  out += static_cast<size_t>(blockIdx.z) * nm * nm;
  const int R0 = blockIdx.y * kGenTile, C0 = blockIdx.x * kGenTile;
  const int n0 = R0 / m, p0 = C0 / m;
  if (tid < kGenTile) {
    rn_s[tid] = (R0 + tid) / m - n0;
    cp_s[tid] = (C0 + tid) / m - p0;
  }
  for (int i = tid; i < kGenSpan * kGenSpan; i += kGenFwdThreads) {
    const int r = n0 + i / kGenSpan, p = p0 + i % kGenSpan;
    T kx = T(0);
    if (r < n && p < n) {
      kx = gibbs(x[r], ell[r], x[p], ell[p]);
      if (r == p) kx = kx + jitter;
    }
    kx_s[i] = kx;
  }
  T acc[4][4];
  for (int k0 = 0; k0 < m; k0 += kGenK) {
    const int kn = min(kGenK, m - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < kGenTile * kGenK; i += kGenFwdThreads) {
      const int r = i / kGenK, b = i % kGenK;  // consecutive threads: consecutive b of one row of L
      const bool in_b = b < kn;
      As[b * kGenPitch + r] = in_b && R0 + r < nm ? ls[static_cast<size_t>(R0 + r) * m + k0 + b] : T(0);
      Bs[b * kGenPitch + r] = in_b && C0 + r < nm ? ls[static_cast<size_t>(C0 + r) * m + k0 + b] : T(0);
    }
    __syncthreads();
    int b = 0;
    if (k0 == 0) {
      gen_fwd_step<T, true>(As, Bs, tx, ty, acc);
      b = 1;
    }
    for (; b < kn; ++b) gen_fwd_step<T, false>(As + b * kGenPitch, Bs + b * kGenPitch, tx, ty, acc);
  }
  // V values a store; V divides N M and CW, so a group never crosses the edge
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = 4 * ty + i;
    if (R0 + lr >= nm) break;
    const T* kx_r = kx_s + rn_s[lr] * kGenSpan;
    T* orow = out + static_cast<size_t>(R0 + lr) * nm + C0;
#pragma unroll
    for (int j = 0; j < 4; j += V) {
      const int lc = G::col(tx, j);
      if (C0 + lc >= nm) continue;
      T val[V];
#pragma unroll
      for (int v = 0; v < V; ++v) val[v] = kx_r[cp_s[lc + v]] * acc[i][j + v];
      store_vec<T, V>(orow + lc, val);
    }
  }
}

template <typename T, int M>
int launch_forward_m(const T* x, const T* ell, const T* ls, int n, int rows, int n_items, int n_batch, T jitter,
                     int warps, int grid, T* out, cudaStream_t stream) {
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(n_batch));
  using F = Fwd<T, M>;
  const size_t smem = F::REGS ? 0 : sizeof(T) * F::STRIP * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svc_gram_tiled_fwd_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svc_gram_tiled_fwd_kernel<T, M><<<blocks, warps * 32, smem, stream>>>(x, ell, ls, n, rows, n_items, jitter,
                                                                         out);
  return static_cast<int>(cudaGetLastError());
}

// The widest store of at most 16 B whose value count divides k.
template <typename T>
int store_width(long long k) {
  return sizeof(T) == 8 ? (k % 2 == 0 ? 2 : 1) : (k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1);
}

// For m <= 8, vec must be the store width of (T, m), and 1 <= warps <=
// kFwdMaxThreads / 32 and 1 <= grid.  For m > 8 (the generic route) vec must
// be the store width of (T, n m), rows = kGenTile, warps = kGenFwdThreads /
// 32 and grid = tiles^2.  n_batch Grams, member b from ell + b n, ls + b n m
// m into out + b (n m)^2, the member along the grid's y (M <= 8: grid blocks
// a member) or z (the generic route).
template <typename T>
int launch_forward(const void* x_, const void* ell_, const void* ls_, int n, int m, int n_batch,
                   double jitter_, int vec, int rows, int warps, int grid, void* out_,
                   void* stream_) {
  const T* x = static_cast<const T*>(x_);
  const T* ell = static_cast<const T*>(ell_);
  const T* ls = static_cast<const T*>(ls_);
  const T jitter = static_cast<T>(jitter_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n < 1 || m < 1 || n_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m > kMaxM) {
    // N M must fit an int, and (16 M)^2 too (the first generic route's limit, kept)
    const long long nm = static_cast<long long>(n) * m;
    const long long tiles = (nm + kGenTile - 1) / kGenTile;
    if (nm > 0x7fffffff || 16 * m > 46340 || tiles > 65535 || n_batch > 65535 || vec != store_width<T>(nm) ||
        rows != kGenTile || warps * 32 != kGenFwdThreads || static_cast<long long>(grid) != tiles * tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 blocks(static_cast<unsigned>(tiles), static_cast<unsigned>(tiles), static_cast<unsigned>(n_batch));
    switch (vec) {
      case 1:
        svc_gram_tiled_generic_kernel<T, 1><<<blocks, kGenFwdThreads, 0, stream>>>(x, ell, ls, n, m, jitter, out);
        break;
      case 2:
        svc_gram_tiled_generic_kernel<T, 2><<<blocks, kGenFwdThreads, 0, stream>>>(x, ell, ls, n, m, jitter, out);
        break;
      default:
        if constexpr (sizeof(T) == 4)
          svc_gram_tiled_generic_kernel<T, 4><<<blocks, kGenFwdThreads, 0, stream>>>(x, ell, ls, n, m, jitter, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (vec != store_width<T>(m) || rows < 1 || warps < 1 || warps * 32 > kFwdMaxThreads || grid < 1 ||
      n_batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>((n + rows - 1) / rows) * ((n + 31) / 32);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
#define K3_FWD_CASE(M_) \
  return launch_forward_m<T, M_>(x, ell, ls, n, rows, n_items, n_batch, jitter, warps, grid, out, stream)
  switch (m) {
    case 1: K3_FWD_CASE(1);
    case 2: K3_FWD_CASE(2);
    case 3: K3_FWD_CASE(3);
    case 4: K3_FWD_CASE(4);
    case 5: K3_FWD_CASE(5);
    case 6: K3_FWD_CASE(6);
    case 7: K3_FWD_CASE(7);
    default: K3_FWD_CASE(8);
  }
#undef K3_FWD_CASE
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
  // with xbar: its row shares [row][column] (RP), then each warp's column sums
  static constexpr size_t SMEM_X = SMEM + sizeof(T) * (TILE * RP + WARPS * TILE);
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

// Pair q of a walk over n_batch members' tile pairs, member-major: member
// mb = q / n_pairs, its pair q % n_pairs (one member: mb = 0).
__device__ __forceinline__ void walk_pair(int q, int n_pairs, int n_tiles, bool batch, int& mb, int& I, int& J) {
  mb = batch ? q / n_pairs : 0;
  tile_pair(q - mb * n_pairs, n_tiles, I, J);
}

// One block walks tile pairs q = blockIdx.x, + gridDim.x, ...; thread
// (ty, tx) takes the input pair (n, p) = (I*T + ty, J*T + tx).  Writes
// partial[slot][row][0..M*M) = Lbar's share and [M*M] = lbar's share.  The
// walk covers n_batch members' pairs (walk_pair; one Gram: n_batch = 1),
// each member's ell, ls, kbar and partials at its own offset and x shared;
// a member's pairs, sums and slots are a single launch's, so its result is
// too.  With xbar asked for (one Gram, S::SMEM_X of shared memory):
// partial_x[slot][row] = xbar's share, summed as lbar's.  For M <= 2 (the
// models' usual task count) that is the compile-time variant X; above, where
// a variant's build costs more, a null partial_x tested where it is needed.
template <typename T, int TILE, int M, bool X = false>
__global__ void __launch_bounds__(TILE * TILE)
svc_gram_tiled_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                          const T* __restrict__ ls, int n, int n_batch, T jitter,
                          const T* __restrict__ kbar, T* __restrict__ partial_all, T* __restrict__ partial_x) {
  using S = Bwd<T, TILE, M>;
  constexpr int MM = S::MM, K = S::K, KP = S::KP, LP = S::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  T* red_row = stages + 2 * S::STAGE;    // TILE x K x RP: the row shares
  T* red_col = red_row + TILE * K * S::RP;  // WARPS x TILE x K
  T* red_row_x = red_col + S::WARPS * TILE * K;  // with xbar: TILE x RP
  T* red_col_x = red_row_x + TILE * S::RP;       // WARPS x TILE
  const bool want_x = X || (M > kXVariantMaxM && partial_x != nullptr);

  const int tid = threadIdx.x;
  const int tx = tid % TILE, ty = tid / TILE;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int n_walk = n_batch * n_pairs;
  const bool batch = n_batch > 1;
  const size_t nm = static_cast<size_t>(n) * M;
  // a member's strides: ell, ls, kbar and its partials
  const size_t s_ell = n, s_ls = static_cast<size_t>(n) * MM, s_kb = nm * nm;
  const size_t s_part = static_cast<size_t>(n_tiles) * n * K;

  int q = blockIdx.x, I, J, mb;
  walk_pair(q, n_pairs, n_tiles, batch, mb, I, J);
  stage_pair<T, TILE, M>(stages, I, J, n, x, ell + mb * s_ell, ls + mb * s_ls, kbar + mb * s_kb, tid);
  __pipeline_commit();
  for (int it = 0; q < n_walk; ++it, q += gridDim.x) {
    const T* st = stages + (it & 1) * S::STAGE;
    int In = 0, Jn = 0, mbn = 0;
    if (q + gridDim.x < n_walk) {
      walk_pair(q + gridDim.x, n_pairs, n_tiles, batch, mbn, In, Jn);
      stage_pair<T, TILE, M>(stages + ((it + 1) & 1) * S::STAGE, In, Jn, n, x, ell + mbn * s_ell,
                             ls + mbn * s_ls, kbar + mbn * s_kb, tid);
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

    T row[K], col[K], row_x = T(0), col_x = T(0);
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
        if (want_x) {  // e(n, p) gsum kx to row n, its negative to row p
          row_x = (T(-2) * dx * inv_a) * gk;
          col_x = -row_x;
        }
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
    if (want_x) {  // xbar's shares, as lbar's
#pragma unroll
      for (int off = TILE / 2; off >= S::RC; off >>= 1) row_x += __shfl_xor_sync(0xffffffffu, row_x, off);
      if (tx < S::RC) red_row_x[ty * S::RP + tx] = row_x;
#pragma unroll
      for (int off = TILE; off < 32; off <<= 1) col_x += __shfl_xor_sync(0xffffffffu, col_x, off);
      if (lane < TILE) red_col_x[warp * TILE + lane] = col_x;
    }
    __syncthreads();  // also: every thread is done with this stage

    const int n0 = I * TILE, p0 = J * TILE;
    T* partial = partial_all + mb * s_part;
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
    for (int l = tid; want_x && l < TILE; l += S::THREADS) {
      T rs = red_row_x[l * S::RP];
#pragma unroll
      for (int j = 1; j < S::RC; ++j) rs += red_row_x[l * S::RP + j];
      T cs = red_col_x[l];
#pragma unroll
      for (int w = 1; w < S::WARPS; ++w) cs += red_col_x[w * TILE + l];
      if (diag) {
        if (n0 + l < n) partial_x[static_cast<size_t>(I) * n + n0 + l] = rs + cs;
      } else {
        if (n0 + l < n) partial_x[static_cast<size_t>(J) * n + n0 + l] = rs;
        if (p0 + l < n) partial_x[static_cast<size_t>(I) * n + p0 + l] = cs;
      }
    }
    I = In;
    J = Jn;
    mb = mbn;
  }
}

// Sums each row's slots in one fixed order: one warp per row, lane j adds
// slots j, j + 32, ... in turn, then a fixed shuffle tree adds the lanes.
// Writes ls_bar (N, M, M) and ell_bar (N,); for n_batch members, their
// rows member-major, each member's slots at its own offset, ls_bar (B, N,
// M, M) and ell_bar (B, N).
template <typename T, int M, bool X = false>
__global__ void svc_gram_tiled_bwd_reduce(const T* __restrict__ partial, int n_slots, int n, int n_batch,
                                          T* __restrict__ ls_bar, T* __restrict__ ell_bar,
                                          const T* __restrict__ partial_x, T* __restrict__ x_bar) {
  constexpr int MM = M * M, K = MM + 1;
  const int grow = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (grow >= n_batch * n) return;  // whole warps leave together
  const int mb = n_batch > 1 ? grow / n : 0;
  const int row = grow - mb * n;
  partial += static_cast<size_t>(mb) * n_slots * n * K;
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
    for (int k = 0; k < MM; ++k) ls_bar[static_cast<size_t>(grow) * MM + k] = s[k];
    ell_bar[grow] = s[MM];
  }
  if (X || (M > kXVariantMaxM && x_bar != nullptr)) {  // one Gram: grow is the row
    T sx = T(0);
    for (int slot = lane; slot < n_slots; slot += 32) sx += partial_x[static_cast<size_t>(slot) * n + row];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sx += __shfl_xor_sync(0xffffffffu, sx, off);
    if (lane == 0) x_bar[row] = sx;
  }
}

// M > 8, any M: the tiled route's walk over unordered tile pairs (I <= J),
// on tiles of 64 rows of the flattened index (row (n, a) = n M + a), with M
// at run time.  For Lf = L viewed as (N M, M) and S = Kbar + Kbar^T,
//
//   Lbar[r, b] = sum_q kxj(r, q) S[r, q] Lf[q, b]
//   lbar[n]    = sum_{a, b} Lf[(n, a), b] Q[(n, a), b],  Q[r, b] = sum_q W(r, q) S[r, q] Lf[q, b]
//
// with kxj(r, q) = kxj[n(r), p(q)] and W(r, q) = kx f(l_n; l_p, D) (0 where
// n == p).  A pair stages Kbar[I,J] and Kbar[J,I] (one tile on the diagonal)
// and the tiles' 64 rows of Lf with cp.async into one of two stages while
// the previous pair computes (Lf only where both stages fit: M <= 47 in
// float64, 127 in float32; else Lf is read through the cache), forms S[I,J]
// once in double (in place of Kbar[I,J] in float64), and evaluates the Gibbs
// terms of the <= 9 x 9 input pairs the tiles span once (kxj, W both ways).
// A task is one row side (a row r of I, walking the columns q of J) or one
// column side (a row q of J, walking the rows r of I, through S^T: S is
// symmetric), for kGenBB consecutive b: along its walk it sums t = S Lf over
// each input's run of M (or fewer) rows, then adds kxj t to Lbar's share and
// W t to Q's.  Row r of tile I gets the shares of every q of J, row q of J
// those of every r of I, so each pair writes the rows of I to slot J and (off
// the diagonal) those of J to slot I: partial[slot][k][row], k < M the Lbar
// share, k = M + (b block) the lbar share sum_b Lf Q of that b block.  Every
// (slot, k, row) is written once; two more launches sum them in one fixed
// order (svc_gram_tiled_bwd_generic_reduce, _finish).  The sums run in
// double for either T: at large M, lbar is a small difference of large terms
// (M = 130: sums of 10^4 terms of ~10^2 that cancel to ~50), which float32
// sums would carry with errors of 1e-4 of it.  With xbar asked for, two
// more 9 x 9 tables follow W's, X = kx e(n, p) for the row side and its
// negative for the column side, a task adds X t to a third sum, and k = M +
// nbb + (b block) holds that block's xbar share sum_b Lf (X t); the reduce
// and the finish sum them as lbar's.
template <typename T>
struct GenBwd {
  static constexpr int KB = kGenTile * kGenKP;  // one staged Kbar tile, [row][col]
  static constexpr int TAB = kGenSpan * kGenSpan;
  static constexpr bool S_IN_PLACE = sizeof(T) == 8;  // S overwrites Kbar[I,J]; else a double buffer of its own
  // a stage: Kbar[I,J], Kbar[J,I], then (staged) the 64 rows of Lf of I and of J
  __host__ __device__ static constexpr int stage(int m, bool stage_l) { return 2 * KB + (stage_l ? 2 * kGenTile * m : 0); }
  // two stages of T, then S (float32) and the kxj, W (row side), W (column side) tables in double
  __host__ __device__ static constexpr size_t smem(int m, bool stage_l) {
    return sizeof(T) * 2 * stage(m, stage_l) + sizeof(double) * ((S_IN_PLACE ? 0 : KB) + 3 * TAB);
  }
};

// Kbar's tile of rows R0.. and columns C0.. into [row][col], read along
// Kbar's rows; past N M it is 0.
template <typename T>
__device__ __forceinline__ void stage_gen_tile(T* dst, int R0, int C0, int nm, const T* kbar, int tid) {
  const int rows = min(kGenTile, nm - R0), cols = min(kGenTile, nm - C0);
  const T* src = kbar + static_cast<size_t>(R0) * nm + C0;
  for (int i = tid; i < kGenTile * kGenTile; i += kGenBwdThreads) {
    const int r = i / kGenTile, c = i % kGenTile;
    T* d = dst + r * kGenKP + c;
    if (r < rows && c < cols) copy_async(d, src + static_cast<size_t>(r) * nm + c);
    else *d = T(0);
  }
}

// Tile pair (I, J)'s Kbar tiles and, if stage_l, its rows of Lf (contiguous
// in memory; past N M they are 0).
template <typename T>
__device__ __forceinline__ void stage_gen_pair(T* st, int I, int J, int nm, int m, bool stage_l, const T* ls,
                                               const T* kbar, int tid) {
  stage_gen_tile<T>(st, I * kGenTile, J * kGenTile, nm, kbar, tid);
  if (I != J) stage_gen_tile<T>(st + GenBwd<T>::KB, J * kGenTile, I * kGenTile, nm, kbar, tid);
  if (!stage_l) return;
  const size_t total = static_cast<size_t>(nm) * m;
  for (int t = 0; t < (I != J ? 2 : 1); ++t) {
    const size_t src0 = static_cast<size_t>(t == 0 ? I : J) * kGenTile * m;
    T* dst = st + 2 * GenBwd<T>::KB + t * kGenTile * m;
    for (int i = tid; i < kGenTile * m; i += kGenBwdThreads) {
      if (src0 + i < total) copy_async(dst + i, ls + src0 + i);
      else dst[i] = T(0);
    }
  }
}

// One task: output row own0 + e, walking the rows of tile walk0 in order
// through s(w) = S[e][w] (row side) or S[w][e] (column side).  Lown, Lwalk:
// the own and the walked tile's rows of Lf (staged or in memory), row stride
// m.  tab: the (own input, walked input) entry of the kxj and W tables.
template <typename T, bool COL>
__device__ __forceinline__ void gen_bwd_task(const double* __restrict__ S, const double* __restrict__ kxj_s,
                                             const double* __restrict__ w_s, const T* Lown, const T* Lwalk,
                                             int m, int nm, int e, int bb, int own0, int walk0, int slot, int ks,
                                             double* __restrict__ partial) {
  const int row = own0 + e;
  if (row >= nm) return;
  const int nbb = (m + kGenBB - 1) / kGenBB;
  const bool want_x = ks > m + nbb;              // xbar's shares after lbar's,
  const double* x_s = w_s + 2 * GenBwd<T>::TAB;  // its table after W's
  const int own = row / m - own0 / m;  // the row's input, from its tile's first
  const int first = walk0 / m;         // the walked tile's first input
  const int wlim = min(kGenTile, nm - walk0);
  int bi[kGenBB];
#pragma unroll
  for (int j = 0; j < kGenBB; ++j) bi[j] = min(bb * kGenBB + j, m - 1);  // past M: read in bounds, never stored
  double acc[kGenBB], lacc[kGenBB], xacc[kGenBB];
#pragma unroll
  for (int j = 0; j < kGenBB; ++j) acc[j] = lacc[j] = xacc[j] = 0.0;
  int w = 0, seg = 0;
  for (int end = (first + 1) * m - walk0; w < wlim; end += m, ++seg) {  // one walked input a segment
    const int e1 = min(end, wlim);
    double t[kGenBB];
#pragma unroll
    for (int j = 0; j < kGenBB; ++j) t[j] = 0.0;
#pragma unroll 4
    for (; w < e1; ++w) {
      const double s = COL ? S[w * kGenKP + e] : S[e * kGenKP + w];
      const T* lw = Lwalk + w * m;
#pragma unroll
      for (int j = 0; j < kGenBB; ++j) t[j] = fma(s, static_cast<double>(lw[bi[j]]), t[j]);
    }
    const int tab = COL ? seg * kGenSpan + own : own * kGenSpan + seg;
    const double kk = kxj_s[tab], ww = w_s[tab];
#pragma unroll
    for (int j = 0; j < kGenBB; ++j) {
      acc[j] = fma(kk, t[j], acc[j]);
      lacc[j] = fma(ww, t[j], lacc[j]);
    }
    if (want_x) {
      const double xx = x_s[tab];
#pragma unroll
      for (int j = 0; j < kGenBB; ++j) xacc[j] = fma(xx, t[j], xacc[j]);
    }
  }
  double* dst = partial + static_cast<size_t>(slot) * ks * nm + row;
  const T* lr = Lown + e * m;
  double lsum = 0.0, xsum = 0.0;
#pragma unroll
  for (int j = 0; j < kGenBB; ++j) {
    if (bb * kGenBB + j >= m) break;
    dst[static_cast<size_t>(bb * kGenBB + j) * nm] = acc[j];
    lsum = fma(static_cast<double>(lr[bi[j]]), lacc[j], lsum);
    xsum = fma(static_cast<double>(lr[bi[j]]), xacc[j], xsum);
  }
  dst[static_cast<size_t>(m + bb) * nm] = lsum;
  if (want_x) dst[static_cast<size_t>(m + nbb + bb) * nm] = xsum;
}

template <typename T>
__global__ void __launch_bounds__(kGenBwdThreads, 1)
svc_gram_tiled_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ ell,
                                  const T* __restrict__ ls, int n, int m, T jitter, bool stage_l,
                                  const T* __restrict__ kbar, double* __restrict__ partial, bool want_x) {
  using G = GenBwd<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage = G::stage(m, stage_l);
  T* stages = reinterpret_cast<T*>(smem_raw);
  double* Sbuf = reinterpret_cast<double*>(smem_raw + sizeof(T) * 2 * stage);  // float32: S
  double* kxj_s = Sbuf + (G::S_IN_PLACE ? 0 : G::KB);  // [row input][column input], from each tile's first
  double* wr_s = kxj_s + G::TAB;                       // kx f(l_n; l_p, D): the row side's W
  double* wc_s = wr_s + G::TAB;                        // kx f(l_p; l_n, D): the column side's W
  double* xr_s = wc_s + G::TAB;                        // with xbar: kx e(n, p), the row side's X
  double* xc_s = xr_s + G::TAB;                        // and the column side's, -kx e(n, p)
  const int tid = threadIdx.x;
  const int nm = n * m;
  const int n_tiles = (nm + kGenTile - 1) / kGenTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int nbb = (m + kGenBB - 1) / kGenBB;
  const int ks = m + nbb * (want_x ? 2 : 1);

  int q = blockIdx.x, I, J;
  tile_pair(q, n_tiles, I, J);
  stage_gen_pair<T>(stages, I, J, nm, m, stage_l, ls, kbar, tid);
  __pipeline_commit();
  for (int it = 0; q < n_pairs; ++it, q += gridDim.x) {
    T* st = stages + (it & 1) * stage;
    int In = 0, Jn = 0;
    if (q + gridDim.x < n_pairs) {
      tile_pair(q + gridDim.x, n_tiles, In, Jn);
      stage_gen_pair<T>(stages + ((it + 1) & 1) * stage, In, Jn, nm, m, stage_l, ls, kbar, tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this pair's copies have landed
    __syncthreads();

    const bool diag = I == J;
    const int I0 = I * kGenTile, J0 = J * kGenTile;
    T* kb = st;                               // Kbar[(I0 + r), (J0 + c)] at [r][c]
    const T* kbt = diag ? st : st + G::KB;    // Kbar[(J0 + c), (I0 + r)] at [c][r]
    double* S = G::S_IN_PLACE ? reinterpret_cast<double*>(kb) : Sbuf;
    for (int i = tid; i < kGenTile * kGenTile; i += kGenBwdThreads) {
      const int r = i / kGenTile, c = i % kGenTile;
      if (diag) {  // each unordered (r, c) by one thread, so S may overwrite Kbar
        if (r <= c) {
          const double v = static_cast<double>(kb[r * kGenKP + c]) + static_cast<double>(kb[c * kGenKP + r]);
          S[r * kGenKP + c] = v;
          S[c * kGenKP + r] = v;
        }
      } else {
        S[r * kGenKP + c] = static_cast<double>(kb[r * kGenKP + c]) + static_cast<double>(kbt[c * kGenKP + r]);
      }
    }
    if (tid < G::TAB) {
      const int nn = I0 / m + tid / kGenSpan, pp = J0 / m + tid % kGenSpan;
      double kxj = 0.0, wr = 0.0, wc = 0.0, xr = 0.0;
      if (nn < n && pp < n) {
        const double ln = ell[nn], lp = ell[pp];
        const double dx = static_cast<double>(x[nn]) - static_cast<double>(x[pp]);
        const double d = dx * dx, a2 = fma(ln, ln, lp * lp);
        const double kx = sqrt(2.0 * (ln * lp) / a2) * exp(-d / a2);
        kxj = nn == pp ? kx + static_cast<double>(jitter) : kx;
        if (nn != pp) {
          const double g = fma(2.0 * d, 1.0 / (a2 * a2), -1.0 / a2);  // -1/A + 2 D/A^2
          wr = kx * fma(ln, g, 0.5 / ln);
          wc = kx * fma(lp, g, 0.5 / lp);
          xr = kx * (-2.0 * dx / a2);
        }
      }
      kxj_s[tid] = kxj;
      wr_s[tid] = wr;
      wc_s[tid] = wc;
      if (want_x) {
        xr_s[tid] = xr;
        xc_s[tid] = -xr;
      }
    }
    __syncthreads();

    // the tiles' rows of Lf: staged, or in memory
    const T* LI = stage_l ? st + 2 * G::KB : ls + static_cast<size_t>(I0) * m;
    const T* LJ = stage_l ? (diag ? LI : st + 2 * G::KB + kGenTile * m) : ls + static_cast<size_t>(J0) * m;
    const int side = kGenTile * nbb;  // the tasks of one side
    const int n_tasks = diag ? side : 2 * side;
    for (int k = tid; k < n_tasks; k += kGenBwdThreads) {
      if (k < side)  // the rows of I, walking J: slot J (I on the diagonal)
        gen_bwd_task<T, false>(S, kxj_s, wr_s, LI, LJ, m, nm, k % kGenTile, k / kGenTile, I0, J0, J, ks, partial);
      else  // the rows of J, walking I: slot I
        gen_bwd_task<T, true>(S, kxj_s, wc_s, LJ, LI, m, nm, (k - side) % kGenTile, (k - side) / kGenTile, J0, I0,
                              I, ks, partial);
    }
    __syncthreads();  // every thread is done with this stage, S and the tables
    I = In;
    J = Jn;
  }
}

// Sums the generic route's slots in one fixed order, in double: thread i
// takes (k, row) = (i / (N M), i % (N M)) and adds its slots 0, 1, ... in
// turn (loads issued kGenSlotBatch at a time); k < M is L̄'s element (row,
// k), written to ls_bar (N, M, M), k >= M the row's lbar share of b block k
// - M, written back over slot 0 (only this thread reads it).
constexpr int kGenSlotBatch = 8;

template <typename T>
__global__ void svc_gram_tiled_bwd_generic_reduce(double* __restrict__ partial, int n_slots, int n, int m,
                                                  T* __restrict__ ls_bar, bool want_x) {
  const long long nm = static_cast<long long>(n) * m;
  const int nbb = (m + kGenBB - 1) / kGenBB, ks = m + nbb * (want_x ? 2 : 1);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nm * ks) return;
  const long long k = i / nm, row = i % nm;
  const double* src = partial + k * nm + row;
  const size_t stride = static_cast<size_t>(ks) * nm;  // one slot
  double acc = 0.0;
  int s = 0;
  for (; s + kGenSlotBatch <= n_slots; s += kGenSlotBatch) {
    double v[kGenSlotBatch];
#pragma unroll
    for (int j = 0; j < kGenSlotBatch; ++j) v[j] = src[(s + j) * stride];
#pragma unroll
    for (int j = 0; j < kGenSlotBatch; ++j) acc += v[j];
  }
  for (; s < n_slots; ++s) acc += src[s * stride];
  if (k < m) ls_bar[row * m + k] = static_cast<T>(acc);
  else partial[i] = acc;
}

// ell_bar[n]: one warp per input n; lane l adds terms l, l + 32, ... of j =
// a * (b blocks) + b block (the reduced shares left in slot 0), then a fixed
// shuffle tree adds the lanes.
template <typename T>
__global__ void svc_gram_tiled_bwd_generic_finish(const double* __restrict__ partial, int n, int m,
                                                  T* __restrict__ ell_bar, T* __restrict__ x_bar) {
  const long long nm = static_cast<long long>(n) * m;
  const int nbb = (m + kGenBB - 1) / kGenBB;
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // whole warps leave together
  double acc = 0.0;
  for (int j = lane; j < m * nbb; j += 32) {
    const int a = j / nbb, kb = j % nbb;
    acc += partial[(m + kb) * nm + w * m + a];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) ell_bar[w] = static_cast<T>(acc);
  if (x_bar == nullptr) return;
  double xacc = 0.0;  // xbar: its shares, k = M + nbb + (b block), in the same order
  for (int j = lane; j < m * nbb; j += 32) xacc += partial[(m + nbb + j % nbb) * nm + w * m + j / nbb];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) xacc += __shfl_xor_sync(0xffffffffu, xacc, off);
  if (lane == 0) x_bar[w] = static_cast<T>(xacc);
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* ell;
  const T* ls;
  int n;
  int n_batch;
  T jitter;
  const T* kbar;
  int grid;
  T* partial;
  T* ls_bar;
  T* ell_bar;
  T* x_bar;  // null: no xbar (always so for a batch)
  cudaStream_t stream;
};

// With a.x_bar (one Gram), partial holds xbar's ceil(n / TILE) n slots
// after the others.
template <typename T, int TILE, int M>
int launch_backward_m(const BwdArgs<T>& a) {
  using S = Bwd<T, TILE, M>;
  const int n_slots = (a.n + TILE - 1) / TILE;
  T* partial_x = a.x_bar == nullptr ? nullptr : a.partial + static_cast<size_t>(n_slots) * a.n * S::K;
  const size_t smem = a.x_bar == nullptr ? S::SMEM : S::SMEM_X;
  auto* kernel = svc_gram_tiled_bwd_kernel<T, TILE, M>;
  auto* reduce = svc_gram_tiled_bwd_reduce<T, M>;
  if constexpr (M <= kXVariantMaxM) {  // only here is the X variant instantiated
    if (a.x_bar != nullptr) {
      kernel = svc_gram_tiled_bwd_kernel<T, TILE, M, true>;
      reduce = svc_gram_tiled_bwd_reduce<T, M, true>;
    }
  }
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.grid, S::THREADS, smem, a.stream>>>(a.x, a.ell, a.ls, a.n, a.n_batch, a.jitter, a.kbar, a.partial,
                                                  partial_x);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kThreads / 32;
  const int rows = a.n_batch * a.n;
  reduce<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, a.stream>>>(
      a.partial, n_slots, a.n, a.n_batch, a.ls_bar, a.ell_bar, partial_x, a.x_bar);
  return static_cast<int>(cudaGetLastError());
}

// M > 8 (the generic route), one Gram: tile = kGenTile rows of the
// flattened index, 1 <= grid <= its tile pairs, and partial holds ceil(n m /
// kGenTile) (m + ceil(m / kGenBB)) n m doubles, with x_bar ceil(n m /
// kGenTile) (m + 2 ceil(m / kGenBB)) n m.
template <typename T>
int launch_backward_generic(const void* x, const void* ell, const void* ls, int n, int m, double jitter,
                            const void* kbar, int tile, int grid, void* partial, void* ls_bar, void* ell_bar,
                            void* x_bar, cudaStream_t st) {
  const long long nm = static_cast<long long>(n) * m;
  const long long n_tiles = (nm + kGenTile - 1) / kGenTile;
  if (nm > 0x7fffffff || tile != kGenTile || n_tiles > 46340 || grid < 1 || grid > n_tiles * (n_tiles + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // Lf joins the stages where both still fit a block's shared memory (with
  // xbar, beside its two tables)
  const bool want_x = x_bar != nullptr;
  const size_t x_tabs = want_x ? 2 * GenBwd<T>::TAB * sizeof(double) : 0;
  const bool stage_l = GenBwd<T>::smem(m, true) <= kMaxSmem - x_tabs;
  const size_t smem = GenBwd<T>::smem(m, stage_l) + x_tabs;
  cudaError_t err = cudaFuncSetAttribute(svc_gram_tiled_bwd_generic_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  svc_gram_tiled_bwd_generic_kernel<T><<<grid, kGenBwdThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls), n, m,
      static_cast<T>(jitter), stage_l, static_cast<const T*>(kbar), static_cast<double*>(partial), want_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ks = m + (m + kGenBB - 1) / kGenBB * (want_x ? 2 : 1);
  const long long blocks = (nm * ks + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  svc_gram_tiled_bwd_generic_reduce<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<double*>(partial), static_cast<int>(n_tiles), n, m, static_cast<T*>(ls_bar), want_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  svc_gram_tiled_bwd_generic_finish<T><<<(n + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const double*>(partial), n, m, static_cast<T*>(ell_bar), static_cast<T*>(x_bar));
  return static_cast<int>(cudaGetLastError());
}

// For m <= 8, tile must be the backward's tile side for m (16 for m <= 4,
// else 8), and 1 <= grid <= the number of tile pairs of all n_batch
// members, which must fit an int; partial holds n_batch ceil(n/tile) n (m m
// + 1) values.  For m > 8 see launch_backward_generic; its launches run once
// per member, one after another on the stream, with one member's partial
// reused.
template <typename T>
int launch_backward(const void* x, const void* ell, const void* ls, int n, int m, int n_batch,
                    double jitter, const void* kbar, int tile, int grid, void* partial,
                    void* ls_bar, void* ell_bar, void* x_bar, void* stream) {
  if (n < 1 || m < 1 || n_batch < 1 || (x_bar != nullptr && n_batch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > kMaxM) {
    const size_t nm = static_cast<size_t>(n) * m, sz = sizeof(T);
    for (size_t b = 0; b < static_cast<size_t>(n_batch); ++b) {
      const int err = launch_backward_generic<T>(
          static_cast<const char*>(x), static_cast<const char*>(ell) + b * n * sz,
          static_cast<const char*>(ls) + b * nm * m * sz, n, m, jitter, static_cast<const char*>(kbar) + b * nm * nm * sz,
          tile, grid, partial, static_cast<char*>(ls_bar) + b * nm * m * sz,
          static_cast<char*>(ell_bar) + b * n * sz, x_bar, st);
      if (err != 0) return err;
    }
    return 0;
  }
  const int n_tiles = (n + tile - 1) / tile;
  const long long pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2 * n_batch;
  if (tile != (m <= 4 ? 16 : 8) || n_tiles > 46340 || pairs > 0x7fffffff || grid < 1 || grid > pairs ||
      static_cast<long long>(n) * n_batch > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(ell), static_cast<const T*>(ls), n, n_batch,
                     static_cast<T>(jitter), static_cast<const T*>(kbar), grid, static_cast<T*>(partial),
                     static_cast<T*>(ls_bar), static_cast<T*>(ell_bar), static_cast<T*>(x_bar), st};
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
  return launch_forward<float>(x, ell, ls, n, m, 1, jitter, vec, rows, warps, grid, out, stream);
}

int svc_gram_tiled_f64(const void* x, const void* ell, const void* ls, int n, int m,
                       double jitter, int vec, int rows, int warps, int grid, void* out,
                       void* stream) {
  return launch_forward<double>(x, ell, ls, n, m, 1, jitter, vec, rows, warps, grid, out, stream);
}

// partial: ceil(n/tile) * n * (m*m + 1) scratch values of the input's type
// (with x_bar, ceil(n/tile) * n more), or for m > 8 ceil(n m / tile) * (m +
// ceil(m / 3)) * n m doubles (with x_bar, ceil(n m / tile) * ceil(m / 3) * n
// m more); ls_bar (n, m, m); ell_bar (n,); x_bar (n,) or null (no gradient
// in x).  tile, grid: gram_kernels.k3_backward_schedule(n, m).
int svc_gram_tiled_backward_f32(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int grid,
                                void* partial, void* ls_bar, void* ell_bar, void* x_bar, void* stream) {
  return launch_backward<float>(x, ell, ls, n, m, 1, jitter, kbar, tile, grid, partial,
                                       ls_bar, ell_bar, x_bar, stream);
}

int svc_gram_tiled_backward_f64(const void* x, const void* ell, const void* ls, int n, int m,
                                double jitter, const void* kbar, int tile, int grid,
                                void* partial, void* ls_bar, void* ell_bar, void* x_bar, void* stream) {
  return launch_backward<double>(x, ell, ls, n, m, 1, jitter, kbar, tile, grid, partial,
                                        ls_bar, ell_bar, x_bar, stream);
}

// A batch of b Grams over shared x (n,): ell (b, n), ls (b, n, m, m), out
// (b, n m, n m).  vec, rows, warps, grid: gram_kernels.k3_forward_schedule(n,
// m, dtype, batch=b).
int svc_gram_tiled_batched_f32(const void* x, const void* ell, const void* ls, int n, int m, int b,
                               double jitter, int vec, int rows, int warps, int grid, void* out,
                               void* stream) {
  return launch_forward<float>(x, ell, ls, n, m, b, jitter, vec, rows, warps, grid, out, stream);
}

int svc_gram_tiled_batched_f64(const void* x, const void* ell, const void* ls, int n, int m, int b,
                               double jitter, int vec, int rows, int warps, int grid, void* out,
                               void* stream) {
  return launch_forward<double>(x, ell, ls, n, m, b, jitter, vec, rows, warps, grid, out, stream);
}

// kbar (b, n m, n m); partial: b times a single Gram's (m <= 8), one
// Gram's (m > 8); ls_bar (b, n, m, m); ell_bar (b, n).  tile, grid:
// gram_kernels.k3_backward_schedule(n, m, batch=b).
int svc_gram_tiled_batched_backward_f32(const void* x, const void* ell, const void* ls, int n, int m, int b,
                                        double jitter, const void* kbar, int tile, int grid,
                                        void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<float>(x, ell, ls, n, m, b, jitter, kbar, tile, grid, partial,
                                      ls_bar, ell_bar, nullptr, stream);
}

int svc_gram_tiled_batched_backward_f64(const void* x, const void* ell, const void* ls, int n, int m, int b,
                                        double jitter, const void* kbar, int tile, int grid,
                                        void* partial, void* ls_bar, void* ell_bar, void* stream) {
  return launch_backward<double>(x, ell, ls, n, m, b, jitter, kbar, tile, grid, partial,
                                       ls_bar, ell_bar, nullptr, stream);
}

}  // extern "C"
