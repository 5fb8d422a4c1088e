// Kernel L: the welded, Dirichlet-wrapped tet10 (quadratic) operator on the
// doubled structured wing grid, one launch per operator apply.
//
// Replaces tpufem/fem/tet10_stencil.py:233 strain_apply10 (jnp code that XLA
// fused on the TPU; the operator every tet10 p-multigrid CG iteration applies
// once and every V-cycle 4 times). One launch computes the whole function
//
//   y = R2( K10( S2(u * free) ) ) * free + u * (1 - free)
//
// on the doubled grid (NI2, NK2, NJ2) = (2 NI - 1, 2 NK - 1, 2 NJ - 1): every
// tet10 node is a position of it, a tet4 corner at all-even indices and the
// midpoint of one Kuhn-lattice edge elsewhere. S2 (weld spread) and the root
// mask `free` (an NJ2 vector) are applied as u is loaded, R2 (weld reduce),
// the mask and the Dirichlet identity as y is stored. The welds: the leading
// edge column i2 = 0 is one node through the thickness (k2 = 0), the pairs at
// i2 = 1 merge (odd k2 into k2 + 1), and with weld_te the same at i2 = NI2 - 1
// and i2 = NI2 - 2 (odd k2 into k2 - 1). K10 is, per Kuhn tet t of every cell
// and Gauss point q (equal weights vol / 4),
//
//   v_j = sum_m DNDXI[q][m][j] u_m,  H = sum_j grad(lambda_j) (x) v_j,
//   sigma = 2 mu eps(H) + lam tr(eps) I,  s_j = (vol / 4) sigma . grad(lambda_j),
//   f_m += sum_j DNDXI[q][m][j] s_j
//
// over the tet's 10 nodes m, from the per-tet gradients g (6,4,3,B,nc,nt,ns)
// (grad lambda_1..3 are g[t, 1..3]), volumes vol (6,B,nc,nt,ns) and u, y
// (3,B,NI2,NK2,NJ2), all contiguous, in tpufem's layouts.
//
// Design: a block owns own_j x own_i tet4 node columns of one lane at full
// thickness, i.e. the doubled positions i2 in [2 n0i, 2 (n0i + own_i)) and j2
// likewise, and evaluates every cell that touches them, (own_i + 1) x nt x
// (own_j + 1) cells with a halo row and column on the low side (computed by the
// neighbouring block as well), as grid_tile.cuh does for tet4. A thread per
// cell walks its 6 tets in turn (a tet's 10 node displacements and 10 node
// forces in registers, summed over the 4 Gauss points) and adds each tet's
// node forces into the cell's 27 positions x 3 in shared memory, which only it
// writes. One barrier, then a
// thread per owned position sums the shares of its <= 8 incident cells in a
// fixed order, with R2 (a weld position adds its partners' sums in a fixed
// order), then the mask and the identity: no atomics, so two calls give the
// same bits. DNDXI sits in constant memory (every thread reads the same entry
// at once). Every index is 32-bit; the wrapper checks that every operand has
// fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stddef.h>

#include "grid_tet.cuh"

namespace {

using grid_tet::corner_di;
using grid_tet::corner_dj;
using grid_tet::corner_dk;

// DNDXI[q][m][j], the shape-function gradients at the Gauss points
// (tpufem_torch/fem/tet10.py::DNDXI)
#define TPUFEM_DNDXI                                                                           \
  {{{-1.341640786499874, -1.341640786499874, -1.341640786499874},                             \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {1.788854381999832, -0.5527864045000421, -0.5527864045000421},                             \
    {0.5527864045000421, 0.5527864045000421, 0.0},                                             \
    {-0.5527864045000421, 1.788854381999832, -0.5527864045000421},                             \
    {-0.5527864045000421, -0.5527864045000421, 1.788854381999832},                             \
    {0.5527864045000421, 0.0, 0.5527864045000421},                                             \
    {0.0, 0.5527864045000421, 0.5527864045000421}},                                            \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {1.341640786499874, 0.0, 0.0},                                                             \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {-1.788854381999832, -2.341640786499874, -2.341640786499874},                              \
    {0.5527864045000421, 2.341640786499874, 0.0},                                              \
    {-0.5527864045000421, 0.0, -0.5527864045000421},                                           \
    {-0.5527864045000421, -0.5527864045000421, 0.0},                                           \
    {0.5527864045000421, 0.0, 2.341640786499874},                                              \
    {0.0, 0.5527864045000421, 0.5527864045000421}},                                            \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, 1.341640786499874, 0.0},                                                             \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {0.0, -0.5527864045000421, -0.5527864045000421},                                           \
    {2.341640786499874, 0.5527864045000421, 0.0},                                              \
    {-2.341640786499874, -1.788854381999832, -2.341640786499874},                              \
    {-0.5527864045000421, -0.5527864045000421, 0.0},                                           \
    {0.5527864045000421, 0.0, 0.5527864045000421},                                             \
    {0.0, 0.5527864045000421, 2.341640786499874}},                                             \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, 1.341640786499874},                                                             \
    {0.0, -0.5527864045000421, -0.5527864045000421},                                           \
    {0.5527864045000421, 0.5527864045000421, 0.0},                                             \
    {-0.5527864045000421, 0.0, -0.5527864045000421},                                           \
    {-2.341640786499874, -2.341640786499874, -1.788854381999832},                              \
    {2.341640786499874, 0.0, 0.5527864045000421},                                              \
    {0.0, 2.341640786499874, 0.5527864045000421}}}

__constant__ double kDndxi64[4][10][3] = TPUFEM_DNDXI;
__constant__ float kDndxi32[4][10][3] = TPUFEM_DNDXI;

template <typename T>
__device__ __forceinline__ T dndxi(int q, int m, int j);
template <>
__device__ __forceinline__ double dndxi<double>(int q, int m, int j) {
  return kDndxi64[q][m][j];
}
template <>
__device__ __forceinline__ float dndxi<float>(int q, int m, int j) {
  return kDndxi32[q][m][j];
}

// The tet10 node m of Kuhn tet t as a cell-local doubled offset (oi, ok, oj)
// in {0, 1, 2}^3, packed (oi * 3 + ok) * 3 + oj: corners m = 0..3 at twice
// their hex corner, midsides m = 4..9 at the sum of their edge's two corners
// (edges (0,1), (1,2), (2,0), (0,3), (1,3), (2,3): tet10.py::_EDGES). t is
// known at run time (the tet loop is not unrolled, so the compiler does not
// hoist the next tets' loads over this one's registers), m at compile time.
__device__ __forceinline__ int pos27(int t, int m) {
  constexpr int ea[6] = {0, 1, 2, 0, 1, 2}, eb[6] = {1, 2, 0, 3, 3, 3};
  const int ca = grid_tet::kuhn_rt(t, m < 4 ? m : ea[m - 4]);
  const int cb = grid_tet::kuhn_rt(t, m < 4 ? m : eb[m - 4]);
  return ((corner_di(ca) + corner_di(cb)) * 3 + corner_dk(ca) + corner_dk(cb)) * 3 +
         corner_dj(ca) + corner_dj(cb);
}

// The layer a field is read from at doubled position (i2, k2): the weld spread S2
__device__ __forceinline__ int weld_k2(int i2, int k2, int NI2, int weld_te) {
  if (i2 == 0 || (weld_te && i2 == NI2 - 1)) return 0;
  if (i2 == 1 && (k2 & 1)) return k2 + 1;
  if (weld_te && i2 == NI2 - 2 && (k2 & 1)) return k2 - 1;
  return k2;
}

template <typename T>
struct Args {
  const T* g;
  const T* vol;
  const T* u;
  const T* free;
  T* y;
  int B, NI2, NK2, NJ2, weld_te;
  T lam, mu;
};

struct Tile {
  int own_j, own_i;  // owned tet4 node columns along span and chord
};

constexpr int kThreads = 256;
constexpr int kCells = 256;       // the most cells per tile (a thread each)
constexpr int kSlots = 27 * 3;    // a cell's positions x components in shared memory
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a Hopper block takes

template <typename T>
constexpr size_t smem_bytes(Tile t, int nt) {
  return static_cast<size_t>(kSlots) * (t.own_j + 1) * (t.own_i + 1) * nt * sizeof(T);
}

// The widest tile, from 8 span columns down, whose kCells cells' shares fit
// in shared memory (own_i chord rows fill the rest of kCells)
template <typename T>
Tile tile_of(int nt) {
  for (int own_j = 8;; own_j /= 2) {
    Tile t{own_j, kCells / ((own_j + 1) * nt) - 1};
    if (t.own_i < 1) t.own_i = 1;
    if (smem_bytes<T>(t, nt) <= static_cast<size_t>(kMaxSmem) || own_j == 1) return t;
  }
}

// One tet of the thread's cell: its node forces added into the cell's shares sc
template <typename T>
__device__ __forceinline__ void tet_forces(const Args<T>& p, int t, int b, int cell, int cplane,
                                           int ci, int ck, int cj, T* sc, int ncell) {
  const int B = p.B, NK2 = p.NK2, NJ2 = p.NJ2;
  const int ustride = B * p.NI2 * NK2 * NJ2;
  const T* ub = p.u + b * p.NI2 * NK2 * NJ2;
  T gv[3][3];  // grad lambda_1..3
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      gv[a][d] = __ldg(p.g + ((((t * 4 + a + 1) * 3 + d) * B + b) * cplane) + cell);
  const T wq = T(0.25) * __ldg(p.vol + (t * B + b) * cplane + cell);
  T un[10][3];
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const int o = pos27(t, m);
    const int i2 = 2 * ci + o / 9, k2 = 2 * ck + (o / 3) % 3, j2 = 2 * cj + o % 3;
    const int kr = weld_k2(i2, k2, p.NI2, p.weld_te);
    const T fr = __ldg(p.free + j2);
    const int node = (i2 * NK2 + kr) * NJ2 + j2;
#pragma unroll
    for (int e = 0; e < 3; ++e) un[m][e] = __ldg(ub + e * ustride + node) * fr;
  }
  T f[10][3];  // the tet's node forces, summed over the Gauss points
#pragma unroll
  for (int m = 0; m < 10; ++m)
#pragma unroll
    for (int d = 0; d < 3; ++d) f[m][d] = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T v[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        T acc = T(0);
#pragma unroll
        for (int m = 0; m < 10; ++m) acc += dndxi<T>(q, m, j) * un[m][e];
        v[j][e] = acc;
      }
    T H[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        H[d][e] = gv[0][d] * v[0][e] + gv[1][d] * v[1][e] + gv[2][d] * v[2][e];
    const T tr = H[0][0] + H[1][1] + H[2][2];
    T sw[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int e = 0; e < 3; ++e) sw[d][e] = p.mu * (H[d][e] + H[e][d]);  // 2 mu eps
      sw[d][d] += p.lam * tr;
#pragma unroll
      for (int e = 0; e < 3; ++e) sw[d][e] *= wq;
    }
    T s[3][3];  // s[j][d] = wq * sum_e sigma[d][e] * grad(lambda_j)[e]
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s[j][d] = sw[d][0] * gv[j][0] + sw[d][1] * gv[j][1] + sw[d][2] * gv[j][2];
#pragma unroll
    for (int m = 0; m < 10; ++m)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        f[m][d] += dndxi<T>(q, m, 0) * s[0][d] + dndxi<T>(q, m, 1) * s[1][d] +
                   dndxi<T>(q, m, 2) * s[2][d];
  }
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    T* sm = sc + pos27(t, m) * 3 * ncell;
#pragma unroll
    for (int d = 0; d < 3; ++d) sm[d * ncell] += f[m][d];
  }
}

// The shares of the cells incident to doubled position (i2, k2, j2), summed in
// a fixed order (cells along i, then k, then j, low before high), into f
template <typename T>
__device__ __forceinline__ void position_sum(const T* sf, int ncell, int i2, int k2, int j2,
                                             int c0i, int c0j, int TJ, int nc, int nt, int ns,
                                             T (&f)[3]) {
#pragma unroll
  for (int ai = 0; ai < 2; ++ai) {
    const int oi = (i2 & 1) ? 1 : 2 * (1 - ai), ci = (i2 - oi) / 2;
    if ((i2 & 1) && ai) break;
    if (ci < 0 || ci >= nc) continue;
#pragma unroll
    for (int ak = 0; ak < 2; ++ak) {
      const int ok = (k2 & 1) ? 1 : 2 * (1 - ak), ck = (k2 - ok) / 2;
      if ((k2 & 1) && ak) break;
      if (ck < 0 || ck >= nt) continue;
#pragma unroll
      for (int aj = 0; aj < 2; ++aj) {
        const int oj = (j2 & 1) ? 1 : 2 * (1 - aj), cj = (j2 - oj) / 2;
        if ((j2 & 1) && aj) break;
        if (cj < 0 || cj >= ns) continue;
        const int c = ((ci - c0i) * nt + ck) * TJ + (cj - c0j);
        const T* sp = sf + ((oi * 3 + ok) * 3 + oj) * 3 * ncell + c;
#pragma unroll
        for (int e = 0; e < 3; ++e) f[e] += sp[e * ncell];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) strain_apply10_kernel(Args<T> p, Tile tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [position 27][3][ncell]

  const int NI2 = p.NI2, NK2 = p.NK2, NJ2 = p.NJ2;
  const int nc = (NI2 - 1) / 2, nt = (NK2 - 1) / 2, ns = (NJ2 - 1) / 2;
  const int cplane = nc * nt * ns;
  const int b = blockIdx.z;
  const int n0i = blockIdx.y * tile.own_i, n0j = blockIdx.x * tile.own_j;  // first owned column
  const int c0i = n0i - 1, c0j = n0j - 1;                                 // first computed cell
  const int TJ = tile.own_j + 1;
  const int ncell = (tile.own_i + 1) * nt * TJ;  // cell c = (li * nt + ck) * TJ + lj

  for (int c = threadIdx.x; c < ncell; c += kThreads) {
    T* sc = sf + c;
#pragma unroll 9
    for (int s = 0; s < kSlots; ++s) sc[s * ncell] = T(0);
    const int lj = c % TJ, r = c / TJ;
    const int ck = r % nt, ci = c0i + r / nt, cj = c0j + lj;
    if (ci < 0 || ci >= nc || cj < 0 || cj >= ns) continue;
    const int cell = (ci * nt + ck) * ns + cj;
#pragma unroll 1
    for (int t = 0; t < 6; ++t) tet_forces<T>(p, t, b, cell, cplane, ci, ck, cj, sc, ncell);
  }
  __syncthreads();

  const int uplane = NI2 * NK2 * NJ2, ustride = p.B * uplane;
  const int own_i2 = 2 * tile.own_i, own_j2 = 2 * tile.own_j;
  for (int n = threadIdx.x; n < own_i2 * NK2 * own_j2; n += kThreads) {
    const int oj2 = n % own_j2, r = n / own_j2;
    const int k2 = r % NK2, i2 = 2 * n0i + r / NK2, j2 = 2 * n0j + oj2;
    if (i2 >= NI2 || j2 >= NJ2) continue;
    // R2: the layers whose sums land at (i2, k2), in a fixed order
    int k_lo = k2, k_hi = k2;  // a contiguous run of layers
    const bool le_col = i2 == 0, te_col = p.weld_te && i2 == NI2 - 1;
    const bool le_pair = i2 == 1, te_pair = p.weld_te && i2 == NI2 - 2;
    if (le_col || te_col) {
      k_hi = k2 == 0 ? NK2 - 1 : -1;  // the column's sum at k2 = 0, zero above
    } else if (le_pair) {
      if (k2 & 1) k_hi = -1;   // merged into k2 + 1
      else if (k2 > 0) k_lo = k2 - 1;
    } else if (te_pair) {
      if (k2 & 1) k_hi = -1;   // merged into k2 - 1
      else if (k2 < NK2 - 1) k_hi = k2 + 1;
    }
    T f[3] = {T(0), T(0), T(0)};
    for (int kk = k_lo; kk <= k_hi; ++kk)
      position_sum<T>(sf, ncell, i2, kk, j2, c0i, c0j, TJ, nc, nt, ns, f);
    const T fr = __ldg(p.free + j2);
    const int node = b * uplane + (i2 * NK2 + k2) * NJ2 + j2;
#pragma unroll
    for (int e = 0; e < 3; ++e)
      p.y[e * ustride + node] =
          grid_tet::masked_store<true>(f[e], fr, __ldg(p.u + e * ustride + node));
  }
}

template <typename T>
int launch(const void* g, const void* vol, const void* u, const void* free, void* y, int B,
           int NI2, int NK2, int NJ2, int weld_te, double lam, double mu, void* stream) {
  if (B <= 0) return 0;
  if (NI2 < 5 || NK2 < 3 || NJ2 < 3 || NI2 % 2 == 0 || NK2 % 2 == 0 || NJ2 % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(g), static_cast<const T*>(vol), static_cast<const T*>(u),
                  static_cast<const T*>(free), static_cast<T*>(y), B, NI2, NK2, NJ2, weld_te,
                  static_cast<T>(lam), static_cast<T>(mu)};
  const int nt = (NK2 - 1) / 2, NI = (NI2 + 1) / 2, NJ = (NJ2 + 1) / 2;
  const Tile t = tile_of<T>(nt);
  const size_t smem = smem_bytes<T>(t, nt);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      strain_apply10_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((NJ + t.own_j - 1) / t.own_j, (NI + t.own_i - 1) / t.own_i, B);
  strain_apply10_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype; free is the NJ2 root
// mask. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue on
// a grid the kernel does not take).
extern "C" int tpufem_strain_apply10_f32(const void* g, const void* vol, const void* u,
                                         const void* free, void* y, int B, int NI2, int NK2,
                                         int NJ2, int weld_te, double lam, double mu,
                                         void* stream) {
  return launch<float>(g, vol, u, free, y, B, NI2, NK2, NJ2, weld_te, lam, mu, stream);
}

extern "C" int tpufem_strain_apply10_f64(const void* g, const void* vol, const void* u,
                                         const void* free, void* y, int B, int NI2, int NK2,
                                         int NJ2, int weld_te, double lam, double mu,
                                         void* stream) {
  return launch<double>(g, vol, u, free, y, B, NI2, NK2, NJ2, weld_te, lam, mu, stream);
}
