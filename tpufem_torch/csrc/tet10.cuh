// The quadratic tet's reference data, shared by kernel L (csrc/strain_apply10.cu,
// the doubled-grid operator) and kernel N (csrc/tet10_force.cu, the incidence
// operator): the shape-function gradients at the 4 Gauss points as
// compile-time constants, and a loop whose index is a constant expression, so
// that a kernel body that walks DNDXI folds its exact zeros away and takes the
// other entries as immediates.
#pragma once

#include <type_traits>
#include <utility>

namespace tet10 {

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

// DNDXI[q][m][j] as a constant expression (called only with constant indices)
__host__ __device__ constexpr double dndxi(int q, int m, int j) {
  constexpr double kTable[4][10][3] = TPUFEM_DNDXI;
  return kTable[q][m][j];
}

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>): a loop
// whose index is a constant expression in the body
template <typename F, int... I>
__device__ __forceinline__ void static_for_(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

}  // namespace tet10
