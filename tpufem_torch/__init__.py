"""tpufem_torch — the PyTorch / CUDA (NVIDIA Hopper, sm_90a) port of tpufem.

Module names mirror ``tpufem/`` so each piece has an obvious counterpart; the
JAX package stays the reference the port is tested against. This package
imports torch, numpy and scipy only — never jax, flax, optax, pydantic or
matplotlib, and nothing from ``tpufem`` (whose ``__init__`` imports JAX).

What runs here today: a batch of wing designs -> the DOF100K structured
Kuhn-tet4 mesh -> the f64-outer multigrid-preconditioned CG solve
(``fem.stencil_mg.WingStencilT``) -> von Mises -> surface graphs -> the
GraphSAGE surrogate (``models.sage.GraphSAGE``); the surrogate workflow
around it: the dataset CLIs, training and inference (``scripts/``); the
gather-path FEM stage for user meshes; and the dynamics: modal analysis,
linearized buckling and the stress-stiffened spectrum (``fem.modal``,
``fem.buckling``) with their CLIs.

Hand-written CUDA kernels (``csrc/``, built on first use into ``build/``):
  - ``ops.gather_scatter``: A (SAGE mean aggregation), C (its backward)
  - ``fem.stencil.strain_apply``         (B: the grid FEM operator)
  - ``fem.assembly.stiffness_apply``     (D: the gather FEM operator)
  - ``ops.csr_segment_sum``              (E: fixed-order sums)
  - ``fem.buckling.element_stress``      (F: per-tet pre-stress)
  - ``fem.buckling.geom_apply``          (G: the geometric stiffness)
On a CPU tensor each wrapper runs its plain PyTorch version instead.
"""

import torch as _torch

# Every float32 product in the port is meant to be a float32 product, as in
# tpufem (whose matmuls run at precision="highest"). TF32 keeps ~3 decimal
# digits: it would make the f32 V-cycle a weaker preconditioner and move the
# surrogate's outputs by ~1e-3. Matmul TF32 is off by default, cuDNN's is
# not, so both are pinned here, where every module of the port passes.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
