"""The dataset pipeline: paths, case ids, report schemas and writers, and the
geometry / mesh / FEM stages the CLIs in ``tpufem_torch.scripts`` drive."""
