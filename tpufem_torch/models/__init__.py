"""Surrogate: surface graphs, GraphSAGE (nn.Module), metrics, dataset, trainer."""
