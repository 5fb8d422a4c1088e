"""Case-directory dataset: discovery, graph cache, reproducible splits — port
of ``tpufem/models/dataset.py``.

Parity with reference gnn/dataset.py:168-328 (`WingStressDataset`):
  - discovers cases where all three stage artifacts exist (:239-250)
  - seeded permutation split 0.7/0.15/0.15 (:289-298)
  - caches processed graphs (here: one .npz per split instead of torch .pt)
  - writes split_info_s{seed}.json with the case ids per split (:314-328)

Graphs are padded to the max (nodes, edges) across the dataset so every split
stacks into fixed-shape device tensors.

Repaired against tpufem: ``cache=False`` reaches ``load_case_graph``, so an
uncached dataset writes and reads no per-case graph cache under
processed/raw/ (tpufem's graphs() and _max_dims() dropped the flag).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpufem_torch.models.graph import GraphData, build_graph, pad_graph
from tpufem_torch.pipeline.config import Paths


def discover_cases(paths: Paths) -> list[str]:
    """Case ids with params.json + boundary_sets.json + surface_results.npz."""
    out = []
    if not paths.fem.exists():
        return out
    for d in sorted(paths.fem.iterdir()):
        cid = d.name
        if (
            (d / "surface_results.npz").exists()
            and (paths.geometry_case(cid) / "params.json").exists()
            and (paths.mesh_case(cid) / "boundary_sets.json").exists()
        ):
            out.append(cid)
    return out


def load_case_graph(case_id: str, paths: Paths, cache: bool = True) -> GraphData:
    """Build (or load from the per-case raw cache) one unpadded case graph.

    The per-case cache under processed/raw/ lets graph building overlap a
    still-running FEM batch (each case is cacheable the moment its artifacts
    land) and makes dataset-wide rebuilds O(load) instead of O(build). Keyed
    by the surface_results.npz size+mtime, same staleness contract as the
    split caches.
    """
    npz_p = paths.fem_case(case_id) / "surface_results.npz"
    cache_p = None
    if cache:
        st = npz_p.stat()
        raw_dir = paths.processed / "raw"
        cache_p = raw_dir / f"{case_id}_{st.st_size}_{st.st_mtime_ns}.npz"
        if cache_p.exists():
            z = np.load(cache_p)
            return GraphData(**{k: z[k] for k in z.files if k not in ("num_nodes", "num_edges")},
                             num_nodes=int(z["num_nodes"]), num_edges=int(z["num_edges"]))
    surf = dict(np.load(npz_p))
    params = json.loads((paths.geometry_case(case_id) / "params.json").read_text())["params"]
    mesh_npz = np.load(paths.mesh_case(case_id) / "mesh.npz")
    sets = json.loads((paths.mesh_case(case_id) / "boundary_sets.json").read_text())
    faces = mesh_npz["surf_faces"][np.asarray(sets["surf_all_faces"], dtype=np.int64)]
    g = build_graph(surf, faces, params)
    if cache_p is not None:
        cache_p.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache_p.with_suffix(".tmp.npz")
        np.savez(tmp, x=g.x, edge_index=g.edge_index, edge_mask=g.edge_mask,
                 y=g.y, stress_vm=g.stress_vm, disp=g.disp, loss_mask=g.loss_mask,
                 node_mask=g.node_mask, num_nodes=g.num_nodes, num_edges=g.num_edges)
        tmp.replace(cache_p)
    return g


def split_cases(case_ids: list[str], seed: int = 42,
                fractions=(0.7, 0.15, 0.15)) -> dict[str, list[str]]:
    """Seeded permutation split (reference dataset.py:289-298)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(case_ids))
    n = len(case_ids)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    ids = np.asarray(case_ids)
    return {
        "train": ids[perm[:n_train]].tolist(),
        "val": ids[perm[n_train : n_train + n_val]].tolist(),
        "test": ids[perm[n_train + n_val :]].tolist(),
    }


class WingStressDataset:
    """Loads (and caches) padded graphs for train/val/test splits."""

    def __init__(self, paths: Paths, seed: int = 42, cache: bool = True):
        self.paths = paths
        self.seed = seed
        self.cache_dir = paths.processed
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.case_ids = discover_cases(paths)
        if not self.case_ids:
            raise FileNotFoundError(f"no complete cases under {paths.raw}")
        self.splits = split_cases(self.case_ids, seed)
        info_path = self.cache_dir / f"split_info_s{seed}.json"
        info_path.write_text(json.dumps(self.splits, indent=2))
        self._graphs: dict[str, list[GraphData]] | None = None
        self.use_cache = cache
        # cache keys carry a fingerprint of the case set AND the FEM artifact
        # files (size + mtime): a case-id-only key would serve stale graphs
        # after re-solving the same cases (e.g. a different engine or tol)
        import hashlib

        h = hashlib.sha256()
        for cid in sorted(self.case_ids):
            h.update(cid.encode())
            npz = paths.fem_case(cid) / "surface_results.npz"
            try:
                st = npz.stat()
                h.update(f":{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                h.update(b":missing")
        self._fp = h.hexdigest()[:10]

    def graphs(self, split: str) -> list[GraphData]:
        cache_p = self.cache_dir / f"{split}_s{self.seed}_{self._fp}.npz"
        if self.use_cache and cache_p.exists():
            return _load_graphs_npz(cache_p)
        if self.use_cache:
            # one pass over the dataset builds EVERY split's cache: each case
            # graph is built exactly once (graph build at reference-scale
            # meshes is ~1 s/case on one host core, and the naive path builds
            # each case twice — once for max-dims, once for its split)
            return self._build_all_caches()[split]
        raw = [load_case_graph(cid, self.paths, cache=False) for cid in self.splits[split]]
        if not raw:
            return []
        # pad to dataset-wide max so all splits share shapes
        all_ids = self.case_ids
        n_max, e_max = self._max_dims(all_ids)
        padded = [pad_graph(g, n_max, e_max) for g in raw]
        return padded

    def _build_all_caches(self) -> dict[str, list[GraphData]]:
        raw = {cid: load_case_graph(cid, self.paths) for cid in self.case_ids}
        n_max = max(g.num_nodes for g in raw.values())
        e_max = max(g.num_edges for g in raw.values())
        # round up to multiples of 128
        n_max = -(-n_max // 128) * 128
        e_max = -(-e_max // 128) * 128
        dims_p = self.cache_dir / f"dims_s{self.seed}_{self._fp}.json"
        dims_p.write_text(json.dumps({"n_max": n_max, "e_max": e_max}))
        out: dict[str, list[GraphData]] = {}
        for split, ids in self.splits.items():
            padded = [pad_graph(raw[cid], n_max, e_max) for cid in ids]
            if padded:
                _save_graphs_npz(
                    self.cache_dir / f"{split}_s{self.seed}_{self._fp}.npz", padded
                )
            out[split] = padded
        return out

    def _max_dims(self, case_ids: list[str]) -> tuple[int, int]:
        dims_p = self.cache_dir / f"dims_s{self.seed}_{self._fp}.json"
        if self.use_cache and dims_p.exists():
            d = json.loads(dims_p.read_text())
            return d["n_max"], d["e_max"]
        n_max = e_max = 0
        for cid in case_ids:
            g = load_case_graph(cid, self.paths, cache=self.use_cache)
            n_max = max(n_max, g.num_nodes)
            e_max = max(e_max, g.num_edges)
        # round up to multiples of 128
        n_max = -(-n_max // 128) * 128
        e_max = -(-e_max // 128) * 128
        if self.use_cache:
            dims_p.write_text(json.dumps({"n_max": n_max, "e_max": e_max}))
        return n_max, e_max


def _save_graphs_npz(path: Path, graphs: list[GraphData]) -> None:
    np.savez_compressed(
        path,
        x=np.stack([g.x for g in graphs]),
        edge_index=np.stack([g.edge_index for g in graphs]),
        edge_mask=np.stack([g.edge_mask for g in graphs]),
        y=np.stack([g.y for g in graphs]),
        stress_vm=np.stack([g.stress_vm for g in graphs]),
        disp=np.stack([g.disp for g in graphs]),
        loss_mask=np.stack([g.loss_mask for g in graphs]),
        node_mask=np.stack([g.node_mask for g in graphs]),
        num_nodes=np.array([g.num_nodes for g in graphs]),
        num_edges=np.array([g.num_edges for g in graphs]),
    )


def _load_graphs_npz(path: Path) -> list[GraphData]:
    z = np.load(path)
    out = []
    for i in range(len(z["num_nodes"])):
        out.append(
            GraphData(
                x=z["x"][i],
                edge_index=z["edge_index"][i],
                edge_mask=z["edge_mask"][i],
                y=z["y"][i],
                stress_vm=z["stress_vm"][i],
                disp=z["disp"][i],
                loss_mask=z["loss_mask"][i],
                node_mask=z["node_mask"][i],
                num_nodes=int(z["num_nodes"][i]),
                num_edges=int(z["num_edges"][i]),
            )
        )
    return out
