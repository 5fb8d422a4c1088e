"""Result GLB writers — copy of ``tpufem/viz/results.py``; parity with reference viz.py:73-99 (stl_to_glb) and
viz_results.py:105-240 (surface_results_to_glb[_with_extras]):
  - faces remapped from global node-id space to dense 0..N-1 (viz_results.py:130-143)
  - auto color range = [min, p98] of masked stress (viz_results.py:149-158)
  - per-vertex viridis RGBA; arrows/extras as separate GLB nodes
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpufem_torch.utils.stl import read_stl
from tpufem_torch.viz.colormaps import normalize_range, viridis
from tpufem_torch.viz.glb import GLBMesh, write_glb


def stl_to_glb(stl_path: Path | str, glb_path: Path | str) -> None:
    """Plain gray preview GLB from an STL (reference viz.py:73-99)."""
    verts, faces = read_stl(stl_path)
    gray = np.full((len(verts), 4), [0.7, 0.7, 0.75, 1.0])
    write_glb(glb_path, GLBMesh(vertices=verts, faces=faces, colors=gray, name="wing"))


def _remap_surface(node_id: np.ndarray, faces_global: np.ndarray) -> np.ndarray:
    """Global-node-id faces -> dense surface-local indices (viz_results.py:130-143)."""
    remap = np.full(int(node_id.max()) + 1, -1, dtype=np.int64)
    remap[node_id] = np.arange(len(node_id))
    f = remap[faces_global]
    if (f < 0).any():
        raise ValueError("surface face references node outside surface node set")
    return f


def color_range_from_masked(values: np.ndarray, mask: np.ndarray) -> tuple[float, float]:
    """[min, p98] of masked values (viz_results.py:149-158)."""
    sel = values[np.asarray(mask, dtype=bool)] if mask is not None else values
    if len(sel) == 0:
        sel = values
    return float(sel.min()), float(np.percentile(sel, 98))


def surface_results_to_glb(
    glb_path: Path | str,
    surface: dict[str, np.ndarray],
    faces_global: np.ndarray,
    values: np.ndarray | None = None,
    vmin: float | None = None,
    vmax: float | None = None,
    colormap=viridis,
) -> tuple[float, float]:
    """Write the colored result GLB; returns the (vmin, vmax) range used."""
    vals = surface["stress_vm"] if values is None else values
    if vmin is None or vmax is None:
        auto = color_range_from_masked(vals, surface.get("loss_mask"))
        vmin = auto[0] if vmin is None else vmin
        vmax = auto[1] if vmax is None else vmax
    faces = _remap_surface(surface["node_id"], faces_global)
    rgb = colormap(normalize_range(vals, vmin, vmax))
    rgba = np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)
    write_glb(
        glb_path,
        GLBMesh(vertices=surface["pos"], faces=faces, colors=rgba, name="result"),
    )
    return vmin, vmax


def surface_results_to_glb_with_extras(
    glb_path: Path | str,
    surface: dict[str, np.ndarray],
    faces_global: np.ndarray,
    extras: list[GLBMesh],
    values: np.ndarray | None = None,
    vmin: float | None = None,
    vmax: float | None = None,
    colormap=viridis,
) -> tuple[float, float]:
    """Result mesh + extra glyph meshes in one GLB (viz_results.py:177-240)."""
    vals = surface["stress_vm"] if values is None else values
    if vmin is None or vmax is None:
        auto = color_range_from_masked(vals, surface.get("loss_mask"))
        vmin = auto[0] if vmin is None else vmin
        vmax = auto[1] if vmax is None else vmax
    faces = _remap_surface(surface["node_id"], faces_global)
    rgb = colormap(normalize_range(vals, vmin, vmax))
    rgba = np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)
    meshes = [GLBMesh(vertices=surface["pos"], faces=faces, colors=rgba, name="result")]
    meshes.extend(extras)
    write_glb(glb_path, meshes)
    return vmin, vmax
