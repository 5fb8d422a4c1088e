"""Visualization layer: pure-Python binary GLB writer (``glb``), colormaps,
result and preview GLBs (``results``), pressure arrows (``arrows``) — port of
``tpufem/viz`` (numpy; the files it writes are byte-identical to tpufem's on
the same inputs).

Replaces the reference's PyVista/VTK + trimesh export stack (viz.py:18-99,
viz_results.py): GLB is a simple JSON+BIN container, and the reference
standardizes on vertex-color GLB (docs/spec.md:37-41).
"""
