"""Re-export any wing_viz.glb that is not a binary GLB — port of
``scripts/repair_geometry_glb.py`` (parity with reference
scripts/repair_geometry_glb.py:15-55: magic != b'glTF' -> rebuild from
wing.stl).

    python -m tpufem_torch.scripts.repair_geometry_glb --data_root DIR
"""

from __future__ import annotations

import argparse

from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.viz.glb import is_binary_glb
from tpufem_torch.viz.results import stl_to_glb


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    args = ap.parse_args(argv)
    paths = get_paths(args.data_root)
    repaired = skipped = 0
    if not paths.geometry.exists():
        print("no geometry dir")
        return 0
    for case_dir in sorted(paths.geometry.iterdir()):
        glb = case_dir / "wing_viz.glb"
        stl = case_dir / "wing.stl"
        if glb.exists() and not is_binary_glb(glb) and stl.exists():
            stl_to_glb(stl, glb)
            repaired += 1
            print(f"repaired {glb}")
        else:
            skipped += 1
    print(f"done: {repaired} repaired, {skipped} ok/skipped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
