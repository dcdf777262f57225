"""Vertex-clustering mesh simplification CLI (port of
neural_graph_mapping_tpu.vis.simplify_mesh).

Usage: python -m neural_graph_mapping_tpu_torch.vis.simplify_mesh in.ply out.ply [voxel]
"""

from __future__ import annotations

import sys

from neural_graph_mapping_tpu_torch.utils import meshio


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit("usage: simplify_mesh <in.ply> <out.ply> [voxel_size=0.02]")
    voxel = float(argv[2]) if len(argv) > 2 else 0.02
    mesh = meshio.load_ply(argv[0])
    simplified = mesh.simplify(voxel)
    meshio.save_ply(argv[1], simplified)
    print(
        f"{len(mesh.vertices)} -> {len(simplified.vertices)} vertices, "
        f"{len(mesh.faces)} -> {len(simplified.faces)} faces"
    )


if __name__ == "__main__":
    main()
