"""Mesh viewer CLI: stream a PLY (plus optional field centers) to rerun
(port of neural_graph_mapping_tpu.vis.vis_mesh).

Usage: python -m neural_graph_mapping_tpu_torch.vis.vis_mesh mesh.ply [fields.txt]
"""

from __future__ import annotations

import sys

import numpy as np

from neural_graph_mapping_tpu_torch.utils import meshio
from neural_graph_mapping_tpu_torch.utils.observability import RerunLogger


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit("usage: vis_mesh <mesh.ply> [fields.txt]")
    mesh = meshio.load_ply(argv[0])
    rrl = RerunLogger("ngm_mesh_vis")
    if not rrl.enabled:
        raise SystemExit("rerun-sdk is required for mesh visualization")
    rrl.log_mesh(mesh)
    if len(argv) > 1:
        fields = np.loadtxt(argv[1]).reshape(-1, 3)
        rrl._rr.log("fields", rrl._rr.Points3D(fields, radii=0.05))
    input("press enter to exit...")


if __name__ == "__main__":
    main()
