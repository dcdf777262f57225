"""Validate an on-disk SLAM scene before a mapping run (port of
scripts/check_dataset.py; images read through the port's ``utils/imageio``,
so PNG scenes need no PIL).

Usage:
    python -m neural_graph_mapping_tpu_torch.scripts.check_dataset <layout> <root_dir> <scene>

where ``layout`` is one of ``nrgbd | replica | scannet | kintinuous``.

Checks (fast, no mapping):
- expected files/dirs exist for the layout
- image counts: #rgb == #depth (== #poses where per-frame pose files exist)
- image sizes: all rgb same size, all depth same size
- depth scale sanity: decoded depth (meters) falls in a plausible indoor
  range (0.1 .. 30 m median) — catches wrong mm/m scaling immediately
- pose sanity: finite, right-handed rotations (det ~ +1), translation spread
  below 100 m — catches transposed/flipped pose parsing
- loader round-trip: instantiate the port's loader, read 3 frames end-to-end

Exit code 0 = all checks pass; 1 = failures (printed).

A readiness kit for the first real-data run, so convention bugs surface as
named check failures instead of silent quality loss.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from neural_graph_mapping_tpu_torch.config import str_to_object
from neural_graph_mapping_tpu_torch.utils import imageio

LAYOUTS = ("nrgbd", "replica", "scannet", "kintinuous")

_FAILURES: list = []


def check(name: str, ok: bool, detail: str = "") -> bool:
    mark = "ok  " if ok else "FAIL"
    print(f"[{mark}] {name}" + (f": {detail}" if detail else ""))
    if not ok:
        _FAILURES.append(name)
    return ok


def _expect_files(layout: str, root: pathlib.Path, scene: str):
    s = root / scene
    if layout == "nrgbd":
        rgb = sorted((s / "images").glob("*.png")) + sorted((s / "images").glob("*.jpg"))
        depth_dir = s / "depth_filtered"
        if not depth_dir.is_dir():
            depth_dir = s / "depth"
        depth = sorted(depth_dir.glob("*.png"))
        check("poses.txt exists", (s / "poses.txt").is_file())
        poses = None
        if (s / "poses.txt").is_file():
            flat = np.loadtxt(s / "poses.txt")
            check("poses.txt shape divisible by 4", flat.shape[0] % 4 == 0)
            poses = flat.reshape(-1, 4, 4)
        check("gt_mesh.ply exists (mesh eval)", (s / "gt_mesh.ply").is_file())
        return rgb, depth, poses, 1000.0
    if layout == "replica":
        check("cam_params.json exists", (root / "cam_params.json").is_file())
        # the loader takes any frame* file: JPEG as rendered, or PNG
        rgb = sorted((s / "results").glob("frame*.jpg")) + sorted((s / "results").glob("frame*.png"))
        depth = sorted((s / "results").glob("depth*.png"))
        check("traj.txt exists", (s / "traj.txt").is_file())
        poses = None
        if (s / "traj.txt").is_file():
            flat = np.loadtxt(s / "traj.txt")
            poses = flat.reshape(-1, 4, 4)
        check(
            f"{scene}_mesh.ply exists (mesh eval)",
            (root / f"{scene}_mesh.ply").is_file(),
        )
        scale = 6553.5
        cam_params = root / "cam_params.json"
        if cam_params.is_file():
            import json

            scale = float(json.loads(cam_params.read_text())["camera"]["scale"])
        return rgb, depth, poses, scale
    if layout == "scannet":
        rgb = sorted((s / "color").glob("*.jpg")) + sorted((s / "color").glob("*.png"))
        depth = sorted((s / "depth").glob("*.png"))
        pose_files = sorted((s / "pose").glob("*.txt"))
        check("intrinsic_depth.txt exists",
              (s / "intrinsic" / "intrinsic_depth.txt").is_file())
        check("#poses == #rgb", len(pose_files) == len(rgb),
              f"{len(pose_files)} vs {len(rgb)}")
        poses = (
            np.stack([np.loadtxt(p) for p in pose_files[:50]]) if pose_files else None
        )
        return rgb, depth, poses, 1000.0
    # kintinuous
    rgb = sorted((s / "color").glob("*.png"))
    depth = sorted((s / "depth").glob("*.png"))
    return rgb, depth, None, 1000.0


def _check_images(rgb, depth, depth_scale):
    check("rgb frames found", len(rgb) > 0, f"{len(rgb)} frames")
    check("depth frames found", len(depth) > 0, f"{len(depth)} frames")
    check("#rgb == #depth", len(rgb) == len(depth), f"{len(rgb)} vs {len(depth)}")
    if not rgb or not depth:
        return
    # probe indices valid for BOTH lists even on a count mismatch (the
    # mismatch was already reported above; keep checking instead of crashing)
    n_min = min(len(rgb), len(depth))
    probe = sorted({0, n_min // 2, n_min - 1})
    sizes_rgb = {imageio.image_size(rgb[i]) for i in probe}
    sizes_d = {imageio.image_size(depth[i]) for i in probe}
    check("rgb sizes consistent", len(sizes_rgb) == 1, str(sizes_rgb))
    check("depth sizes consistent", len(sizes_d) == 1, str(sizes_d))
    d = np.asarray(imageio.read_image(depth[len(depth) // 2]), np.float64)
    meters = d[d > 0] / depth_scale
    if meters.size:
        med = float(np.median(meters))
        check(
            "depth scale sane (median in 0.1..30 m)",
            0.1 < med < 30.0,
            f"median {med:.3f} m (scale {depth_scale})",
        )
    else:
        check("depth non-empty", False, "all-zero depth frame")


def _check_poses(poses):
    if poses is None:
        print("[skip] pose checks (layout has no standalone pose files)")
        return
    check("poses finite", bool(np.isfinite(poses).all()))
    rot = poses[:, :3, :3]
    dets = np.linalg.det(rot)
    check(
        "rotations right-handed (det ~ +1)",
        bool(np.allclose(dets, 1.0, atol=0.1)),
        f"det range [{dets.min():.3f}, {dets.max():.3f}]",
    )
    ortho_err = np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max()
    check("rotations orthonormal", float(ortho_err) < 1e-2, f"max err {ortho_err:.2e}")
    t = poses[:, :3, 3]
    spread = float(np.linalg.norm(t.max(0) - t.min(0)))
    check("translation spread < 100 m", spread < 100.0, f"{spread:.2f} m")
    check("bottom row is [0,0,0,1]",
          bool(np.allclose(poses[:, 3], [0, 0, 0, 1], atol=1e-6)))


_LOADERS = {
    "nrgbd": "neural_graph_mapping_tpu_torch.datasets.nrgbd.NRGBDDataset",
    "replica": "neural_graph_mapping_tpu_torch.datasets.replica.ReplicaDataset",
    "scannet": "neural_graph_mapping_tpu_torch.datasets.scannet.ScanNetDataset",
    "kintinuous": "neural_graph_mapping_tpu_torch.datasets.kintinuous.KintinuousDataset",
}


def _check_loader_roundtrip(layout: str, root: pathlib.Path, scene: str):
    try:
        cls = str_to_object(_LOADERS[layout])
        cfg = {"root_dir": str(root), "scene": scene}
        if layout in ("nrgbd", "kintinuous"):
            # these layouts carry no intrinsics on disk (the run config
            # supplies them); probe with a plausible pinhole from the image
            # size so the round-trip can execute
            sub = {"nrgbd": "images", "kintinuous": "color"}[layout]
            first = sorted((root / scene / sub).iterdir())[0]
            w, h = imageio.image_size(first)
            cfg["camera"] = {
                "width": w, "height": h, "fx": 0.87 * w, "fy": 0.87 * w,
                "cx": w / 2 - 0.5, "cy": h / 2 - 0.5,
            }
        # probe with ground-truth poses + fixed keyframes: the check
        # validates the scene data; SLAM-export files are optional extras
        cfg.update({"pose_source": "gt", "pg_source": "fixed_kf_freq",
                    "fixed_kf_freq": 10})
        ds = cls(cfg)
        ds.load_slam_results()
        n = len(ds)
        check("loader length > 0", n > 0, f"{n} frames")
        for i in (0, n // 2, n - 1):
            item = ds[i]
            rgbd = np.asarray(item["rgbd"])
            check(
                f"frame {i} rgbd finite + shaped",
                rgbd.ndim == 3 and rgbd.shape[-1] == 4 and np.isfinite(rgbd).all(),
                str(rgbd.shape),
            )
            rgb_ok = 0.0 <= float(rgbd[..., :3].min()) and float(rgbd[..., :3].max()) <= 1.0
            check(f"frame {i} rgb in [0,1]", rgb_ok)
            c2w = np.asarray(ds.get_slam_c2ws(i))
            check(f"frame {i} slam c2w finite", bool(np.isfinite(c2w).all()))
    except Exception as e:  # any loader crash is exactly what we are probing for
        check("loader round-trip", False, f"{type(e).__name__}: {e}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _FAILURES.clear()
    if len(argv) != 3 or argv[0] not in LAYOUTS:
        print(__doc__)
        return 2
    layout, root, scene = argv[0], pathlib.Path(argv[1]), argv[2]
    if not check("root_dir exists", root.is_dir(), str(root)):
        return 1
    if not check("scene dir exists", (root / scene).is_dir(), str(root / scene)):
        return 1
    rgb, depth, poses, depth_scale = _expect_files(layout, root, scene)
    _check_images(rgb, depth, depth_scale)
    _check_poses(poses)
    if poses is not None and rgb:
        check("#poses == #rgb", len(poses) == len(rgb),
              f"{len(poses)} vs {len(rgb)}")
    _check_loader_roundtrip(layout, root, scene)
    print(f"\n{'ALL CHECKS PASSED' if not _FAILURES else f'{len(_FAILURES)} FAILURES: {_FAILURES}'}")
    return 0 if not _FAILURES else 1


if __name__ == "__main__":
    raise SystemExit(main())
