"""Export the synthetic scene (``datasets/synthetic.SyntheticDataset``) in
the Neural RGB-D on-disk layout, so the NRGBD loader of either package reads
it (port of scripts/refrun/export_synthetic_nrgbd.py; no PIL, no JAX).

Layout (``datasets/nrgbd.py``): ``<out>/synthetic/images/img%04d.png`` (RGB8),
``<out>/synthetic/depth/depth%04d.png`` (uint16 millimetres of z-depth),
``<out>/synthetic/poses.txt`` (the stacked 4x4 OpenGL c2ws, ``np.savetxt``).
The depth directory is ``depth``, not ``depth_filtered``, so the loader's
de-bias polynomial stays off for the exact synthetic depth.

Usage:
    python -m neural_graph_mapping_tpu_torch.scripts.export_synthetic_nrgbd \\
        [out_root] [frames] [w] [h] [fx] [--workers N]

Defaults: ``/tmp/ngm_nrgbd_export 240 160 120 140.0``. Frames are ray-cast
on the host (numpy, as the dataset casts them, so the files equal the JAX
package's exporter's once decoded) by ``--workers`` processes (0: one a
core but one, at most 8; one thread each); each worker casts its frames
from their poses and keeps none after writing it. Quantisation as the JAX
exporter's: colour ``clip(rgb * 255 + 0.5)`` to uint8, depth
``clip(z * 1000 + 0.5)`` mm to uint16. PNGs through
``utils/imageio.write_png`` (filter 1, Sub). Prints one JSON line: frames,
size, workers, seconds, bytes written, the camera.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import pathlib
import time

import numpy as np

from neural_graph_mapping_tpu_torch.datasets.synthetic import SyntheticDataset
from neural_graph_mapping_tpu_torch.utils import imageio

# what a process's OpenMP / BLAS thread pools read their size from at start
_THREAD_VARIABLES = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def single_thread_workers():
    """Processes spawned inside this context start their OpenMP / BLAS
    pools with one thread (they inherit the environment), so a pool of
    workers does not oversubscribe the host's cores: 7 workers casting
    640x480 frames took 4x as long with each numpy's default pool."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARIABLES}
    os.environ.update({k: "1" for k in _THREAD_VARIABLES})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def scene_config(width: int, height: int, fx: float, num_frames: int) -> dict:
    """The exported scene's ``SyntheticDataset`` config (fy = fx)."""
    return {"num_frames": num_frames, "width": width, "height": height, "fx": fx, "fy": fx}


def quantise(rgbd: np.ndarray):
    """(H, W, 4) float RGB-D -> (RGB uint8, depth uint16 millimetres)."""
    rgb8 = np.clip(rgbd[..., :3] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    depth_mm = np.clip(rgbd[..., 3] * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
    return rgb8, depth_mm


def write_frames(scene_dir: str, config: dict, frame_ids, c2ws) -> int:
    """Ray-cast the frames ``frame_ids`` of the scene ``config`` at poses
    ``c2ws`` and write them -> bytes written. Runs in a worker process."""
    scene = SyntheticDataset(dict(config, num_frames=1))  # geometry and camera; the poses are given
    out = pathlib.Path(scene_dir)
    written = 0
    for i, c2w in zip(frame_ids, c2ws):
        rgb8, depth_mm = quantise(scene._raycast(np.asarray(c2w, np.float32)))
        for path, image in ((out / "images" / f"img{i:04d}.png", rgb8),
                            (out / "depth" / f"depth{i:04d}.png", depth_mm)):
            imageio.write_png(path, image)
            written += path.stat().st_size
    return written


def export(out_root, num_frames: int = 240, width: int = 160, height: int = 120, fx: float = 140.0,
           workers: int = 0) -> dict:
    """Write the scene under ``<out_root>/synthetic`` -> what was written."""
    t0 = time.perf_counter()
    config = scene_config(width, height, fx, num_frames)
    ds = SyntheticDataset(config)
    scene_dir = pathlib.Path(out_root) / "synthetic"
    (scene_dir / "images").mkdir(parents=True, exist_ok=True)
    (scene_dir / "depth").mkdir(parents=True, exist_ok=True)
    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 1))
    workers = min(workers, num_frames)
    if workers == 1:
        written = write_frames(str(scene_dir), config, range(num_frames), ds.gt_c2ws)
    else:
        ctx = multiprocessing.get_context("spawn")
        with single_thread_workers(), concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            # one interleaved share a worker: every worker gets frames of the whole orbit
            futures = [pool.submit(write_frames, str(scene_dir), config, list(range(w, num_frames, workers)),
                                   ds.gt_c2ws[w::workers]) for w in range(workers)]
            written = sum(f.result() for f in futures)
    poses = scene_dir / "poses.txt"
    np.savetxt(poses, np.asarray(ds.gt_c2ws).reshape(-1, 4))
    written += poses.stat().st_size
    cam = ds.camera
    return {"frames": num_frames, "width": width, "height": height, "workers": workers,
            "seconds": time.perf_counter() - t0, "bytes": written, "scene_dir": str(scene_dir),
            # the cast's own principal point (its 0.5 pixel-centre convention)
            "camera": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_root", nargs="?", default="/tmp/ngm_nrgbd_export")
    parser.add_argument("frames", nargs="?", type=int, default=240)
    parser.add_argument("width", nargs="?", type=int, default=160)
    parser.add_argument("height", nargs="?", type=int, default=120)
    parser.add_argument("fx", nargs="?", type=float, default=140.0)
    parser.add_argument("--workers", type=int, default=0, help="processes casting frames (0: one a core but one)")
    args = parser.parse_args(argv)
    print(json.dumps(export(args.out_root, args.frames, args.width, args.height, args.fx, args.workers)),
          flush=True)


if __name__ == "__main__":
    main()
