"""Device ms of the port's direct kernel designs, those taken for tables of
T = 16,384 entries a level row (above the staged maxima), for the
``neural_graph_mapping_tpu_torch`` package of any checkout, so that two
checkouts' kernels can be timed in turns on one card:

    python3 scripts/time_direct_designs.py TREE

TREE is a checkout's root (this one, or another commit unpacked with
``git archive``); its package is imported and its kernels are built from its
``csrc/``. Needs CUDA. The inputs are those of ``chip_smoke.py``'s
``kernel_variant`` lines, made from fixed seeds:

- ``encode_fwd`` at 32 fields x 12,288 points (the training shape);
- ``encode_fwd_moe_rays`` on the first 8192-ray block of frame 11's 160x120
  render of the map that ``chip_smoke.py``'s 12 frames build.

Tables are U(-1, 1) with ``log2_hashmap_size`` 14. Each kernel is checked
against its plain version (``encode_fwd`` everywhere, the ray encode on
256 live tiles) and timed by ``chip_smoke.time_ms`` twice. Prints one JSON
line: the tree, the card, and each kernel's ms.
"""

import json
import pathlib
import subprocess
import sys


def main() -> None:
    tree = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke  # puts this checkout's root first on sys.path

    sys.path.insert(0, str(tree))  # then the tree under test before it
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_direct_designs: torch.cuda.is_available() is False; this needs a GPU")
    from neural_graph_mapping_tpu_torch.config import str_to_object
    from neural_graph_mapping_tpu_torch.mapping import engine
    from neural_graph_mapping_tpu_torch.ops import permuto_cuda
    from neural_graph_mapping_tpu_torch.ops.encodings import PermutohedralEncoding

    if not pathlib.Path(permuto_cuda.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {permuto_cuda.__file__}, not the package of {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    config = chip_smoke.CONFIG
    enc = PermutohedralEncoding(**config["model_kwargs"]["field_kwargs"]["encoding_kwargs"])
    big, consts = chip_smoke.big_table_consts(enc)
    dev = torch.device("cuda")
    out = {"tree": str(tree), "card": smi}

    gen = torch.Generator(dev).manual_seed(1234)
    coords = torch.rand((32, 3, 512 * 24), generator=gen, device=dev) * 1.5 - 0.25
    table = torch.rand((32, 2, big.nr_levels, big.capacity), generator=gen, device=dev) * 2 - 1
    chip_smoke.check_encode_fwd(torch, permuto_cuda, table, coords, consts)
    out["encode_fwd_ms"] = [chip_smoke.time_ms(torch, lambda: permuto_cuda.encode_fwd(table, coords, *consts))[0]
                            for _ in range(2)]

    ds = str_to_object(config["dataset_type"])(config["dataset_config"])
    ds.load_slam_results()
    frames = [torch.from_numpy(ds[i]["rgbd"]) for i in range(chip_smoke.NUM_FRAMES)]
    ngm = engine.NeuralGraphMap(config, device="cuda")
    chip_smoke.run_frames(torch, ngm, ds, frames)
    gen = torch.Generator(dev).manual_seed(4321)
    block = min(ngm.render_block_size(), ds.camera.height * ds.camera.width)
    u = torch.rand((block, ngm._eval_span_samples), generator=gen, device=dev)
    args, kw = chip_smoke.block_call(torch, ngm, ds.camera, ds[chip_smoke.RENDER_FRAME]["c2w"], 0, block, u)
    c_args, c_kw = chip_smoke.capture_call(
        permuto_cuda, "encode_fwd_moe_rays", lambda: engine.render_block_tiled(*args, use_ray_kernel=True, **kw))
    tables = torch.rand(c_args[0].shape[:3] + (big.capacity,), generator=gen, device=dev) * 2 - 1
    big_args = (tables,) + tuple(c_args[1:7]) + consts
    live = int(c_kw["num_live_tiles"])
    sel = torch.unique(torch.linspace(0, live - 1, min(256, live), device=dev).round().long())
    chip_smoke.check_moe(torch, permuto_cuda, "encode_fwd_moe_rays", big_args, c_kw, sel)
    out["live_tiles"] = live
    out["encode_fwd_moe_rays_ms"] = [
        chip_smoke.time_ms(torch, lambda: permuto_cuda.encode_fwd_moe_rays(*big_args, **c_kw))[0]
        for _ in range(2)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
