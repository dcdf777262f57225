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
- ``encode_fwd_moe_rays`` and ``encode_fwd_moe`` on the first 8192-ray
  block of frame 11's 160x120 render of the map that ``chip_smoke.py``'s 12
  frames build.

Tables are U(-1, 1) with ``log2_hashmap_size`` 14. Each kernel is checked
against its plain version (``encode_fwd`` everywhere, the MoE encodes on
256 live tiles) and timed by ``chip_smoke.time_ms`` twice. Then, so that two
trees' outputs can be compared bit for bit, the SHA-256 of the outputs of
the two MoE encodes and ``topk2_fields`` on seeded inputs that need no
trained map (:func:`digests`; production tables, T = 4,096). Last, the
median wall ms of 5 renders of frame 11's pose at 160x120 on each encode
route (span 512, the ray encode; span 768, the carried one), so that the
renders of two trees can be timed in turns. Prints one JSON line: the
tree, the card, each kernel's ms, the digests and the render times.
"""

import hashlib
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
    m_args, m_kw = chip_smoke.capture_call(
        permuto_cuda, "encode_fwd_moe", lambda: engine.render_block_tiled(*args, use_ray_kernel=False, **kw))
    big_m = (tables,) + tuple(m_args[1:3]) + consts
    chip_smoke.check_moe(torch, permuto_cuda, "encode_fwd_moe", big_m, m_kw, sel)
    out["encode_fwd_moe_ms"] = [
        chip_smoke.time_ms(torch, lambda: permuto_cuda.encode_fwd_moe(*big_m, **m_kw))[0] for _ in range(2)]
    out["sha256"] = digests(torch, permuto_cuda, enc, dev)
    c2w = ds[chip_smoke.RENDER_FRAME]["c2w"]
    for span in (512, 768):
        ngm._eval_span_samples = span
        out[f"render_160x120_span{span}_ms"] = chip_smoke.timed_renders(torch, ngm, c2w, ds.camera, 5)
    print(json.dumps(out))


def digests(torch, permuto_cuda, enc, dev) -> dict:
    """SHA-256 of the outputs of encode_fwd_moe_rays, encode_fwd_moe and
    topk2_fields on inputs made from a fixed seed: 2,048 tiles owned by 32
    fields in sorted runs, production tables U(-1, 1); 1,048,576 points in
    clusters against 64 centres, 5 of them invalid."""
    from neural_graph_mapping_tpu_torch.ops import topk

    gen = torch.Generator(dev).manual_seed(2024)
    consts = (enc._scales_t, enc._shifts_t, enc._elev_t, enc.level_capacities)
    n, tiles = 32, 2048
    tables = torch.rand((n, 2, enc.nr_levels, enc.capacity), generator=gen, device=dev) * 2 - 1
    experts = torch.sort(torch.randint(0, n, (tiles,), generator=gen, device=dev)).values.to(torch.int32)
    orig = torch.randint(0, 8192 * 1024, (tiles, 1024), generator=gen, device=dev, dtype=torch.int32)
    dist = torch.rand((tiles, 1024), generator=gen, device=dev) * 4 + 0.5
    q = torch.randn((n, 4), generator=gen, device=dev)
    poses = torch.cat([torch.randn((n, 3), generator=gen, device=dev) * 0.3,
                       q / q.norm(dim=-1, keepdim=True)], 1).contiguous()
    rot = torch.linalg.qr(torch.randn((3, 3), generator=gen, device=dev))[0]
    rayp = torch.cat([rot.reshape(-1), torch.tensor([0.3, -0.2, 3.0, 1 / 560.0, 1 / 560.0, 320.0, 240.0],
                                                     device=dev)]).contiguous()
    coords = torch.rand((tiles, 3, 1024), generator=gen, device=dev) * 1.5 - 0.25
    pts = (torch.randn((3, 1 << 20), generator=gen, device=dev) * 0.05
           + torch.randn((3, 1 << 14), generator=gen, device=dev).repeat_interleave(64, 1)).contiguous()
    cen = torch.randn((64, 3), generator=gen, device=dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    valid[::13] = False

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    rays = permuto_cuda.encode_fwd_moe_rays(tables, orig, dist, experts, rayp, poses, 4096, *consts,
                                            log2_ks=10, width=640, coord_scale=0.5, coord_shift=0.5)
    carried = permuto_cuda.encode_fwd_moe(tables, coords, experts, *consts)
    return {"encode_fwd_moe_rays": sha(rays), "encode_fwd_moe": sha(carried),
            "topk2_fields": sha(*topk.topk2_fields(pts, cen, valid))}


if __name__ == "__main__":
    main()
