"""Time the gather route's kernels of one checkout at 2 features a level:
``gather_pairs`` and ``table_grad`` at the 2D field set's shape (512 rows =
32 fields x 16 levels, 36,864 pairs a row, T = 4,096; their staged
designs), and their direct designs as ``chip_smoke.py``'s kernel_variant
lines take them (``gather_pairs`` with the table 4 bytes off 16-byte
alignment; ``table_grad`` at 32 rows, T = 16,384); device ms a launch with
the host's issue hidden (``chip_smoke.time_ms``).

    python3 neural_graph_mapping_tpu_torch/scripts/time_gather_route.py TREE [TURNS]

imports the port from the checkout at TREE (built into TREE's own
``_build/``), so one call on the card can time two commits in turns
(parent, change, change, parent), each in a process of its own. Prints one
JSON line: the card, TREE and the kernels' ms in each of TURNS turns.
"""

import json
import pathlib
import subprocess
import sys


def main() -> None:
    tree = pathlib.Path(sys.argv[1]).resolve()
    turns = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, str(tree))
    import torch

    from neural_graph_mapping_tpu_torch.ops import permuto_cuda

    if pathlib.Path(permuto_cuda.__file__).resolve().parents[2] != tree:
        raise SystemExit(f"imported {permuto_cuda.__file__}, not the package of {tree}")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("time_gather_route: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    permuto_cuda.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2024)
    rows, m, t = 512, 36864, 4096
    table = torch.rand((rows, 2, t), generator=gen, device=dev) * 2 - 1
    idx = torch.randint(0, t, (rows, m), generator=gen, device=dev)
    gv = torch.randn((rows, 2, m), generator=gen, device=dev)
    if not torch.equal(permuto_cuda.gather_pairs(table, idx), permuto_cuda.gather_pairs_plain(table, idx)):
        raise SystemExit("gather_pairs differs from its plain version")
    off = torch.empty(table.numel() + 1, device=dev)[1:].view(table.shape)
    off.copy_(table)
    big_t = 16384
    big_idx = torch.randint(0, big_t, (32, m), generator=gen, device=dev)
    big_gv = torch.randn((32, 2, m), generator=gen, device=dev)
    calls = {
        "gather_pairs_staged_ms": lambda: permuto_cuda.gather_pairs(table, idx),
        "table_grad_staged_ms": lambda: permuto_cuda.table_grad(idx, gv, t),
        "gather_pairs_direct_ms": lambda: permuto_cuda.gather_pairs(off, idx),
        "table_grad_direct_ms": lambda: permuto_cuda.table_grad(big_idx, big_gv, big_t),
    }
    out = {"card": smi, "tree": str(tree), "shape": {"rows": rows, "pairs_per_row": m, "table": t},
           **{name: [] for name in calls}}
    for _ in range(turns):
        for name, call in calls.items():
            out[name].append(chip_smoke.time_ms(torch, call)[0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
