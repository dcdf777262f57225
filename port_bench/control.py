"""The readings that set the limits of ``correct``, run by hand on the card:

    python3 -m port_bench.control --workload NAME --seeds S [S ...]

For each seed, one JSON line: the sound program's numbers against the
reference (the lower reading), the control's (the reference, its map trained
and rendered with TF32 matrix products, the precision below the
configuration's float32) and a fault's (the reference's map trained with
half of each iteration's fields left out and the mean taken over the rest).
The benchmark's own runs never run this. Training cells need no window; a
render cell renders for ``--seconds`` at the cell's load and compares as
many blocks as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from port_bench import manifest as mf
from port_bench import run
from port_bench.reference import check
from port_bench.reference.ngm.mapping import engine as ref_engine


@contextlib.contextmanager
def half_the_fields():
    """The reference's iterations with the second half of their target
    fields left out."""
    core = ref_engine._optimization_iteration_core

    def half(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *rest, **kw):
        n = target.field_valid.shape[0]
        fv = target.field_valid & (torch.arange(n, device=target.field_valid.device) < n // 2)
        target = target._replace(field_valid=fv, rgb_mask=target.rgb_mask & fv[:, None],
                                 depth_mask=target.depth_mask & fv[:, None], term_mask=target.term_mask & fv[:, None])
        return core(fset, camera, rcfg, ocfg, loss_cfg, params, adam, ti, pos, ori, target, *rest, **kw)

    ref_engine._optimization_iteration_core = half
    try:
        yield
    finally:
        ref_engine._optimization_iteration_core = core


def readings(name: str, seed: int, seconds: float, device) -> dict:
    wl = mf.load_workload(name)
    cfg = mf.load_config(wl["config"])
    sc, mc = cfg["scene"], cfg["map"]
    if wl["loop"] == "stream":
        n = int(wl["warmup_frames"])
        rec = run.run_stream(cfg, wl, seed, 0.0, False, device, time.perf_counter())
        frames, poses, phase = rec["inputs"]
        out = {"program": rec["checks"]}
        ctl = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n, tf32=True)
        out["control"] = check.training_gaps(ctl, rec["reference"])
        with half_the_fields():
            fault = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n)
        out["half_batch"] = check.training_gaps(fault, rec["reference"])
        return out
    rec = run.run_render(cfg, wl, seed, seconds, False, device, time.perf_counter())
    frames, poses, phase, samples = rec["inputs"]
    ref, n = rec["reference"], int(wl["train_frames"])
    ctl = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n, tf32=True)
    control = check.training_gaps(ctl, ref)
    control["render_gap"] = check.widest_gap(
        check.render_blocks(mc, sc, rec["program"], samples, device, tf32=True), ref["followed"])
    control.update(check.image_gaps(check.render_blocks(mc, sc, ctl, samples, device, tf32=True), ref["own"]))
    del ctl
    with half_the_fields():
        fault = check.follow_frames(mc, sc, frames, poses, phase, seed, device, n)
    half = check.training_gaps(fault, ref)
    half.update(check.image_gaps(check.render_blocks(mc, sc, fault, samples, device), ref["own"]))
    return {"program": rec["checks"], "control": control, "half_batch": half, "images": len(rec["image_s"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    from neural_graph_mapping_tpu_torch.ops import cuda_build

    cuda_build.load_all()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed, args.seconds, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
