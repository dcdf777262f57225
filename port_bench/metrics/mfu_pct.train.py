"""The whole training step's share of the float32 peak: the FLOPs its
encodes and MLPs need, forward and backward, from the calls' inputs, over
the traced window."""

from port_bench.counts import F32_OPS_PER_S

LAYER = "whole training step (process_frame)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    if not r["frames"]:
        return None
    flops = sum(e["flops"] for k, e in r["entries"].items() if k in ("encode_fwd", "encode_bwd_table"))
    return 100.0 * flops / (r["trace"]["window_s"] * F32_OPS_PER_S) if flops else None
