"""encode_bwd_table's least time from its calls' inputs (live cotangents)
over its device time, by operation entry."""

from port_bench.counts import share_pct

LAYER = "kernels (ops/permuto_cuda.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    e = r["entries"].get("encode_bwd_table")
    if not e or e.get("device_s") is None:
        return None
    return share_pct(e["bound_s"], e["device_s"])
