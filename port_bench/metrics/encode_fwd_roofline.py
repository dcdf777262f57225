"""encode_fwd's least time from its calls' inputs over its device time,
by operation entry (ops/permuto_cuda.encode_fwd)."""

from port_bench.counts import share_pct

LAYER = "kernels (ops/permuto_cuda.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    e = r["entries"].get("encode_fwd")
    if not e or e.get("device_s") is None:
        return None
    return share_pct(e["bound_s"], e["device_s"])
