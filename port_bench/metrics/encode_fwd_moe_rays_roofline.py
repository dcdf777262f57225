"""encode_fwd_moe_rays's least time from its calls' inputs (pairs inside
a field's radius, tables of the fields they reach) over its device time."""

from port_bench.counts import share_pct

LAYER = "kernels (ops/permuto_cuda.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "render_ms"
WORKLOADS = ["mv_render"]


def read(r):
    e = r["entries"].get("encode_fwd_moe_rays")
    if not e or e.get("device_s") is None:
        return None
    return share_pct(e["bound_s"], e["device_s"])
