"""The whole render's share of the float32 peak: the encode and MLP FLOPs
of every pair inside a field's radius, over the traced window."""

from port_bench.counts import F32_OPS_PER_S

LAYER = "whole render (render_image, engine.render_block_tiled)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "render_ms"
WORKLOADS = ["mv_render"]


def read(r):
    if not r["images"]:
        return None
    e = r["entries"].get("encode_fwd_moe_rays")
    return 100.0 * e["flops"] / (r["trace"]["window_s"] * F32_OPS_PER_S) if e else None
