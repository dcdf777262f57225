"""Host time of one render block: the program's ``ngm.render.block`` spans
on the render loop's thread, ms a block of the traced window."""

from port_bench import spans

LAYER = "whole render (render_image, engine.render_block_tiled)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "render_ms"
WORKLOADS = ["mv_render"]


def read(r):
    if not r["images"]:
        return None
    red = spans.reading(r)
    block = red["spans"].get("ngm.render.block") if red else None
    return 1e3 * block["s"] / block["n"] if block and block["n"] else None
