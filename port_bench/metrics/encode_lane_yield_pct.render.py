"""Share of the MoE encode's lanes that carry a (point, field) pair inside
a radius: the program's counters ``render.pairs_valid`` over
``render.lanes_encoded`` (the live tiles' lanes) over the traced window."""

from port_bench import spans

LAYER = "dispatch and MoE encode (models/fields.apply_knn_tiled)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "render_ms"
WORKLOADS = ["mv_render"]


def read(r):
    if not r["images"]:
        return None
    red = spans.reading(r)
    c = red["counters"] if red else {}
    if not c.get("render.lanes_encoded") or "render.pairs_valid" not in c:
        return None
    return 100.0 * c["render.pairs_valid"] / c["render.lanes_encoded"]
