"""Share of the single-view iterations' target slots that hold an eligible
field: the program's counters ``sv.slots_valid`` over ``sv.slots`` over the
traced window. An unfilled slot's encode, MLP and Adam lanes run for
nothing."""

from port_bench import spans

LAYER = "single-view sampler (mapping/sampling.sample_target_sv)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["sv_replay"]


def read(r):
    if not r["frames"]:
        return None
    red = spans.reading(r)
    c = red["counters"] if red else {}
    if not c.get("sv.slots") or "sv.slots_valid" not in c:
        return None
    return 100.0 * c["sv.slots_valid"] / c["sv.slots"]
