"""Share of the traced window's training iterations whose pre, post and Adam
segments ran from CUDA graphs: the program's counters ``step.graphed`` over
``step.iterations``. A program that counts no iterations (before the
counters) reads nothing; one that counts iterations and graphs none reads 0."""

from port_bench import spans

LAYER = "frame step (engine.frame_step, optimization_iterations_scan and _sv)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "sv_replay", "mv_live"]


def read(r):
    if not r["frames"]:
        return None
    red = spans.reading(r)
    c = red["counters"] if red else {}
    if not c.get("step.iterations"):
        return None
    return 100.0 * c.get("step.graphed", 0) / c["step.iterations"]
