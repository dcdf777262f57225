"""Host time to enqueue a frame's device program: the program's
``ngm.frame.step`` spans less their ``ngm.frame.sync`` children (the
losses' copy, which waits for the device), ms a frame of the traced
window."""

from port_bench import spans

LAYER = "frame step (engine.frame_step, optimization_iterations_scan and _sv)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    if not r["frames"]:
        return None
    step = spans.span_s(r, "ngm.frame.step")
    if step is None:
        return None
    return 1e3 * (step - (spans.span_s(r, "ngm.frame.sync") or 0.0)) / r["frames"]
