"""The frame loop's wait for the device: the program's ``ngm.frame.sync``
spans (the losses' ``.tolist()``), ms a frame of the traced window."""

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
    s = spans.span_s(r, "ngm.frame.sync")
    return None if s is None else 1e3 * s / r["frames"]
