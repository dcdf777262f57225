"""Device kernels launched a frame in the traced window (the harness's
marker kernels not counted)."""

LAYER = "frame step (engine.frame_step, optimization_iterations_scan and _sv)"
UNIT = "launches/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    if not r["frames"]:
        return None
    return r["trace"]["launches"] / r["frames"]
