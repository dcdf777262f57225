"""Share of the traced window's device-idle time during which the
program's ``ngm.input.decode`` span is open on another thread than the
frame loop's (the prefetch worker's PNG decode)."""

from port_bench import spans

LAYER = "frame input (utils/prefetch.FramePrefetcher, datasets/nrgbd, utils/imageio)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay"]


def read(r):
    if not r["frames"]:
        return None
    red = spans.reading(r)
    if red is None or not red["idle_by_span"]["idle_s"] or "ngm.input.decode" not in red["spans"]:
        return None
    idle = red["idle_by_span"]
    return 100.0 * idle["other"].get("ngm.input.decode", 0.0) / idle["idle_s"]
