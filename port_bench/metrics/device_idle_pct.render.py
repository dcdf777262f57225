"""Share of the traced window of a render cell in which no operation ran
on the device."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "render_ms"
WORKLOADS = ["mv_render"]


def read(r):
    if not r["images"]:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
