"""Share of the traced window of a stream cell in which no operation ran
on the device (the union of device intervals)."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    if not r["frames"]:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
