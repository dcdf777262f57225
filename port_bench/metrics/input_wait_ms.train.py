"""The time the frame loop waited in ``FramePrefetcher.get`` for the next
decoded, uploaded frame, ms a frame of the traced window."""

LAYER = "frame input (utils/prefetch.FramePrefetcher, datasets/nrgbd, utils/imageio)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay"]


def read(r):
    if not r["frames"] or r.get("input_wait_s") is None:
        return None
    return 1e3 * r["input_wait_s"] / r["frames"]
