"""The frame input's PNG decode (the program's ``ngm.input.decode`` spans:
each ``imageio.read_png``, on the prefetch worker), ms a frame of the
traced window."""

from port_bench import spans

LAYER = "frame input (utils/prefetch.FramePrefetcher, datasets/nrgbd, utils/imageio)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay"]


def read(r):
    if not r["frames"]:
        return None
    s = spans.span_s(r, "ngm.input.decode")
    return None if s is None else 1e3 * s / r["frames"]
