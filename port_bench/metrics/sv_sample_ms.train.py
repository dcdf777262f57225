"""Host time of the single-view sampler: the program's ``ngm.iter.sv_cloud``,
``ngm.iter.sv_count`` and ``ngm.iter.sv_rays`` spans, which nest in
``ngm.iter.sample`` and not in each other, ms a frame of the traced window.
A program without them (multi-view, or before the spans) reads nothing."""

from port_bench import spans

LAYER = "single-view sampler (mapping/sampling.sample_target_sv)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["sv_replay"]
SPANS = ("ngm.iter.sv_cloud", "ngm.iter.sv_count", "ngm.iter.sv_rays")


def read(r):
    if not r["frames"]:
        return None
    parts = [spans.span_s(r, name) for name in SPANS]
    if any(p is None for p in parts):
        return None
    return 1e3 * sum(parts) / r["frames"]
