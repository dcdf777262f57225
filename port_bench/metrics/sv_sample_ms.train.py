"""Time of the single-view sample stage, ms a frame of the traced window.

A replayed iteration (counter ``step.graphed``) runs the whole stage as the
pre graph, launched inside the program's ``ngm.iter.sample`` span: the view,
its gather and the sampler, the targets' gather and the ray samples. This
reads the device seconds of the work that those launches replay, a replayed
iteration, times the window's iterations a frame. The sampler cannot be told
apart from the rest of the graph there, and the host's copies and enqueue
are not counted.

A window with no such launch (every iteration eager: the CPU, a program
without graphs) reads the host seconds of the eager sampler's spans
``ngm.iter.sv_cloud``, ``.sv_count`` and ``.sv_rays`` (nested in
``ngm.iter.sample``, not in each other), which the sampler's own waits on
the device pace. A multi-view window (no ``sv.slots`` counted), a program
without these spans or counters, or one with only some of the three spans
reads nothing."""

from port_bench import spans

LAYER = "single-view sample stage (engine.sv_target, gather_targets, ray_samples; the pre graph)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["sv_replay"]
SPANS = ("ngm.iter.sv_cloud", "ngm.iter.sv_count", "ngm.iter.sv_rays")
STAGE = "ngm.iter.sample"


def read(r):
    if not r["frames"]:
        return None
    red = spans.reading(r)
    if red is None:
        return None
    c = red["counters"]
    if not c.get("sv.slots"):
        return None
    replayed = red["graph_device_s"].get(STAGE, 0.0)
    if replayed > 0:
        if not c.get("step.graphed") or not c.get("step.iterations"):
            return None
        return 1e3 * replayed / c["step.graphed"] * c["step.iterations"] / r["frames"]
    if any(name not in red["spans"] for name in SPANS):
        return None
    return 1e3 * sum(red["spans"][name]["s"] for name in SPANS) / r["frames"]
