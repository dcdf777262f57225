"""The online loop's host phases (graph, alloc, host_misc of the engine's
``phase_times``) over the traced window, ms a frame."""

LAYER = "online loop on the host (mapping/engine.NeuralGraphMap.process_frame)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["mv_replay", "mv_live"]


def read(r):
    if not r["frames"] or r["phase_s"] is None:
        return None
    return 1e3 * sum(r["phase_s"].values()) / r["frames"]
