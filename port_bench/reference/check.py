"""The comparison that decides ``correct``: the program's outputs against
the frozen plain copy (:mod:`port_bench.reference.ngm`), run on the same
device in float32 with TF32 off, on the harness's own frames and draws.

The reference builds a map of its own from the seed's draws and trains it
on the frames the program trained on; it takes no state from the program.
Training: it follows every warm-up frame, which the program ran through
``process_frame`` in set-up before it handed the same map to the window
(keyframe slots, field growth and a capacity doubling fall among them).
Render: it follows the set-up's training frames the same way, renders
sampled blocks of images the window finished from its own map, and renders
them once more from the program's map, to follow the render alone, exactly
(its own map's pixels part from the program's at a few rays by a whole
surface; see :func:`image_gaps`). Both use the same jitter draws.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch

from port_bench import traffic
from port_bench.reference.ngm import camera as ref_camera
from port_bench.reference.ngm.mapping import engine as ref_engine

LOSS_TERMS_SKIPPED = ("diag_",)  # counts and shares, not losses


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matrix products at full precision (TF32 off) or, for the
    control, in TF32; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_camera(scene: dict):
    """The scene's camera in the frozen copy's class."""
    return ref_camera.Camera.create(width=int(scene["width"]), height=int(scene["height"]),
                                    fx=float(scene["fx"]), fy=float(scene["fy"]),
                                    cx=int(scene["width"]) / 2.0, cy=int(scene["height"]) / 2.0)


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


class _Recording(traffic.SeededDraws):
    """The seed's draw source, keeping a copy of every field init it hands out."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.inits: List[Dict[str, torch.Tensor]] = []

    def init_fields(self, num_fields: int) -> dict:
        out = super().init_fields(num_fields)
        self.inits.append({k: v.clone() for k, v in out.items()})
        return out


def train_reference(map_config: dict, scene: dict, frames, poses, phase: int, seed: int, device,
                    n_frames: int, tf32: bool = False, on_frame=None):
    """The reference's own map, built from the seed's draws and trained on
    the stream's first ``n_frames`` frames -> (map, the draw source);
    ``on_frame(f, map, losses)`` after each frame."""
    source = _Recording(seed, map_config, device)
    ds = traffic.lap_dataset(make_camera(scene), poses, phase, scene)
    with matmul_precision(tf32):
        ref = ref_engine.NeuralGraphMap(map_config, device, draws=source)
        for f in range(n_frames):
            losses = ref.process_frame(ds, f, frames[ds.pose_index(f)])
            if on_frame is not None:
                on_frame(f, ref, losses)
    return ref, source


def follow_frames(map_config: dict, scene: dict, frames, poses, phase: int, seed: int, device,
                  n_frames: int, tf32: bool = False) -> dict:
    """The reference's first ``n_frames`` frames -> per-frame losses, the
    Adam first moment after frame 0, the map after the last frame (params,
    field positions and orientations, field count) and the params every
    field started from (in capacity order)."""
    out = {"losses": []}

    def keep(f, ref, losses):
        out["losses"].append(losses)
        if f == 0:
            out["first_m"] = {k: v.clone() for k, v in ref._adam.m.items()}

    ref, source = train_reference(map_config, scene, frames, poses, phase, seed, device, n_frames, tf32, keep)
    out.update(map_of(ref), init={k: torch.cat([c[k] for c in source.inits]) for k in source.inits[0]})
    return out


def map_of(ngm, to=None) -> dict:
    """A map's params, field positions and orientations, and field count,
    copied (to the device ``to``, else where they lie)."""
    arrays = ngm._map_arrays
    return {"params": {k: v.detach().to(to, copy=True) for k, v in ngm._params.items()},
            "positions": arrays.positions.to(to, copy=True), "orientations": arrays.orientations.to(to, copy=True),
            "fields": ngm.num_fields}


def _worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """max over kept leaves of |program norm - reference norm| / max(that
    leaf's reference norm, the median kept leaf's)."""
    kept = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in kept)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in kept]
    return max(g if g == g else float("inf") for g in gaps)


def training_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers compared for a training cell.

    - ``loss_gap``: over the followed frames and loss terms, the largest
      |program - reference| as a share of the frame's combined loss;
    - ``grad_gap``: worst leaf's gap of norms of Adam's first moment after
      the first frame (the first frame's gradients as the optimizer got
      them);
    - ``step_gap``: worst leaf's gap of norms of the parameters' change
      over the followed frames;
    - ``pose_gap``: over the fields after the followed frames, the larger
      of the widest distance between the two maps' field positions (m)
      and the widest angle between their orientations (rad): what the
      keyframe poses' corrections (loop closures, bundle adjustment,
      culled keyframes) move.

    Leaves whose reference first moment is under a thousandth of the median
    leaf's take no part: rounding alone moves them under Adam. A map that
    holds another number of fields than the reference reads 1 on each; a
    NaN reads as infinite. For the record, compared by no cell:
    ``loss_gap_median``, the median over the followed frames of each frame's
    largest loss share; ``step_gap_median``, the median leaf's gap of the
    parameters' change; ``loss_gap_frame``, the frame of the largest loss
    gap."""
    if program["fields"] != reference["fields"] or program["params"].keys() != reference["params"].keys() or any(
            program["params"][k].shape != reference["params"][k].shape for k in reference["params"]):
        return {"loss_gap": 1.0, "loss_gap_median": 1.0, "grad_gap": 1.0, "step_gap": 1.0, "step_gap_median": 1.0,
                "pose_gap": 1.0}
    frame_gaps = []
    for lp, lr in zip(program["losses"], reference["losses"]):
        scale = max(abs(lr["combined"]), 1e-30)
        gaps = [abs(lp.get(term, float("nan")) - value) / scale for term, value in lr.items()
                if not term.startswith(LOSS_TERMS_SKIPPED)]
        frame_gaps.append(max((g if g == g else float("inf") for g in gaps), default=0.0))
    loss_gap = max(frame_gaps, default=0.0)
    m_ref = leaf_norms(reference["first_m"])
    m_prog = leaf_norms({k: v.to(reference["first_m"][k].device) for k, v in program["first_m"].items()})
    med = statistics.median(m_ref.values())
    moving = {k for k, v in m_ref.items() if v >= 1e-3 * med}
    dev = next(iter(reference["init"].values())).device
    step_ref = leaf_norms({k: reference["params"][k] - reference["init"][k] for k in moving})
    step_prog = leaf_norms({k: program["params"][k].to(dev) - reference["init"][k] for k in moving})
    step_median = statistics.median(abs(step_prog[k] - step_ref[k]) / max(step_ref[k], 1e-30) for k in moving)
    return {"loss_gap": loss_gap, "loss_gap_median": statistics.median(frame_gaps) if frame_gaps else 0.0,
            "grad_gap": _worst_leaf_gap(m_prog, m_ref, moving.__contains__),
            "step_gap": _worst_leaf_gap(step_prog, step_ref, moving.__contains__), "step_gap_median": step_median,
            "pose_gap": pose_gap(program, reference),
            "loss_gap_frame": float(frame_gaps.index(loss_gap)) if frame_gaps else 0.0}


def pose_gap(program: dict, reference: dict) -> float:
    """The larger of the widest field-position distance and the widest
    orientation angle between two maps of as many fields (a NaN reads as
    infinite). The angle is taken from the quaternions' chord, 4 asin(|q1 -
    s q2| / 2) with s the sign of their dot product, which keeps its digits
    where acos of the dot product loses them."""
    n = int(reference["fields"])
    if n == 0:
        return 0.0
    dev = reference["positions"].device
    pos = [m["positions"][:n].to(dev).double() for m in (program, reference)]
    quat = [torch.nn.functional.normalize(m["orientations"][:n].to(dev).double(), dim=-1)
            for m in (program, reference)]
    sign = torch.where((quat[0] * quat[1]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    chord = torch.linalg.vector_norm(quat[0] - sign * quat[1], dim=-1)
    angle = 4.0 * torch.asin(torch.clamp(chord / 2.0, max=1.0))
    gaps = [float(torch.linalg.vector_norm(pos[0] - pos[1], dim=-1).max()), float(angle.max())]
    return float("inf") if any(g != g for g in gaps) else max(gaps)


def render_blocks(map_config: dict, scene: dict, state: dict, samples: list, device, tf32: bool = False) -> list:
    """The RGB-D of sampled render blocks from the map ``state``
    (:func:`map_of`), rendered by the reference, on the host. ``samples``:
    (c2w, generator state before the image, block index, ...)."""
    camera = make_camera(scene)
    params = {k: v.to(device) for k, v in state["params"].items()}
    positions, orientations = state["positions"].to(device), state["orientations"].to(device)
    allocated = torch.arange(positions.shape[0], device=device) < state["fields"]
    out = []
    with matmul_precision(tf32), torch.no_grad():
        ref = ref_engine.NeuralGraphMap(map_config, device)
        block = ref.render_block_size()
        ks = ref._fset.num_knn * ref._eval_span_samples
        use_ray_kernel = (ks & (ks - 1)) == 0
        ii, jj = torch.meshgrid(torch.arange(camera.height, device=device),
                                torch.arange(camera.width, device=device), indexing="ij")
        ijs_all = torch.stack([ii, jj], -1).reshape(-1, 2).to(torch.float32)
        for c2w, state_before, b, *_ in samples:
            gen = torch.Generator(device)
            gen.set_state(state_before)
            for _ in range(b + 1):  # the image's blocks draw their jitter in turn
                u = torch.rand((block, ref._eval_span_samples), generator=gen, device=device)
            rgbd, _, _ = ref_engine.render_block_tiled(
                ref._fset, camera, ref._rcfg, ref._eval_span_samples, ref._eval_near, ref._eval_far,
                params, positions, orientations, allocated, ijs_all[b * block:(b + 1) * block],
                torch.as_tensor(c2w, device=device), u=u, use_ray_kernel=use_ray_kernel, block_offset=b * block,
                sample_spacing=float(ref._sample_spacing),
            )
            out.append(rgbd.cpu())
    return out


def image_gaps(blocks: list, against: list) -> Dict[str, float]:
    """Per ray, the widest |RGB-D| gap between two renders of the same
    blocks (a NaN reads as infinite); of all rays, its quantiles and mean.
    Two maps trained alike from the same frames and draws part at a few
    rays by a whole surface, so the widest gap does not tell a sound map
    from a wrong one; the bulk of the rays does."""
    gaps = torch.cat([(torch.as_tensor(a) - torch.as_tensor(b)).abs().amax(-1) for a, b in zip(blocks, against)])
    gaps = torch.nan_to_num(gaps.double(), nan=float("inf"))
    out = {f"image_gap_p{q}": float(torch.quantile(gaps, q / 100.0)) for q in (50, 90, 99)}
    out.update(image_gap_mean=float(gaps.mean()), image_gap_max=float(gaps.max()))
    return out


def widest_gap(blocks: list, against: list) -> float:
    """max |a - b| over paired blocks (a NaN reads as infinite)."""
    worst = 0.0
    for a, b in zip(blocks, against):
        gap = float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is at or under its limit (a missing number
    fails)."""
    return all(numbers.get(k, float("inf")) <= lim for k, lim in limits.items())
